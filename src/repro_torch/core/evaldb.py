"""Evaluation database (paper §4.5.2).

After each evaluation the agent stores the benchmarking result and the
profiling trace keyed by the full user input, so historical evaluations can
be queried by input constraints and compared across model versions. Backed
by sqlite (stdlib) — file-based or in-memory.

The port's copy of ``repro.core.evaldb``: the same sqlite schema and record
fields, so either package's :class:`EvalDB` reads a file the other wrote.
Every module of ``repro_torch`` keeps its own copy of what it needs so that
it never imports ``repro``.
"""
from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS evaluations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    created_at REAL NOT NULL,
    model TEXT NOT NULL,
    model_version TEXT NOT NULL,
    backend TEXT NOT NULL,
    backend_version TEXT NOT NULL,
    system TEXT NOT NULL,
    scenario TEXT NOT NULL,
    batch_size INTEGER NOT NULL,
    trace_level TEXT NOT NULL,
    agent_id TEXT NOT NULL,
    metrics_json TEXT NOT NULL,
    user_input_json TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_eval_model ON evaluations(model, model_version);
CREATE TABLE IF NOT EXISTS traces (
    eval_id INTEGER NOT NULL REFERENCES evaluations(id),
    spans_json TEXT NOT NULL
);
"""


@dataclass
class EvaluationRecord:
    model: str
    model_version: str
    backend: str
    backend_version: str
    system: str
    scenario: str
    batch_size: int
    trace_level: str
    agent_id: str
    metrics: Dict[str, Any]
    user_input: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0
    eval_id: Optional[int] = None


class EvalDB:
    """Thread-safe sqlite-backed evaluation store."""

    def __init__(self, path: str = ":memory:") -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def insert(self, rec: EvaluationRecord, spans: Optional[List[Dict[str, Any]]] = None) -> int:
        created = rec.created_at or time.time()
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO evaluations (created_at, model, model_version, backend,"
                " backend_version, system, scenario, batch_size, trace_level, agent_id,"
                " metrics_json, user_input_json) VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    created,
                    rec.model,
                    rec.model_version,
                    rec.backend,
                    rec.backend_version,
                    rec.system,
                    rec.scenario,
                    rec.batch_size,
                    rec.trace_level,
                    rec.agent_id,
                    json.dumps(rec.metrics),
                    json.dumps(rec.user_input),
                ),
            )
            eval_id = int(cur.lastrowid)
            if spans:
                self._conn.execute(
                    "INSERT INTO traces (eval_id, spans_json) VALUES (?,?)",
                    (eval_id, json.dumps(spans)),
                )
            self._conn.commit()
        rec.eval_id = eval_id
        return eval_id

    def query(
        self,
        model: str = "",
        model_version: str = "",
        backend: str = "",
        system: str = "",
        scenario: str = "",
    ) -> List[EvaluationRecord]:
        """Query historical evaluations by input constraints (§4.5.2)."""
        clauses, params = ["1=1"], []
        for col, val in (
            ("model", model),
            ("model_version", model_version),
            ("backend", backend),
            ("system", system),
            ("scenario", scenario),
        ):
            if val:
                clauses.append(f"{col} = ?")
                params.append(val)
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, created_at, model, model_version, backend, backend_version,"
                " system, scenario, batch_size, trace_level, agent_id, metrics_json,"
                " user_input_json FROM evaluations WHERE "
                + " AND ".join(clauses)
                + " ORDER BY id",
                params,
            ).fetchall()
        out = []
        for r in rows:
            out.append(
                EvaluationRecord(
                    eval_id=r[0],
                    created_at=r[1],
                    model=r[2],
                    model_version=r[3],
                    backend=r[4],
                    backend_version=r[5],
                    system=r[6],
                    scenario=r[7],
                    batch_size=r[8],
                    trace_level=r[9],
                    agent_id=r[10],
                    metrics=json.loads(r[11]),
                    user_input=json.loads(r[12]),
                )
            )
        return out

    def spans(self, eval_id: int) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT spans_json FROM traces WHERE eval_id = ?", (eval_id,)
            ).fetchall()
        spans: List[Dict[str, Any]] = []
        for (blob,) in rows:
            spans.extend(json.loads(blob))
        return spans

    def best_version(self, model: str, metric: str, maximize: bool = True) -> Optional[str]:
        """Which model version produced the best result (§4.5.2)."""
        best_v, best_m = None, None
        for rec in self.query(model=model):
            val = rec.metrics.get(metric)
            if val is None:
                continue
            if best_m is None or (val > best_m if maximize else val < best_m):
                best_v, best_m = rec.model_version, val
        return best_v

    def close(self) -> None:
        with self._lock:
            self._conn.close()
