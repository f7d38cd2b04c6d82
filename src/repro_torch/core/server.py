"""MLModelScope server (paper §4.3).

The server accepts client requests, resolves capable agents via the
registry, dispatches evaluations (to one agent, or at user request to all
matching agents in parallel), and runs the analysis workflow over the
evaluation database.

Scalability/fault-tolerance beyond the paper:

* failed agents (lease expiry or raised errors) trigger re-dispatch to the
  next least-loaded capable agent (node-failure handling);
* ``straggler_factor`` optionally duplicates a dispatch onto a second agent
  and takes the first result (straggler mitigation);
* dispatches run on a thread pool so N-system comparisons proceed in
  parallel (the paper's "choose the best hardware out of N in parallel").

The port's copy of ``repro.core.server``.  Every module of ``repro_torch``
keeps its own copy of what it needs so that it never imports ``repro``.
"""
from __future__ import annotations

import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..serve.scheduler import SchedulerConfig, backoff_delay
from .agent import Agent, EvaluationRequest
from .analysis import (
    comparison_table,
    latency_summary,
    layer_breakdown,
    level_breakdown,
    markdown_report,
    scheduler_summary,
    top_layers,
    throughput_scalability,
)
from .evaldb import EvalDB
from .manifest import SystemRequirements
from .registry import AgentRecord, Registry
from .tracing import Span, TracingServer


class DispatchError(RuntimeError):
    pass


@dataclass
class DispatchPolicy:
    """Server-side scheduling knobs (F4)."""

    max_attempts: int = 3              # re-dispatch on agent failure
    straggler_factor: float = 0.0      # >0: duplicate dispatch, first wins
    all_agents: bool = False           # fan out to every capable agent
    timeout_s: Optional[float] = None  # per-attempt wait (every attempt)
    backoff_base_s: float = 0.0        # retry backoff base (0 = immediate,
    #                                    the legacy behavior)
    backoff_cap_s: float = 1.0         # retry backoff cap
    backoff_jitter: float = 0.5        # ±fraction jitter on each delay
    backoff_seed: int = 0              # jitter rng seed (determinism)


class Server:
    """In-process MLModelScope server. Subprocess agents attach through the
    same interface via proxy Agent objects (launch/agent_main.py)."""

    def __init__(
        self,
        registry: Registry,
        tracing_server: TracingServer,
        evaldb: EvalDB,
        max_workers: int = 8,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.registry = registry
        self.tracing_server = tracing_server
        self.evaldb = evaldb
        self._agents: Dict[str, Agent] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._lock = threading.Lock()
        self._sleep = sleep            # injectable for fake-clock tests

    # -- agent attachment -----------------------------------------------------
    def attach_agent(self, agent: Agent) -> None:
        with self._lock:
            self._agents[agent.agent_id] = agent

    def detach_agent(self, agent_id: str) -> None:
        with self._lock:
            self._agents.pop(agent_id, None)

    def _lookup(self, record: AgentRecord) -> Optional[Agent]:
        with self._lock:
            return self._agents.get(record.agent_id)

    # -- evaluation workflow (steps 2-4, 8-9) -----------------------------------
    def evaluate(
        self,
        req: EvaluationRequest,
        requirements: Optional[SystemRequirements] = None,
        policy: Optional[DispatchPolicy] = None,
        scheduler: Optional[SchedulerConfig] = None,
    ) -> List[Dict[str, Any]]:
        """Dispatch an evaluation; returns one result per served agent.

        ``scheduler`` threads a request-scheduler configuration through
        dispatch so the agent runs the scenario on the scheduler-backed
        executor (micro-batching + bounded queue); a config already present
        on the request wins."""
        policy = policy or DispatchPolicy()
        if scheduler is not None and req.scheduler is None:
            req.scheduler = scheduler
        model_key = self._model_key(req)
        records = self.registry.resolve(
            model_key,
            backend_name=req.backend,
            requirements=requirements,
        )
        if not records:
            raise DispatchError(
                f"no agent can serve model={model_key} backend={req.backend!r}"
            )
        if policy.all_agents:
            futures = {
                self._pool.submit(self._dispatch_one, rec, req, policy): rec
                for rec in records
            }
            results = []
            for fut in futures:
                results.append(fut.result(timeout=policy.timeout_s))
            return results
        return [self._dispatch_with_retry(records, req, policy)]

    def _model_key(self, req: EvaluationRequest) -> str:
        if req.model_version:
            return f"{req.model}:{req.model_version}"
        found = self.registry.find_manifest(req.model)
        if found is None:
            raise DispatchError(f"model {req.model!r} not in registry")
        return found.key

    def _dispatch_with_retry(
        self,
        records: List[AgentRecord],
        req: EvaluationRequest,
        policy: DispatchPolicy,
    ) -> Dict[str, Any]:
        """Least-loaded-first dispatch with failover + straggler duplication.

        ``timeout_s`` bounds EVERY attempt's wait (not just the first); a
        timed-out attempt cancels its still-pending futures and counts as a
        failure.  Between attempts the server backs off with capped
        exponential delay + seeded jitter (``backoff_base_s = 0`` keeps the
        legacy retry-immediately behavior)."""
        errors: List[str] = []
        rng = random.Random(policy.backoff_seed)
        attempt = 0
        idx = 0
        while attempt < policy.max_attempts and idx < len(records):
            if attempt > 0 and policy.backoff_base_s > 0:
                self._sleep(backoff_delay(
                    attempt, policy.backoff_base_s, policy.backoff_cap_s,
                    policy.backoff_jitter, rng,
                ))
            primary = records[idx]
            candidates = [primary]
            if policy.straggler_factor > 0 and idx + 1 < len(records):
                candidates.append(records[idx + 1])  # duplicate dispatch
            futures: List[Future] = [
                self._pool.submit(self._dispatch_one, rec, req, policy)
                for rec in candidates
            ]
            done, pending = wait(
                futures, timeout=policy.timeout_s, return_when=FIRST_COMPLETED
            )
            winner: Optional[Dict[str, Any]] = None
            for fut in done:
                try:
                    winner = fut.result()
                    break
                except Exception as e:  # noqa: BLE001 - collected for report
                    errors.append(str(e))
            if winner is not None:
                for fut in pending:
                    fut.cancel()
                return winner
            if not done:
                # attempt timed out: give up on these candidates (cancel
                # what hasn't started; a running dispatch is abandoned) and
                # fail over to the next records
                for fut in pending:
                    fut.cancel()
                errors.append(
                    f"attempt {attempt + 1} timed out after "
                    f"{policy.timeout_s}s on "
                    f"{[r.agent_id for r in candidates]}"
                )
            # all completed candidates failed -> advance past them
            idx += len(candidates)
            attempt += 1
        raise DispatchError(
            f"evaluation failed after {attempt} attempt(s): {errors or 'no agents left'}"
        )

    def _dispatch_one(
        self, record: AgentRecord, req: EvaluationRequest, policy: DispatchPolicy
    ) -> Dict[str, Any]:
        agent = self._lookup(record)
        if agent is None:
            raise DispatchError(f"agent {record.agent_id} not attached")
        if not self.registry.heartbeat(record.agent_id, ttl=agent.lease_ttl):
            # lease expired: the "node" is considered failed
            raise DispatchError(f"agent {record.agent_id} lease expired")
        self.registry.update_load(record.agent_id, +1)
        try:
            return agent.evaluate(req)
        finally:
            self.registry.update_load(record.agent_id, -1)

    # -- analysis workflow (steps a-e) -------------------------------------------
    def analyze(
        self,
        model: str = "",
        backend: str = "",
        system: str = "",
        scenario: str = "",
    ) -> Dict[str, Any]:
        """Aggregate evaluation results matching the constraints (§4.3)."""
        recs = self.evaldb.query(
            model=model, backend=backend, system=system, scenario=scenario
        )
        rows = []
        for r in recs:
            row: Dict[str, Any] = {
                "model": r.model,
                "version": r.model_version,
                "backend": r.backend,
                "system": r.system,
                "scenario": r.scenario,
                "batch": r.batch_size,
            }
            row.update(
                {
                    k: v
                    for k, v in r.metrics.items()
                    if isinstance(v, (int, float))
                }
            )
            rows.append(row)
        return {"count": len(recs), "rows": rows, "records": recs}

    def report(self, model: str = "", **constraints) -> str:
        """Generate the markdown summary report (workflow step e)."""
        res = self.analyze(model=model, **constraints)
        sections = []
        if res["rows"]:
            cols = sorted({k for row in res["rows"] for k in row})
            # keep identity columns first
            ident = [c for c in ("model", "version", "backend", "system", "scenario", "batch") if c in cols]
            rest = [c for c in cols if c not in ident]
            sections.append(
                ("Evaluations", comparison_table(res["rows"], ident + rest))
            )
        # trace-derived sections for the most recent evaluation
        if res["records"]:
            last = res["records"][-1]
            spans = [Span.from_dict(d) for d in self.evaldb.spans(last.eval_id)]
            if spans:
                tl = top_layers(spans, k=5)
                body = comparison_table(
                    [
                        {
                            "layer": s.name,
                            "count": s.count,
                            "total_ms": s.total_s * 1e3,
                            "mean_ms": s.mean_s * 1e3,
                        }
                        for s in tl
                    ],
                    ["layer", "count", "total_ms", "mean_ms"],
                )
                sections.append(("Top layers (most recent evaluation)", body))
                lv = level_breakdown(spans)
                sections.append(
                    (
                        "Per-level time",
                        "\n".join(f"- {k}: {v*1e3:.3f} ms" for k, v in sorted(lv.items())),
                    )
                )
                sched = scheduler_summary(spans)
                if sched:
                    sections.append(
                        (
                            "Scheduler (queueing + micro-batching)",
                            "\n".join(f"- {k}: {v:.3f}" for k, v in sorted(sched.items())),
                        )
                    )
        return markdown_report(f"MLModelScope report: {model or 'all models'}", sections)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
