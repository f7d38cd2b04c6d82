"""MLModelScope agent (paper §4.4).

An agent is a model-serving process on a system of interest. It:

* self-registers its HW/SW stack + built-in models in the registry (init
  workflow, step 0),
* on an evaluation request: downloads/validates assets via the *data
  manager*, runs the evaluation pipeline (pre-process -> predict ->
  post-process) under the requested benchmarking scenario,
* publishes trace events to the tracing server and results to the
  evaluation database.

Everything except the framework predictor is shared across backends.

The port's copy of ``repro.core.agent``.  An agent runs on one device
(``cuda`` unless the caller asks for the CPU), which it hands to its
predictor in the :class:`OpenRequest` and describes in its system record
(:func:`default_system_info` reads ``torch.cuda`` where the reference asks
JAX).  ``_synthetic_inputs`` is the reference's, salted ``hash`` included,
so two agents in one process draw the same tokens.  The port keeps its own
copy so that it never imports ``repro``.
"""
from __future__ import annotations

import hashlib
import os
import socket
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..serve.scheduler import SchedulerConfig
from .evaldb import EvalDB, EvaluationRecord
from .manifest import ModelManifest
from .pipeline import Pipeline, build_steps
from .predictor import OpenRequest, make_predictor
from .registry import AgentRecord, Registry
from .scenarios import ScenarioSpec, run_scenario
from .tracing import (
    host_counters,
    NullTracer,
    Tracer,
    TraceLevel,
    TracingServer,
)


@dataclass
class EvaluationRequest:
    """The dispatched unit of work (server -> agent, step 4)."""

    model: str
    model_version: str = ""
    backend: str = "torch"
    scenario: ScenarioSpec = field(default_factory=ScenarioSpec)
    trace_level: str = "MODEL"
    batch_size: int = 1
    seq_len: int = 128
    mode: str = "serve"
    options: Dict[str, Any] = field(default_factory=dict)
    # when set, the evaluation runs through the scheduler-backed executor
    # with these micro-batching / admission knobs (F7 under concurrent load)
    scheduler: Optional[SchedulerConfig] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model,
            "model_version": self.model_version,
            "backend": self.backend,
            "scenario": self.scenario.to_dict(),
            "trace_level": self.trace_level,
            "batch_size": self.batch_size,
            "seq_len": self.seq_len,
            "mode": self.mode,
            "options": self.options,
            "scheduler": self.scheduler.to_dict() if self.scheduler else None,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EvaluationRequest":
        d = dict(d)
        d["scenario"] = ScenarioSpec.from_dict(d.get("scenario", {}))
        if d.get("scheduler"):
            d["scheduler"] = SchedulerConfig.from_dict(d["scheduler"])
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


class DataManager:
    """§4.4.1 — asset management with checksum validation and caching.

    Model assets here are checkpoint directories / data files on local disk
    (the offline stand-in for the artifact store); checksums still guard
    integrity exactly as in the paper.
    """

    def __init__(self, cache_dir: Optional[str] = None) -> None:
        self.cache_dir = cache_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "mlms-cache"
        )
        os.makedirs(self.cache_dir, exist_ok=True)

    def fetch(self, path: str, checksum: str = "") -> str:
        """Resolve an asset path; validate checksum when provided."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"model asset not found: {path}")
        if checksum:
            actual = self.checksum(path)
            if not actual.startswith(checksum) and actual != checksum:
                raise ValueError(
                    f"checksum mismatch for {path}: {actual} != {checksum}"
                )
        return path

    @staticmethod
    def checksum(path: str) -> str:
        h = hashlib.sha256()
        if os.path.isdir(path):
            for root, _, files in sorted(os.walk(path)):
                for fn in sorted(files):
                    with open(os.path.join(root, fn), "rb") as f:
                        for chunk in iter(lambda: f.read(1 << 20), b""):
                            h.update(chunk)
        else:
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
        return h.hexdigest()


class Agent:
    """An in-process MLModelScope agent."""

    def __init__(
        self,
        backend: str,
        registry: Registry,
        tracing_server: TracingServer,
        evaldb: EvalDB,
        system: Optional[Dict[str, Any]] = None,
        agent_id: Optional[str] = None,
        data_manager: Optional[DataManager] = None,
        lease_ttl: Optional[float] = None,
        device: Optional[str] = None,
    ) -> None:
        self.agent_id = agent_id or f"{backend}-{uuid.uuid4().hex[:8]}"
        self.backend = backend
        self.registry = registry
        self.tracing_server = tracing_server
        self.evaldb = evaldb
        self.data_manager = data_manager or DataManager()
        self.device = str(resolve_device(device))
        self.system = system or default_system_info(self.device)
        # in-process agents share the host process' liveness; subprocess
        # agents heartbeat on the paper's short TTL
        self.lease_ttl = lease_ttl
        self.manifests: Dict[str, ModelManifest] = {}
        self._predictor = make_predictor(backend)
        # fault-injection hook for platform tests (simulated node failure)
        self.fail_next: int = 0

    # -- initialization workflow (step 0) -----------------------------------
    def register_models(self, manifests: Iterable[ModelManifest]) -> None:
        for m in manifests:
            self.manifests[m.key] = m
            self.registry.register_manifest(m)
        self.announce()

    def announce(self) -> None:
        """Self-register in the distributed registry with a TTL lease."""
        self.registry.register_agent(
            AgentRecord(
                agent_id=self.agent_id,
                backend=self.backend,
                backend_version=self._predictor.version,
                system=self.system,
                models=sorted(self.manifests),
                address=f"inproc://{self.agent_id}",
            ),
            ttl=self.lease_ttl,
        )

    def heartbeat(self) -> bool:
        return self.registry.heartbeat(self.agent_id)

    # -- evaluation workflow (steps 5-7) -------------------------------------
    def evaluate(self, req: EvaluationRequest) -> Dict[str, Any]:
        manifest = self._resolve_manifest(req)
        trace_id = f"eval-{uuid.uuid4().hex[:12]}"
        tracer = Tracer(
            trace_id, self.tracing_server, TraceLevel.parse(req.trace_level)
        )
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError(f"injected agent failure on {self.agent_id}")

        with tracer.span("evaluation", TraceLevel.MODEL, agent=self.agent_id):
            # 5. fetch + validate assets
            assets = manifest.model_assets
            if assets.get("base_path"):
                with tracer.span("data_manager:fetch", TraceLevel.MODEL):
                    self.data_manager.fetch(
                        assets["base_path"], assets.get("checksum", "")
                    )
            # open the predictor (model load; cold-start cost is traced)
            open_req = OpenRequest(
                manifest=manifest,
                backend=self.backend,
                batch_size=req.batch_size,
                seq_len=req.seq_len,
                mode=req.mode,
                options=req.options,
                device=self.device,
            )
            handle = self._predictor.open(open_req, tracer)
            try:
                pre_ops = build_steps(
                    manifest.inputs[0].steps if manifest.inputs else []
                )
                post_ops = build_steps(
                    manifest.outputs[0].steps if manifest.outputs else []
                )

                def predict_once(batch_size: int) -> Any:
                    batch = self._make_batch(manifest, req, batch_size, pre_ops, tracer)
                    out = self._predictor.predict(handle, batch, tracer)
                    return self._post(out, post_ops, tracer)

                if tracer.enabled(TraceLevel.SYSTEM):
                    before = host_counters()
                metrics = run_scenario(
                    req.scenario, predict_once, tracer, scheduler=req.scheduler
                )
                if tracer.enabled(TraceLevel.SYSTEM):
                    after = host_counters()
                    tracer.event(
                        "system:host_counters",
                        0.0,
                        0.0,
                        TraceLevel.SYSTEM,
                        **{
                            k: after.get(k, 0.0) - before.get(k, 0.0)
                            for k in ("utime_s", "stime_s")
                        },
                        rss_bytes=after.get("rss_bytes", 0.0),
                    )
            finally:
                self._predictor.close(handle)

        # 6-7. publish results + trace
        spans = [s.to_dict() for s in self.tracing_server.timeline(trace_id)]
        record = EvaluationRecord(
            model=manifest.name,
            model_version=manifest.version,
            backend=self.backend,
            backend_version=self._predictor.version,
            system=self.system.get("name", "local"),
            scenario=req.scenario.kind,
            batch_size=req.batch_size,
            trace_level=req.trace_level,
            agent_id=self.agent_id,
            metrics=metrics,
            user_input=req.to_dict(),
        )
        eval_id = self.evaldb.insert(record, spans)
        return {
            "eval_id": eval_id,
            "trace_id": trace_id,
            "agent_id": self.agent_id,
            "model": manifest.key,
            "metrics": metrics,
        }

    # -- helpers -------------------------------------------------------------
    def _resolve_manifest(self, req: EvaluationRequest) -> ModelManifest:
        if req.model_version:
            key = f"{req.model}:{req.model_version}"
            m = self.manifests.get(key)
            if m is None:
                raise KeyError(f"agent {self.agent_id} has no model {key}")
            return m
        found = self.registry.find_manifest(req.model)
        if found is not None and found.key in self.manifests:
            return self.manifests[found.key]
        # fall back to highest local version
        candidates = [m for m in self.manifests.values() if m.name == req.model]
        if not candidates:
            raise KeyError(f"agent {self.agent_id} has no model {req.model!r}")
        return max(candidates, key=lambda m: m.version)

    def _make_batch(
        self,
        manifest: ModelManifest,
        req: EvaluationRequest,
        batch_size: int,
        pre_ops: List[tuple],
        tracer: Tracer,
    ) -> np.ndarray:
        """Produce a model batch by streaming raw inputs through the
        pre-processing pipeline (F6: operators overlap on threads)."""
        raw = self._synthetic_inputs(manifest, req, batch_size)
        if pre_ops:
            pipe = Pipeline(pre_ops, tracer=tracer)
            processed = pipe.run(raw)
        else:
            processed = raw
        return np.stack([np.asarray(x) for x in processed])

    def _synthetic_inputs(
        self, manifest: ModelManifest, req: EvaluationRequest, batch_size: int
    ) -> List[Any]:
        """Deterministic synthetic raw inputs per modality."""
        rng = np.random.default_rng(abs(hash((manifest.key, batch_size))) % (2**32))
        modality = manifest.inputs[0].type if manifest.inputs else "tokens"
        if modality == "image":
            return [
                rng.integers(0, 255, size=(288, 288, 3)).astype(np.uint8)
                for _ in range(batch_size)
            ]
        # token inputs: ints in [0, vocab)
        vocab = int(manifest.attributes.get("vocab_size", 256))
        return [
            rng.integers(0, vocab, size=(req.seq_len,)).astype(np.int32)
            for _ in range(batch_size)
        ]

    def _post(self, out: Any, post_ops: List[tuple], tracer: Tracer) -> Any:
        if not post_ops:
            return out
        arr = np.asarray(out)
        batch = list(arr) if arr.ndim > 1 else [arr]
        pipe = Pipeline(post_ops, tracer=tracer)
        return pipe.run(batch)

    # -- teardown -------------------------------------------------------------
    def shutdown(self) -> None:
        self.registry.deregister_agent(self.agent_id)


def default_system_info(device: str = "cuda") -> Dict[str, Any]:
    """The agent's system record: the card's name, platform ``gpu`` or
    ``cpu``, device count and total memory, from ``torch.cuda``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        platform, kind = "gpu", props.name
        num_devices, memory = torch.cuda.device_count(), int(props.total_memory)
    else:
        platform, kind, num_devices, memory = "cpu", "cpu", 1, 0
    return {
        "name": socket.gethostname(),
        "platform": platform,
        "device": kind,
        "num_devices": num_devices,
        "memory_bytes": memory,
        "mesh": "host",
        "host": socket.gethostname(),
    }
