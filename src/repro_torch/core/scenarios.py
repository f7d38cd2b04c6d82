"""Benchmarking scenarios (paper F7, §4.1.3 / §5.1).

A scenario couples a workload generator with the measurement protocol.  Each
scenario is a :class:`Scenario` class that *submits* requests to the shared
:class:`~repro.serve.scheduler.RequestScheduler` (asynchronous completion
futures) instead of calling the predict function inline, so queueing,
micro-batching and admission effects are measured identically everywhere.

Six kinds (the first three predate the scheduler and keep their exact
metrics via the compatibility shim in :func:`run_scenario`; the last three
are the MLPerf-loadgen-style additions):

* ``online``        — batch-1 Poisson arrivals, closed loop; trimmed-mean +
                      90th-percentile latency.
* ``batched``       — fixed-batch back-to-back; throughput sweep over batch
                      sizes yields max throughput + optimal batch (Table 2).
* ``trace``         — replay of a recorded arrival process.
* ``single_stream`` — back-to-back batch-1, latency-bound; p99 latency and
                      streams/sec.
* ``server``        — Poisson arrivals, *open loop* through the scheduler's
                      micro-batching; p99 latency SLO accounting and
                      achieved-QPS.
* ``offline``       — submit-everything-at-once, max-throughput; the
                      scheduler coalesces up to ``max_batch`` per call.

Scenarios drive a *predict function* ``fn(batch_size) -> None`` supplied by
the agent; they own timing and metric computation so every model/backend is
measured identically (F2 consistent evaluation).  ``clock``/``sleep`` are
injectable, making every scenario a deterministic discrete-event simulation
under a fake clock (the paper allows simulated time in traces).

The port's copy of ``repro.core.scenarios``.  Every module of
``repro_torch`` keeps its own copy of what it needs so that it never imports
``repro``.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Type, Union

from ..serve.scheduler import (
    PRIORITY_TIERS,
    RequestScheduler,
    ScheduledRequest,
    SchedulerConfig,
    TenantSpec,
)
from .analysis import jain_index, latency_summary, percentile, slo_attainment
from .tracing import Tracer, TraceLevel
from .workload import (
    BatchedLoad,
    MultiTenantLoad,
    PoissonLoad,
    Request,
    SharedPrefixLoad,
    TraceReplayLoad,
)


@dataclass
class ScenarioSpec:
    """User-selected benchmarking scenario (part of the user input)."""

    kind: str = "online"            # online | batched | trace | single_stream | server | offline
    num_requests: int = 32
    batch_size: int = 1
    rate_hz: float = 50.0           # online/server arrival rate
    warmup: int = 3
    batch_sizes: Optional[List[int]] = None   # batched sweep
    arrivals: Optional[List[float]] = None    # trace replay
    seed: int = 0
    slo_ms: float = 100.0           # server scenario p99 latency SLO
    # shared-prefix request mix (server/trace kinds): prefix_len > 0 swaps
    # the arrival process for a SharedPrefixLoad whose requests carry the
    # prompt-composition tags the paged engine's prefix cache feeds on
    prefix_len: int = 0             # shared-prefix tokens (0 = plain load)
    prefix_share: float = 0.75      # fraction of requests reusing a prefix
    prefix_groups: int = 1          # distinct shared prefixes
    suffix_len: int = 16            # unique tail tokens per request
    # multi-tenant SLO serving (server kind): tenant dicts become a
    # MultiTenantLoad arrival mix plus per-tenant TenantSpec entries
    # (priority tier, weight, token-bucket rate/burst) in the scheduler;
    # priority_mix assigns tiers to a single-tenant load by fraction
    # (e.g. {"best_effort": 0.25, "standard": 0.5, "premium": 0.25});
    # fairness=False degrades dequeue to pure FIFO (the baseline)
    tenants: Optional[List[Dict[str, Any]]] = None
    priority_mix: Optional[Dict[str, float]] = None
    fairness: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "num_requests": self.num_requests,
            "batch_size": self.batch_size,
            "rate_hz": self.rate_hz,
            "warmup": self.warmup,
            "batch_sizes": self.batch_sizes,
            "arrivals": self.arrivals,
            "seed": self.seed,
            "slo_ms": self.slo_ms,
            "prefix_len": self.prefix_len,
            "prefix_share": self.prefix_share,
            "prefix_groups": self.prefix_groups,
            "suffix_len": self.suffix_len,
            "tenants": self.tenants,
            "priority_mix": self.priority_mix,
            "fairness": self.fairness,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


PredictFn = Callable[[int], Any]


class _SchedulerTrace:
    """Adapter publishing scheduler batch events at MODEL level so the
    default trace level records the queue-depth / occupancy series."""

    def __init__(self, tracer: Tracer) -> None:
        self._tracer = tracer

    def event(self, name: str, begin: float, end: float, **tags: Any) -> None:
        self._tracer.event(name, begin, end, TraceLevel.MODEL, **tags)


class Scenario:
    """Base scenario: workload generation + submission + metric computation.

    Subclasses override :meth:`run`.  All requests flow through a
    :class:`RequestScheduler` built over the predict function — closed-loop
    kinds use a degenerate batch-1 scheduler, open-loop kinds exercise
    micro-batch coalescing and the bounded queue.
    """

    kind = "base"
    #: scheduler used when the caller does not thread a SchedulerConfig
    default_scheduler = SchedulerConfig(max_batch=1, batch_timeout_ms=0.0)

    def __init__(self, spec: ScenarioSpec) -> None:
        self.spec = spec

    # -- plumbing ------------------------------------------------------------
    def make_scheduler(
        self,
        predict: PredictFn,
        tracer: Tracer,
        clock: Callable[[], float],
        sleep: Callable[[float], None],
        config: Optional[SchedulerConfig],
    ) -> RequestScheduler:
        cfg = config or self.default_scheduler
        if not self.spec.fairness and cfg.fairness:
            cfg = replace(cfg, fairness=False)
        tenant_specs = [
            TenantSpec.from_dict(t) for t in (self.spec.tenants or [])
        ]

        def execute(batch: List[ScheduledRequest]) -> None:
            total = sum(r.batch_size for r in batch)
            with tracer.span(
                "predict",
                TraceLevel.MODEL,
                batch=total,
                coalesced=len(batch),
                request_id=batch[0].request_id,
            ):
                predict(total)

        return RequestScheduler(
            execute, cfg, clock=clock, sleep=sleep,
            tracer=_SchedulerTrace(tracer), tenants=tenant_specs,
        )

    def warmup(self, predict: PredictFn, tracer: Tracer, batch: int) -> None:
        for _ in range(self.spec.warmup):
            with tracer.span("warmup", TraceLevel.MODEL, batch=batch):
                predict(batch)

    def closed_loop(
        self,
        requests: Sequence[Request],
        sched: RequestScheduler,
        clock: Callable[[], float],
        sleep: Callable[[float], None],
        t0: float,
        honor_arrivals: bool,
    ) -> List[Dict[str, float]]:
        """Submit each request and wait for its future (sequential issue),
        recording per-request service + queueing latency — the legacy
        ``_measure`` protocol, now on the scheduler code path."""
        rows = []
        for req in requests:
            if honor_arrivals:
                now = clock() - t0
                if req.arrival_s > now:
                    sleep(req.arrival_s - now)
            fut = sched.submit(
                batch_size=req.batch_size, arrival_s=t0 + req.arrival_s
            )
            fut.result()
            r = fut.request
            rows.append(
                {
                    "request_id": req.request_id,
                    "batch_size": req.batch_size,
                    "arrival_s": req.arrival_s,
                    "start_s": r.start_s - t0,
                    "latency_s": r.service_s,
                    # queueing delay: intended arrival -> service start
                    "queue_s": max(0.0, (r.start_s - t0) - req.arrival_s),
                }
            )
        return rows

    def scheduler_metrics(self, sched: RequestScheduler) -> Dict[str, float]:
        return {f"sched_{k}": v for k, v in sched.stats().items()}

    # -- interface -----------------------------------------------------------
    def run(
        self,
        predict: PredictFn,
        tracer: Tracer,
        clock: Callable[[], float],
        sleep: Callable[[float], None],
        scheduler: Optional[SchedulerConfig] = None,
    ) -> Dict[str, Any]:
        raise NotImplementedError


class OnlineScenario(Scenario):
    """Closed-loop batch-1 Poisson arrivals (the paper's online scenario)."""

    kind = "online"

    def run(self, predict, tracer, clock, sleep, scheduler=None):
        spec = self.spec
        self.warmup(predict, tracer, 1)
        sched = self.make_scheduler(predict, tracer, clock, sleep, scheduler)
        load = PoissonLoad(spec.num_requests, spec.rate_hz, seed=spec.seed)
        with tracer.span("scenario:online", TraceLevel.MODEL, rate_hz=spec.rate_hz):
            t0 = clock()
            rows = self.closed_loop(list(load.requests()), sched, clock, sleep, t0, True)
        lat = [r["latency_s"] for r in rows]
        metrics = latency_summary(lat)
        metrics.update(
            {
                "scenario": "online",
                "num_requests": len(rows),
                "mean_queue_s": sum(r["queue_s"] for r in rows) / max(len(rows), 1),
            }
        )
        return metrics


class BatchedScenario(Scenario):
    """Throughput at each batch size; max throughput + optimal batch size."""

    kind = "batched"

    def run(self, predict, tracer, clock, sleep, scheduler=None):
        spec = self.spec
        batch_sizes = spec.batch_sizes or [spec.batch_size]
        per_batch: Dict[int, Dict[str, float]] = {}
        for bs in batch_sizes:
            self.warmup(predict, tracer, bs)
            sched = self.make_scheduler(predict, tracer, clock, sleep, scheduler)
            load = BatchedLoad(spec.num_requests, bs)
            with tracer.span("scenario:batched", TraceLevel.MODEL, batch=bs):
                t0 = clock()
                rows = self.closed_loop(
                    list(load.requests()), sched, clock, sleep, t0, False
                )
                elapsed = clock() - t0
            inputs = sum(r["batch_size"] for r in rows)
            lat = [r["latency_s"] for r in rows]
            per_batch[bs] = {
                "throughput_ips": inputs / elapsed if elapsed > 0 else float("inf"),
                **latency_summary(lat),
            }
        best_bs = max(per_batch, key=lambda b: per_batch[b]["throughput_ips"])
        return {
            "scenario": "batched",
            "per_batch": {str(k): v for k, v in per_batch.items()},
            "max_throughput_ips": per_batch[best_bs]["throughput_ips"],
            "optimal_batch_size": best_bs,
        }


class TraceScenario(Scenario):
    """Replay of a recorded arrival process (closed loop)."""

    kind = "trace"

    def run(self, predict, tracer, clock, sleep, scheduler=None):
        spec = self.spec
        if not spec.arrivals:
            raise ValueError("trace scenario requires arrivals")
        self.warmup(predict, tracer, spec.batch_size)
        sched = self.make_scheduler(predict, tracer, clock, sleep, scheduler)
        tags = None
        if spec.prefix_len > 0:
            # replayed traces with shared prompt prefixes: stamp each
            # replayed request with the composition tags a SharedPrefixLoad
            # of the same seed would emit, so the trace exercises the
            # prefix cache exactly like the server mix does
            tags = [
                r.tags
                for r in SharedPrefixLoad(
                    len(spec.arrivals),
                    prefix_len=spec.prefix_len,
                    suffix_len=spec.suffix_len,
                    share_ratio=spec.prefix_share,
                    num_groups=spec.prefix_groups,
                    seed=spec.seed,
                ).requests()
            ]
        load = TraceReplayLoad(
            spec.arrivals, [spec.batch_size] * len(spec.arrivals), tags=tags
        )
        with tracer.span("scenario:trace", TraceLevel.MODEL):
            t0 = clock()
            rows = self.closed_loop(list(load.requests()), sched, clock, sleep, t0, True)
        lat = [r["latency_s"] for r in rows]
        metrics = latency_summary(lat)
        metrics.update({"scenario": "trace", "num_requests": len(rows)})
        if tags is not None:
            shared = sum(1 for t in tags if t.get("prefix_group", -1) >= 0)
            metrics.update(
                {
                    "prefix_len": spec.prefix_len,
                    "shared_prefix_requests": shared,
                    "shared_prefix_fraction": shared / max(len(tags), 1),
                }
            )
        return metrics


class SingleStreamScenario(Scenario):
    """MLPerf single-stream: back-to-back batch-1 requests, latency-bound."""

    kind = "single_stream"

    def run(self, predict, tracer, clock, sleep, scheduler=None):
        spec = self.spec
        self.warmup(predict, tracer, 1)
        sched = self.make_scheduler(predict, tracer, clock, sleep, scheduler)
        load = BatchedLoad(spec.num_requests, 1)
        with tracer.span("scenario:single_stream", TraceLevel.MODEL):
            t0 = clock()
            rows = self.closed_loop(list(load.requests()), sched, clock, sleep, t0, False)
            elapsed = clock() - t0
        lat = [r["latency_s"] for r in rows]
        metrics = latency_summary(lat)
        metrics.update(
            {
                "scenario": "single_stream",
                "num_requests": len(rows),
                "p99_ms": percentile(lat, 99.0) * 1e3,
                "streams_per_s": len(rows) / elapsed if elapsed > 0 else float("inf"),
            }
        )
        return metrics


class ServerScenario(Scenario):
    """MLPerf server: open-loop Poisson arrivals through the micro-batching
    scheduler, with p99-latency SLO accounting and achieved-QPS."""

    kind = "server"
    default_scheduler = SchedulerConfig(max_batch=4, batch_timeout_ms=2.0)

    def run(self, predict, tracer, clock, sleep, scheduler=None):
        spec = self.spec
        self.warmup(predict, tracer, 1)
        sched = self.make_scheduler(predict, tracer, clock, sleep, scheduler)
        multi = bool(spec.tenants or spec.priority_mix)
        if spec.tenants:
            # multi-tenant mix: superposed per-tenant Poisson streams whose
            # tags carry each tenant's identity, tier, SLO and token shape
            tdicts = [dict(t) for t in spec.tenants]
            for t in tdicts:
                t.setdefault("rate_hz", spec.rate_hz / len(tdicts))
                t.setdefault("slo_ms", spec.slo_ms)
            load = MultiTenantLoad(
                spec.num_requests, tdicts, seed=spec.seed
            )
        elif spec.prefix_len > 0:
            # shared-prefix server mix: Poisson arrivals whose requests
            # carry prompt-composition tags (prefix group / lengths) so the
            # scheduler path — and the paged engine behind it — sees the
            # request mix the prefix cache is built for
            load = SharedPrefixLoad(
                spec.num_requests,
                rate_hz=spec.rate_hz,
                prefix_len=spec.prefix_len,
                suffix_len=spec.suffix_len,
                share_ratio=spec.prefix_share,
                num_groups=spec.prefix_groups,
                seed=spec.seed,
            )
        else:
            load = PoissonLoad(spec.num_requests, spec.rate_hz, seed=spec.seed)
        mix_rng = random.Random(spec.seed) if spec.priority_mix else None
        tiers: List[int] = []
        weights: List[float] = []
        if spec.priority_mix:
            for name, frac in spec.priority_mix.items():
                tiers.append(
                    PRIORITY_TIERS.index(name)
                    if name in PRIORITY_TIERS else int(name)
                )
                weights.append(float(frac))

        def submit_kwargs(req: Request) -> Dict[str, Any]:
            if spec.tenants:
                tags = req.tags
                cost = float(
                    int(tags.get("prompt_len", 0))
                    + int(tags.get("gen_tokens", 0))
                )
                return {
                    "tenant": str(tags.get("tenant", "default")),
                    "priority": int(tags.get("priority", 1)),
                    "slo_ms": float(tags.get("slo_ms") or spec.slo_ms),
                    "cost_tokens": cost if cost > 0 else None,
                }
            if mix_rng is not None:
                return {
                    "priority": mix_rng.choices(tiers, weights)[0],
                    "slo_ms": spec.slo_ms,
                }
            return {}

        with tracer.span("scenario:server", TraceLevel.MODEL, rate_hz=spec.rate_hz):
            t0 = clock()
            futs = [
                sched.submit(
                    payload=req.tags or None,
                    batch_size=1,
                    arrival_s=t0 + req.arrival_s,
                    **submit_kwargs(req),
                )
                for req in load.requests()
            ]
            sched.run_until_idle()
        reqs = [f.request for f in futs]
        done = [r for r in reqs if r.status == "completed"] if multi else reqs
        # end-to-end latency including queueing: completion - arrival
        lat = [r.latency_s for r in done]
        makespan = max(r.end_s for r in reqs) - t0
        n = len(reqs)
        p99 = percentile(lat, 99.0) * 1e3 if lat else float("nan")
        metrics = latency_summary(lat)
        metrics.update(
            {
                "scenario": "server",
                "num_requests": n,
                "p99_ms": p99,
                "achieved_qps": (
                    len(done) / makespan if makespan > 0 else float("inf")
                ),
                "offered_qps": spec.rate_hz,
                "slo_ms": spec.slo_ms,
                "slo_met": bool(lat) and p99 <= spec.slo_ms,
                "mean_queue_s": (
                    sum(r.queue_s for r in done) / len(done) if done else 0.0
                ),
                **slo_attainment(lat, spec.slo_ms),
                **self.scheduler_metrics(sched),
            }
        )
        if multi:
            ledger = sched.ledger.stats()
            metrics.update(
                {
                    "fairness": spec.fairness,
                    "completed": len(done),
                    "rejected": sum(
                        1 for r in reqs if r.status == "rejected"
                    ),
                    "jain_index": jain_index(
                        [v["tokens_admitted"] for v in ledger.values()]
                    ),
                    "tenant_stats": ledger,
                }
            )
            for tname in sorted(ledger):
                tl = [r.latency_s for r in done if r.tenant == tname]
                if tl:
                    metrics[f"{tname}_p99_ms"] = percentile(tl, 99.0) * 1e3
        if spec.prefix_len > 0:
            shared = sum(
                1
                for r in reqs
                if isinstance(r.payload, dict)
                and r.payload.get("prefix_group", -1) >= 0
            )
            metrics.update(
                {
                    "prefix_len": spec.prefix_len,
                    "shared_prefix_requests": shared,
                    "shared_prefix_fraction": shared / n,
                }
            )
        return metrics


class OfflineScenario(Scenario):
    """MLPerf offline: submit everything at once; the scheduler coalesces
    micro-batches of up to ``max_batch`` requests — max throughput."""

    kind = "offline"
    default_scheduler = SchedulerConfig(max_batch=8, batch_timeout_ms=0.0)

    def run(self, predict, tracer, clock, sleep, scheduler=None):
        spec = self.spec
        cfg = scheduler or self.default_scheduler
        self.warmup(predict, tracer, spec.batch_size * cfg.max_batch)
        sched = self.make_scheduler(predict, tracer, clock, sleep, cfg)
        with tracer.span("scenario:offline", TraceLevel.MODEL):
            t0 = clock()
            futs = [
                sched.submit(batch_size=spec.batch_size, arrival_s=t0)
                for _ in range(spec.num_requests)
            ]
            sched.run_until_idle()
            elapsed = clock() - t0
        reqs = [f.request for f in futs]
        inputs = sum(r.batch_size for r in reqs)
        lat = [r.latency_s for r in reqs]
        metrics = latency_summary(lat)
        metrics.update(
            {
                "scenario": "offline",
                "num_requests": len(reqs),
                "throughput_ips": inputs / elapsed if elapsed > 0 else float("inf"),
                "elapsed_s": elapsed,
                **self.scheduler_metrics(sched),
            }
        )
        return metrics


_SCENARIOS: Dict[str, Type[Scenario]] = {
    cls.kind: cls
    for cls in (
        OnlineScenario,
        BatchedScenario,
        TraceScenario,
        SingleStreamScenario,
        ServerScenario,
        OfflineScenario,
    )
}


def register_scenario(kind: str, cls: Type[Scenario]) -> None:
    """Pluggable scenarios, mirroring the workload-generator registry."""
    _SCENARIOS[kind] = cls


def scenario_kinds() -> List[str]:
    return sorted(_SCENARIOS)


def make_scenario(spec: ScenarioSpec) -> Scenario:
    try:
        return _SCENARIOS[spec.kind](spec)
    except KeyError:
        raise ValueError(f"unknown scenario kind {spec.kind!r}; have {sorted(_SCENARIOS)}")


def run_scenario(
    spec: ScenarioSpec,
    predict: PredictFn,
    tracer: Tracer,
    clock: Callable[[], float] = time.perf_counter,
    sleep: Callable[[float], None] = time.sleep,
    scheduler: Optional[Union[SchedulerConfig, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Execute a scenario and return its metrics dict.

    Compatibility shim: callers keep passing a bare predict function; the
    scenario wraps it in a :class:`RequestScheduler` (closed-loop kinds use a
    degenerate batch-1 scheduler so their metrics are bit-identical to the
    pre-scheduler implementation).  ``scheduler`` selects the
    scheduler-backed executor configuration (threaded through
    ``EvaluationRequest.scheduler`` by the agent/server dispatch).
    ``clock``/``sleep`` are injectable for deterministic tests."""
    if isinstance(scheduler, dict):
        scheduler = SchedulerConfig.from_dict(scheduler)
    return make_scenario(spec).run(predict, tracer, clock, sleep, scheduler=scheduler)
