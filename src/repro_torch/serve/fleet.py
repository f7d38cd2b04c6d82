"""Fault-tolerant multi-worker serving fleet (the "millions of users" story).

The port's copy of ``repro.serve.fleet`` over the port's engines, its
``KVStore``, tenant ledger and fault plan (pure Python: the port keeps its
own copy so that it never imports ``repro``).  One difference: in parallel
mode an exception other than :class:`~repro_torch.serve.faults.WorkerCrash`
inside a worker thread (a failed kernel launch, a CUDA error) is re-raised
from :meth:`FleetRouter.serve` once the round's other threads have ended,
where the reference leaves that worker's outcome empty, lets its lease
lapse and hedges its work onto the survivors.  Sequential mode raises it
in both packages.

A :class:`FleetRouter` runs N ``serve_paged`` workers — in-process engine
instances, each with its own page pool — behind one admission queue:

* **load balancing** — each round, ready requests are packed onto alive
  workers by free-page budget and assigned queue depth (worst-case page
  commitment per request, the same ledger the engine's admission uses);
* **deadlines + retries** — every request carries a TTL and a retry budget
  with capped exponential backoff + jitter (seeded, so schedules are
  deterministic);
* **requeue-on-death** — a worker that crashes (or fails to renew its
  heartbeat lease mid-run) raises :class:`~repro_torch.serve.faults.WorkerCrash`
  carrying a resumable snapshot: finished results commit, pending requests
  replay from their prompts on the survivors (the preemption-recompute
  contract — greedy decode makes the replay bit-identical);
* **live KV migration** — with ``recovery="migrate"`` workers checkpoint
  each decoding slot's KV pages every ``checkpoint_every`` steps
  (:class:`~repro_torch.serve.page_table.PageSnapshot`: exact page bytes +
  per-page checksums + emitted tokens); orphans whose checkpoint survives
  are *restored* on a survivor — O(bytes moved) instead of O(prompt
  tokens recomputed) — and continue bit-identically even beyond greedy
  decoding.  Replay-from-prompt stays the fallback when no checkpoint
  exists or its checksums fail (corrupted state is never served);
* **elasticity** — ``drain(worker)`` snapshots every live slot at a loop
  boundary and migrates all of them with zero recompute before removing
  the worker (planned removal, not a death); ``join(engine)`` adds a
  worker mid-serve that immediately participates in balancing;
* **idempotent completion** — a request duplicated by straggler/hedge
  dispatch commits exactly once (first commit wins, later ones count as
  ``duplicate_commits``).  In parallel mode a worker whose lease lapses
  mid-run is *detached*: its thread keeps running, its uncommitted work is
  immediately re-dispatched to the survivors, and whatever the straggler
  eventually returns is deduped at commit;
* **graceful degradation** — a :class:`DegradeLadder` steps through
  pressure levels with hysteresis: first disable spec decode, then shrink
  the prefill budget, then shed new admissions with an explicit
  ``rejected`` status.  Shedding is priority-aware: only the lowest tier
  present among the shed candidates is dropped each round, so best-effort
  work absorbs the overload before any higher tier loses a request;
* **tenant fairness** — with per-request ``tenant``/``priority`` tags
  (and optional :class:`~repro_torch.serve.scheduler.TenantSpec` token buckets)
  the per-round packing order follows the same policy as the scheduler:
  bucket-dry tenants sink, higher tiers first, then weighted fair share
  by admitted tokens.  Untagged workloads keep exact FIFO packing.

Every submitted request ends in exactly one attributed terminal status —
``completed``, ``failed`` (with a reason) or ``rejected`` — zero silent
losses.  Transitions emit ``fleet:*`` tracer events feeding
``analysis.fleet_summary`` (deaths, requeues, sheds, recovery time,
goodput retained).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.registry import KVStore
from .faults import FaultPlan, WorkerCrash, WorkerDrain
from .page_table import pages_needed
from .scheduler import TenantLedger, TenantSpec, backoff_delay

__all__ = [
    "DEGRADE_LEVELS",
    "DegradeLadder",
    "FleetConfig",
    "FleetResult",
    "FleetRouter",
    "FleetStats",
]

DEGRADE_LEVELS = ("normal", "no_spec", "tight_prefill", "shed")


class DegradeLadder:
    """Pressure-driven degrade levels with hysteresis.

    ``update(pressure)`` steps the level up by one when pressure crosses
    the high watermark, down by one when it falls below the low watermark,
    and holds inside the band — so a pressure signal oscillating between
    the watermarks cannot flap the serving mode.  Levels (in order):
    ``normal`` -> ``no_spec`` (speculative decode off) -> ``tight_prefill``
    (prefill budget halved) -> ``shed`` (new admissions rejected).
    Pure bookkeeping: the router applies the effects.
    """

    def __init__(self, high: float = 0.85, low: float = 0.60,
                 tracer: Any = None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        if not 0.0 <= low < high:
            raise ValueError("need 0 <= low < high")
        self.high = high
        self.low = low
        self.level = 0
        self.max_level = 0
        self.tracer = tracer
        self.clock = clock
        # (time, from_level, to_level, pressure) — the transition audit trail
        self.transitions: List[Tuple[float, int, int, float]] = []

    @property
    def name(self) -> str:
        return DEGRADE_LEVELS[self.level]

    def update(self, pressure: float) -> int:
        new = self.level
        if pressure >= self.high and self.level < len(DEGRADE_LEVELS) - 1:
            new = self.level + 1
        elif pressure < self.low and self.level > 0:
            new = self.level - 1
        if new != self.level:
            now = self.clock()
            self.transitions.append((now, self.level, new, pressure))
            if self.tracer is not None:
                self.tracer.event(
                    "fleet:degrade", now, now,
                    frm=self.level, to=new, pressure=pressure,
                    mode=DEGRADE_LEVELS[new],
                )
            self.level = new
            self.max_level = max(self.max_level, new)
        return self.level


@dataclass
class FleetConfig:
    """Router knobs: failure handling, degradation, and dispatch mode."""

    deadline_s: float = 0.0        # per-request TTL from submit (0 = none)
    max_retries: int = 2           # requeues per request before failed
    backoff_base_s: float = 0.0    # requeue backoff base (0 = immediate)
    backoff_cap_s: float = 0.25    # requeue backoff cap
    backoff_jitter: float = 0.0    # ±fraction jitter (seeded rng)
    seed: int = 0                  # jitter rng seed
    lease_ttl_s: float = 30.0      # worker heartbeat lease TTL
    high_watermark: float = 0.85   # pressure above -> degrade one level
    low_watermark: float = 0.60    # pressure below -> recover one level
    fairness: bool = True          # tenant-fair packing order (off: FIFO)
    parallel: bool = False         # threads per round (else deterministic
    #                                sequential rounds — same commits/tokens)
    hedge: bool = True             # parallel mode: detach a lease-expired
    #                                worker and re-dispatch its work now
    max_rounds: int = 1000         # safety valve against router bugs
    recovery: str = "migrate"      # orphan recovery: "migrate" restores the
    #                                latest checkpointed KV pages on a
    #                                survivor (O(bytes) failover); "replay"
    #                                re-prefills from the prompt.
    #                                Replay stays the fallback either way
    #                                when no checkpoint exists or its
    #                                checksums fail
    checkpoint_every: int = 0      # decode steps between KV checkpoints
    #                                (0 = none: only planned drains migrate)


@dataclass
class FleetResult:
    """One request's terminal outcome (exactly one per submitted request)."""

    request_id: int
    status: str                    # completed | failed | rejected
    worker: int = -1               # worker that committed it (-1: none)
    tokens: Any = None             # np.int32 tokens (completed only)
    reason: str = ""               # failed/rejected attribution
    attempts: int = 0              # dispatch attempts consumed
    latency_s: float = 0.0         # submit -> terminal
    within_deadline: bool = True   # completed before its TTL (goodput)


@dataclass
class FleetStats:
    """One fleet run: per-request outcomes + failure/degradation ledgers."""

    results: List[FleetResult]
    num_workers: int
    wall_s: float
    rounds: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0              # shed with explicit rejected status
    deaths: int = 0
    requeued: int = 0              # requests replayed after a death
    hedged: int = 0                # duplicate dispatches on lease expiry
    duplicate_commits: int = 0     # later commits deduped (idempotence)
    total_tokens: int = 0
    throughput_tps: float = 0.0
    goodput: float = 0.0           # completed-within-deadline / admitted
    recovery_s: List[float] = field(default_factory=list)
    degrade_transitions: List[Tuple[float, int, int, float]] = \
        field(default_factory=list)
    max_degrade_level: int = 0
    per_worker: List[Dict[str, Any]] = field(default_factory=list)
    # -- migration / elasticity ledger ------------------------------------
    migrated: int = 0              # orphans restored from a KV checkpoint
    migrated_tokens: int = 0       # KV tokens restored without recompute
    recomputed_prefill_tokens: int = 0  # replay-path orphans' prompt tokens
    bytes_moved: int = 0           # snapshot bytes scattered on survivors
    checkpoints_saved: int = 0
    checkpoint_bytes: int = 0
    checksum_failures: int = 0     # corrupted snapshots detected (never served)
    drains: int = 0                # planned worker removals (not deaths)
    joins: int = 0                 # workers added mid-serve

    def result_of(self, request_id: int) -> FleetResult:
        for r in self.results:
            if r.request_id == request_id:
                return r
        raise KeyError(f"request {request_id} not in fleet results")


class _Tracked:
    """Router-side request state: one per submitted request, forever."""

    __slots__ = ("req", "attempts", "not_before", "result", "worker",
                 "dispatched", "worst_pages")

    def __init__(self, req: Any, worst_pages: int) -> None:
        self.req = req
        self.attempts = 0          # dispatches so far
        self.not_before = 0.0      # backoff gate for the next dispatch
        self.result: Optional[FleetResult] = None
        self.worker = -1
        self.dispatched = False    # ever assigned to a worker
        self.worst_pages = worst_pages

    @property
    def terminal(self) -> bool:
        return self.result is not None


class _Worker:
    """One serve_paged engine instance plus its lease + fault hook."""

    def __init__(self, index: int, engine: Any, kwargs: Dict[str, Any]) -> None:
        self.index = index
        self.engine = engine
        self.alive = True
        self.served = 0
        self.steps = 0
        self.deaths = 0
        self.hook: Optional[Callable] = None
        page_size = kwargs.get("page_size") or engine.page_size
        num_slots = kwargs.get("num_slots") or engine.max_batch
        per_seq = pages_needed(engine.max_seq, page_size)
        num_pages = kwargs.get("num_pages") or num_slots * per_seq + 1
        self.page_size = page_size
        self.num_slots = num_slots
        # allocatable worst-case page budget (engine reserves one scratch
        # page) — the router's admission ledger mirror
        self.capacity = num_pages - 1
        # request_id -> PageSnapshot written by the engine's periodic
        # checkpoint (and the drain handler); harvested on death/drain
        self.checkpoints: Dict[int, Any] = {}

    @property
    def lease_key(self) -> str:
        return f"fleet/worker-{self.index}"


class FleetRouter:
    """Routes requests over N paged-serving workers with a failure model."""

    def __init__(
        self,
        engines: Sequence[Any],
        config: Optional[FleetConfig] = None,
        engine_kwargs: Optional[Dict[str, Any]] = None,
        fault_plan: Optional[FaultPlan] = None,
        *,
        store: Optional[KVStore] = None,
        clock: Callable[[], float] = time.perf_counter,
        sleep: Callable[[float], None] = time.sleep,
        tracer: Any = None,
        tenants: Sequence[TenantSpec] = (),
    ) -> None:
        if not engines:
            raise ValueError("need at least one engine")
        self.config = config or FleetConfig()
        self.engine_kwargs = dict(engine_kwargs or {})
        for k in ("clock", "tracer", "fault_hook"):
            if k in self.engine_kwargs:
                raise ValueError(f"engine_kwargs may not override {k!r}")
        self.fault_plan = fault_plan or FaultPlan()
        self.clock = clock
        self.sleep = sleep
        self.tracer = tracer
        self.store = store or KVStore(clock=clock)
        self._rng = random.Random(self.config.seed)
        self.workers = [
            _Worker(i, e, self.engine_kwargs) for i, e in enumerate(engines)
        ]
        for w in self.workers:
            w.hook = self._make_hook(w)
        self.ladder = DegradeLadder(
            self.config.high_watermark, self.config.low_watermark,
            tracer=tracer, clock=clock,
        )
        self.tenant_ledger = TenantLedger(tenants)
        self._has_tenants = bool(tenants)
        # detached stragglers (parallel mode): worker index -> holder dict
        # with the still-running thread and, once done, its outcome
        self._inflight: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        # elasticity: scripted drains (worker -> boundary step) and pending
        # joins ((round, engine) — added at the start of that round)
        self._drain_at: Dict[int, int] = {}
        self._joins: List[Tuple[int, Any]] = []
        # harvested snapshots awaiting a survivor: request_id -> snapshot
        self._migrations: Dict[int, Any] = {}

    # -- hooks ---------------------------------------------------------------
    def _make_hook(self, w: _Worker) -> Callable:
        """Boundary hook: heartbeat the worker's lease first (a renewal
        refused after expiry is a self-inflicted death — lease expiry and
        crash share one recovery path), then fire any scripted faults."""
        fhook = self.fault_plan.hook_for(w.index, sleep=self.sleep)
        store, key, ttl = self.store, w.lease_key, self.config.lease_ttl_s

        def hook(ctx) -> None:
            w.steps += 1
            if not store.renew(key, ttl):
                raise WorkerCrash(w.index, ctx.step, reason="lease-expired")
            at = self._drain_at.get(w.index)
            if at is not None and ctx.step >= at:
                # planned removal: the engine's drain handler snapshots
                # every live slot before this propagates (fires once)
                del self._drain_at[w.index]
                raise WorkerDrain(w.index, ctx.step)
            if fhook is not None:
                fhook(ctx)

        hook.release = fhook.release if fhook is not None else (lambda: 0)
        return hook

    # -- elasticity ----------------------------------------------------------
    def drain(self, worker: int, at_step: int = 0) -> None:
        """Schedule a planned removal of ``worker``: at the first loop
        boundary with ``step >= at_step`` the worker snapshots every live
        slot and exits; its requests migrate to survivors with ZERO
        recompute (drain works even with ``checkpoint_every=0``)."""
        if not 0 <= worker < len(self.workers):
            raise ValueError(f"no worker {worker}")
        self._drain_at[worker] = at_step

    def join(self, engine: Any, at_round: int = 0) -> int:
        """Add a worker mid-serve: ``engine`` joins the alive set at the
        start of round ``at_round`` (0 = the next round) and immediately
        participates in balancing — including picking up migrations.
        Returns the new worker's index."""
        index = len(self.workers) + len(self._joins)
        self._joins.append((at_round, engine))
        return index

    # -- terminal-state bookkeeping -----------------------------------------
    def _commit(self, t: _Tracked, tokens: Any, worker: int,
                now: float) -> bool:
        """Idempotent completion: the first commit wins; duplicates (from
        straggler/hedge dispatch) are counted and dropped."""
        if t.terminal:
            self._dups += 1
            if self.tracer is not None:
                self.tracer.event(
                    "fleet:commit", now, now, request=t.req.request_id,
                    worker=worker, duplicate=1,
                )
            return False
        latency = now - self._t_start
        within = (self.config.deadline_s <= 0
                  or latency <= self.config.deadline_s)
        t.result = FleetResult(
            request_id=t.req.request_id, status="completed", worker=worker,
            tokens=tokens, attempts=t.attempts, latency_s=latency,
            within_deadline=within,
        )
        t.worker = worker
        if self.tracer is not None:
            self.tracer.event(
                "fleet:commit", now, now, request=t.req.request_id,
                worker=worker, duplicate=0, within_deadline=int(within),
                latency_s=latency,
            )
        return True

    def _fail(self, t: _Tracked, reason: str, now: float,
              status: str = "failed") -> None:
        if t.terminal:
            return
        t.result = FleetResult(
            request_id=t.req.request_id, status=status, worker=-1,
            reason=reason, attempts=t.attempts,
            latency_s=now - self._t_start, within_deadline=False,
        )
        if self.tracer is not None:
            self.tracer.event(
                f"fleet:{'shed' if status == 'rejected' else 'failed'}",
                now, now, request=t.req.request_id, reason=reason,
            )

    def _requeue(self, orphans: List[_Tracked], now: float) -> int:
        """Push orphaned requests back for the survivors, honoring each
        request's retry budget with capped exponential backoff + jitter;
        returns how many were actually requeued (vs terminally failed)."""
        n = 0
        for t in orphans:
            if t.terminal:
                continue
            if t.attempts > self.config.max_retries:
                self._fail(t, "retries-exhausted", now)
                continue
            delay = 0.0
            if self.config.backoff_base_s > 0:
                delay = backoff_delay(
                    max(t.attempts, 1), self.config.backoff_base_s,
                    self.config.backoff_cap_s, self.config.backoff_jitter,
                    self._rng,
                )
            t.not_before = now + delay
            n += 1
            if self.tracer is not None:
                self.tracer.event(
                    "fleet:requeue", now, now, request=t.req.request_id,
                    attempts=t.attempts, delay_s=delay,
                )
        return n

    # -- dispatch ------------------------------------------------------------
    @staticmethod
    def _req_tenant(t: _Tracked) -> str:
        return getattr(t.req, "tenant", "default")

    @staticmethod
    def _req_prio(t: _Tracked) -> int:
        return int(getattr(t.req, "priority", 1))

    @staticmethod
    def _req_cost(t: _Tracked) -> float:
        return float(len(t.req.prompt) + t.req.max_new_tokens)

    def _fair_order(self, ready: List[_Tracked],
                    now: float) -> List[_Tracked]:
        """Packing order: the scheduler's dequeue policy applied per round —
        bucket-dry tenants last, then priority tier, then weighted fair
        share (per-tenant virtual time), then submission order.  Untagged
        workloads (single default tenant, uniform priority, no buckets)
        reduce to the identity: exact FIFO, byte-for-byte the old order."""
        if not self.config.fairness:
            return ready
        if not self._has_tenants and all(
            self._req_tenant(t) == "default" and self._req_prio(t) == 1
            for t in ready
        ):
            return ready
        led = self.tenant_ledger

        def key(pair: Tuple[int, _Tracked]):
            i, t = pair
            name = self._req_tenant(t)
            return (led.dry(name, self._req_cost(t), now),
                    -self._req_prio(t), led.vtime.get(name, 0.0), i)

        return [t for _, t in sorted(enumerate(ready), key=key)]

    def _balance(self, ready: List[_Tracked], alive: List[_Worker],
                 now: float = 0.0) -> Dict[int, List[_Tracked]]:
        """Pack ready requests (fair order; FIFO when untagged) onto alive
        workers by free worst-case page budget + assigned queue depth; a
        request that fits no worker this round waits for the next one."""
        load = {w.index: 0 for w in alive}       # assigned worst-case pages
        count = {w.index: 0 for w in alive}      # assigned queue depth
        out: Dict[int, List[_Tracked]] = {w.index: [] for w in alive}
        by_index = {w.index: w for w in alive}
        for t in self._fair_order(ready, now):
            best = None
            best_score = None
            for i, w in by_index.items():
                if load[i] + t.worst_pages > w.capacity:
                    continue
                if count[i] >= 2 * w.num_slots:
                    continue         # bound per-round queueing inside a run
                score = (load[i] / w.capacity, count[i], i)
                if best_score is None or score < best_score:
                    best, best_score = i, score
            if best is None:
                continue
            out[best].append(t)
            load[best] += t.worst_pages
            count[best] += 1
            if self.config.fairness and (
                self._has_tenants or self._req_tenant(t) != "default"
                or self._req_prio(t) != 1
            ):
                self.tenant_ledger.on_admit(
                    self._req_tenant(t), self._req_cost(t), now
                )
        return {i: ts for i, ts in out.items() if ts}

    def _degraded_kwargs(self) -> Dict[str, Any]:
        kw = dict(self.engine_kwargs)
        if self.ladder.level >= 1:
            kw["spec_k"] = 0        # greedy acceptance: tokens unchanged
        if self.ladder.level >= 2:
            page = kw.get("page_size") or self.workers[0].page_size
            base = kw.get("prefill_budget") or 0
            if base:
                kw["prefill_budget"] = max(page, (base // 2 // page) * page)
        return kw

    def _run_worker(self, w: _Worker,
                    batch: List[_Tracked]) -> Tuple[str, Any]:
        reqs = [t.req for t in batch]
        kw = self._degraded_kwargs()
        restores: Dict[int, Any] = {}
        if self.config.recovery == "migrate":
            # arm the engine's checkpoint/restore machinery: a fresh
            # checkpoint store per run (stale snapshots must not outlive
            # the run that wrote them) plus this batch's pending migrations
            w.checkpoints.clear()
            kw["checkpoints"] = w.checkpoints
            kw["checkpoint_every"] = self.config.checkpoint_every
            restores = {
                t.req.request_id: self._migrations.pop(t.req.request_id)
                for t in batch if t.req.request_id in self._migrations
            }
            if restores:
                kw["restores"] = restores
        try:
            stats = w.engine.serve_paged(
                reqs, clock=self.clock, tracer=self.tracer,
                fault_hook=w.hook, **kw,
            )
            return ("ok", stats)
        except WorkerCrash as crash:
            return ("crash", crash)
        finally:
            # snapshots the run never consumed (crash before admission, or
            # engine-side rejection) go back in the pool for the next
            # survivor; checksum-failed ones were deleted by the engine
            self._migrations.update(restores)

    # -- the round loop ------------------------------------------------------
    def serve(self, requests: Sequence[Any]) -> FleetStats:
        """Serve ``requests`` to terminal status across the fleet."""
        cfg = self.config
        self._t_start = self.clock()
        self._dups = 0
        seen: set = set()
        tracked: List[_Tracked] = []
        min_cap = min(w.capacity for w in self.workers)
        for r in requests:
            if r.request_id in seen:
                raise ValueError(f"duplicate request_id {r.request_id}")
            seen.add(r.request_id)
            worst = pages_needed(
                len(r.prompt) + r.max_new_tokens, self.workers[0].page_size
            )
            tracked.append(_Tracked(r, worst))
        self._by_id = {t.req.request_id: t for t in tracked}
        stats = FleetStats(results=[], num_workers=len(self.workers),
                           wall_s=0.0)
        self._deaths_open: List[Dict[str, Any]] = []
        # oversize requests can never be admitted anywhere: attributed
        # failure up front (the engine would raise mid-run otherwise)
        max_seq = min(w.engine.max_seq for w in self.workers)
        for t in tracked:
            r = t.req
            if (len(r.prompt) + r.max_new_tokens > max_seq
                    or t.worst_pages > min_cap):
                self._fail(t, "oversize", self._t_start)
        # leases: every worker starts alive with a fresh lease
        for w in self.workers:
            self.store.put(w.lease_key, {"worker": w.index},
                           ttl=cfg.lease_ttl_s)
        rounds = 0
        while any(not t.terminal for t in tracked):
            now = self.clock()
            # 0) elasticity: pending joins whose round has arrived enter the
            #    alive set with a fresh lease and hook — they participate in
            #    this round's balancing (including pending migrations)
            for rnd, eng in list(self._joins):
                if rnd <= rounds:
                    self._joins.remove((rnd, eng))
                    w = _Worker(len(self.workers), eng, self.engine_kwargs)
                    w.hook = self._make_hook(w)
                    self.workers.append(w)
                    self.store.put(w.lease_key, {"worker": w.index},
                                   ttl=cfg.lease_ttl_s)
                    stats.joins += 1
                    if self.tracer is not None:
                        self.tracer.event(
                            "fleet:join", now, now, worker=w.index,
                            round=rounds,
                        )
            # collect any detached straggler that finished since last round
            # (their commits dedupe — the idempotent-completion path)
            self._process_outcomes(self._collect_stragglers(block=False),
                                   stats)
            busy = set(self._inflight)
            alive = [w for w in self.workers
                     if w.alive and w.index not in busy]
            live = [t for t in tracked if not t.terminal]
            # 1) deadline enforcement before dispatch: queued requests whose
            #    TTL already passed fail with an attributed status
            if cfg.deadline_s > 0:
                for t in live:
                    if now - self._t_start > cfg.deadline_s:
                        self._fail(t, "deadline", now)
                live = [t for t in live if not t.terminal]
                if not live:
                    break
            if not live:
                break
            if not alive and not busy:
                for t in live:
                    self._fail(t, "no-workers-left", now)
                break
            rounds += 1
            if rounds > cfg.max_rounds:
                raise RuntimeError(
                    f"fleet router exceeded {cfg.max_rounds} rounds"
                )
            # 2) pressure -> degrade ladder (hysteresis).  Pressure is the
            #    worst of: demand vs the alive fleet's page budget, and the
            #    missed-deadline rate so far
            demand = sum(t.worst_pages for t in live)
            cap = sum(w.capacity for w in alive)
            done = [t for t in tracked if t.terminal]
            missed = sum(
                1 for t in done
                if t.result.status == "failed"
                and t.result.reason == "deadline"
            )
            rate = missed / len(done) if done else 0.0
            pressure = max(demand / cap if cap else 1.0, rate)
            level = self.ladder.update(pressure)
            if self.tracer is not None:
                self.tracer.event(
                    "fleet:round", now, now, round=rounds, alive=len(alive),
                    queued=len(live), pressure=pressure, level=level,
                )
            # 3) backoff gate
            ready = [t for t in live if t.not_before <= now]
            if not ready or not alive:
                horizon = [t.not_before for t in live if t.not_before > now]
                wait = (min(horizon) - now) if horizon \
                    else max(cfg.lease_ttl_s / 4.0, 1e-3)
                self.sleep(wait)
                continue
            # 4) pack ready work onto workers; at the shed level, ready
            #    requests that did not fit this round AND were never
            #    dispatched before are rejected (shed), not queued forever.
            #    Shedding is priority-aware: only the lowest tier present
            #    among the candidates drops this round, so best-effort
            #    work absorbs overload before any higher tier is touched
            #    (liveness holds — a surviving tier becomes the lowest
            #    present next round and sheds then if still unplaceable)
            assignment = self._balance(ready, alive, now)
            assigned = {t.req.request_id
                        for ts in assignment.values() for t in ts}
            if level >= 3:
                victims = [t for t in ready
                           if t.req.request_id not in assigned
                           and not t.dispatched]
                if victims:
                    floor = min(self._req_prio(t) for t in victims)
                    for t in victims:
                        if self._req_prio(t) == floor:
                            self.tenant_ledger.note_shed(self._req_tenant(t))
                            self._fail(t, "shed", now, status="rejected")
            if not assignment:
                # every candidate exceeded the per-round bounds (can only
                # happen transiently while stragglers hold workers busy)
                self.sleep(max(cfg.lease_ttl_s / 4.0, 1e-3))
                continue
            for i, ts in assignment.items():
                # dispatch-time health check: grant a fresh lease (an idle
                # in-process worker is healthy by construction; only a
                # worker that stalls MID-run can miss renewals and die)
                self.store.put(self.workers[i].lease_key, {"worker": i},
                               ttl=cfg.lease_ttl_s)
                for t in ts:
                    t.attempts += 1
                    t.dispatched = True
                if self.tracer is not None:
                    self.tracer.event(
                        "fleet:dispatch", now, now, worker=i,
                        requests=len(ts),
                        pages=sum(t.worst_pages for t in ts),
                    )
            # 5) run the round and fold in the outcomes
            self._process_outcomes(self._run_round(assignment, stats), stats)
            # 6) recovery accounting: a death is recovered once every
            #    request it orphaned has reached a terminal status
            self._settle_recoveries(stats)
        # drain detached stragglers so their late results are accounted
        # (as duplicates, or as real commits for still-pending work)
        self._process_outcomes(self._collect_stragglers(block=True), stats)
        self._settle_recoveries(stats)
        tnow = self.clock()
        for d in self._deaths_open:  # pragma: no cover - drained above
            stats.recovery_s.append(tnow - d["t"])
        stats.results = [t.result for t in tracked]
        stats.rounds = rounds
        stats.num_workers = len(self.workers)   # joins included
        stats.wall_s = tnow - self._t_start
        stats.completed = sum(1 for r in stats.results
                              if r.status == "completed")
        stats.failed = sum(1 for r in stats.results if r.status == "failed")
        stats.rejected = sum(1 for r in stats.results
                             if r.status == "rejected")
        stats.duplicate_commits = self._dups
        stats.total_tokens = sum(
            len(r.tokens) for r in stats.results if r.tokens is not None
        )
        stats.throughput_tps = (
            stats.total_tokens / stats.wall_s if stats.wall_s > 0
            else float("inf")
        )
        admitted = stats.completed + stats.failed
        within = sum(1 for r in stats.results
                     if r.status == "completed" and r.within_deadline)
        stats.goodput = within / admitted if admitted else 0.0
        stats.degrade_transitions = list(self.ladder.transitions)
        stats.max_degrade_level = self.ladder.max_level
        stats.per_worker = [
            {"worker": w.index, "alive": w.alive, "served": w.served,
             "steps": w.steps, "deaths": w.deaths}
            for w in self.workers
        ]
        return stats

    # -- outcome folding -----------------------------------------------------
    def _fold_result(self, rr: Any, worker: int, tnow: float) -> None:
        """Fold one engine-level result into router state.  Completed
        results commit (idempotently); an engine that itself rejected a
        request (its own deadline/SLO shed) propagates that terminal
        status instead of being mistaken for a commit."""
        t = self._by_id[rr.request_id]
        status = getattr(rr, "status", "completed")
        if status == "completed":
            self._commit(t, rr.tokens, worker, tnow)
        else:
            reason = getattr(rr, "reason", "") or status
            self._fail(t, reason, tnow,
                       status="rejected" if status == "rejected"
                       else "failed")

    def _process_outcomes(self, outcomes: Dict[int, Tuple[str, Any]],
                          stats: FleetStats) -> None:
        for i, (kind, payload) in sorted(outcomes.items()):
            w = self.workers[i]
            tnow = self.clock()
            if kind == "ok":
                for rr in payload.results:
                    self._fold_result(rr, i, tnow)
                w.served += len(payload.results)
                # fold the engine's migration ledger into the fleet's
                # (getattr: stub engines in tests return bare namespaces)
                stats.migrated += getattr(payload, "restored_requests", 0)
                stats.migrated_tokens += getattr(payload, "restored_tokens", 0)
                stats.bytes_moved += getattr(payload, "restore_bytes", 0)
                stats.checkpoints_saved += getattr(
                    payload, "checkpoints_saved", 0)
                stats.checkpoint_bytes += getattr(
                    payload, "checkpoint_bytes", 0)
                stats.checksum_failures += getattr(
                    payload, "checksum_failures", 0)
                # a worker that returned cleanly is demonstrably responsive:
                # refresh its lease (a detached straggler's lease lapsed,
                # and it must not self-crash on its next dispatch)
                self.store.put(w.lease_key, {"worker": w.index},
                               ttl=self.config.lease_ttl_s)
            else:
                crash: WorkerCrash = payload
                drained = crash.reason == "drain"
                w.alive = False
                if drained:
                    stats.drains += 1
                else:
                    w.deaths += 1
                    stats.deaths += 1
                for rr in crash.results:
                    self._fold_result(rr, i, tnow)
                w.served += len(crash.results)
                orphans = [self._by_id[r.request_id] for r in crash.pending]
                orphans = [t for t in orphans if not t.terminal]
                # harvest the dead worker's checkpoints: orphans with a
                # snapshot migrate (O(bytes) restore on a survivor); the
                # rest replay from their prompts — that recompute debt is
                # exactly their prompt tokens
                migrated_here = 0
                recompute_here = 0
                for t in orphans:
                    rid = t.req.request_id
                    snap = (w.checkpoints.pop(rid, None)
                            if self.config.recovery == "migrate" else None)
                    if snap is not None:
                        self._migrations[rid] = snap
                        migrated_here += 1
                    else:
                        recompute_here += len(t.req.prompt)
                stats.recomputed_prefill_tokens += recompute_here
                if self.tracer is not None:
                    self.tracer.event(
                        "fleet:drain" if drained else "fleet:death",
                        tnow, tnow, worker=i,
                        reason=crash.reason, step=crash.step,
                        requeued=len(orphans), migrating=migrated_here,
                        recompute_tokens=recompute_here,
                    )
                n = self._requeue(orphans, tnow)
                stats.requeued += n
                if orphans:
                    self._deaths_open.append({
                        "t": tnow, "worker": i,
                        "rids": {t.req.request_id for t in orphans},
                    })

    def _settle_recoveries(self, stats: FleetStats) -> None:
        tnow = self.clock()
        for d in list(self._deaths_open):
            if all(self._by_id[rid].terminal for rid in d["rids"]):
                stats.recovery_s.append(tnow - d["t"])
                self._deaths_open.remove(d)
                if self.tracer is not None:
                    self.tracer.event(
                        "fleet:recovered", d["t"], tnow,
                        worker=d["worker"], orphans=len(d["rids"]),
                    )

    # -- round execution -----------------------------------------------------
    def _run_round(self, assignment: Dict[int, List[_Tracked]],
                   stats: FleetStats) -> Dict[int, Tuple[str, Any]]:
        """Run one round of worker batches.

        Sequential mode (default) runs workers in index order — fully
        deterministic, same commits and tokens as any interleaving since
        workers share nothing.  Parallel mode runs them in threads and
        (with ``hedge=True``) monitors leases: a worker whose lease expires
        mid-run is detached — its uncommitted assignment is requeued
        immediately (duplicate dispatch) and its thread keeps running into
        later rounds; whatever it eventually returns dedupes at commit.
        """
        outcomes: Dict[int, Tuple[str, Any]] = {}
        workers = {w.index: w for w in self.workers}
        if not self.config.parallel:
            for i in sorted(assignment):
                outcomes[i] = self._run_worker(workers[i], assignment[i])
            return outcomes
        holders: Dict[int, Dict[str, Any]] = {}
        for i, batch in assignment.items():
            holder: Dict[str, Any] = {"batch": batch, "outcome": None, "error": None}

            def run(i=i, holder=holder) -> None:
                try:
                    out = self._run_worker(workers[i], holder["batch"])
                except BaseException as e:   # not a WorkerCrash: _run_worker returns those
                    with self._lock:
                        holder["error"] = e
                    return
                with self._lock:
                    holder["outcome"] = out

            th = threading.Thread(target=run, daemon=True)
            holder["thread"] = th
            holders[i] = holder
            th.start()
        poll = max(self.config.lease_ttl_s / 8.0, 1e-3)
        detached: set = set()
        while True:
            waiting = [i for i in holders if i not in detached]
            with self._lock:
                failed = [holders[i]["error"] for i in waiting
                          if holders[i]["error"] is not None]
                pending = [i for i in waiting
                           if holders[i]["outcome"] is None
                           and holders[i]["error"] is None]
            if failed:
                self._reraise(failed[0], holders)
            if not pending:
                break
            if self.config.hedge:
                now = self.clock()
                for i in pending:
                    if self.store.get(workers[i].lease_key) is None:
                        # straggler: lease lapsed mid-run — detach it and
                        # re-dispatch its uncommitted work right now; its
                        # eventual results dedupe at commit
                        detached.add(i)
                        orphans = [t for t in holders[i]["batch"]
                                   if not t.terminal]
                        n = self._requeue(orphans, now)
                        stats.hedged += n
                        self._inflight[i] = holders[i]
                        if self.tracer is not None:
                            self.tracer.event(
                                "fleet:hedge", now, now, worker=i,
                                requests=n,
                            )
                pending = [i for i in pending if i not in detached]
                if not pending:
                    break
            holders[pending[0]]["thread"].join(timeout=poll)
        with self._lock:
            return {i: holders[i]["outcome"] for i in holders
                    if i not in detached and holders[i]["outcome"] is not None}

    @staticmethod
    def _reraise(error: BaseException, holders: Dict[int, Dict[str, Any]]) -> None:
        """Re-raise a worker thread's exception (other than a crash) once
        every thread in ``holders`` has ended, so that no worker still runs
        on the card when :meth:`serve` raises."""
        for holder in holders.values():
            holder["thread"].join()
        raise error

    def _collect_stragglers(self, block: bool) -> Dict[int, Tuple[str, Any]]:
        """Harvest detached stragglers' outcomes; with ``block=True`` wait
        for every one of them (end-of-run drain)."""
        out: Dict[int, Tuple[str, Any]] = {}
        for i, holder in list(self._inflight.items()):
            if block:
                holder["thread"].join()
            with self._lock:
                done, error = holder["outcome"], holder["error"]
            if error is not None:
                self._reraise(error, self._inflight)
            if done is not None:
                out[i] = done
                del self._inflight[i]
        return out
