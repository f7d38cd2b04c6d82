"""Continuous-batching request scheduler (the shared serving hot path).

Every benchmarking scenario and the serving engine issue work through one
asynchronous :class:`RequestScheduler`: a bounded request queue with
dynamic micro-batching (coalesce up to ``max_batch`` requests that arrive
within a ``batch_timeout_ms`` admission window) and per-request completion
futures.  This is the layer the paper's cloud-serving scenarios exercise —
queueing, batching and admission effects all happen here, not inside the
model executor.

Dequeue order is SLO- and tenant-aware rather than strictly FIFO: every
request carries a ``tenant``/``priority``/``slo_ms`` triple, tenants are
rate-limited by token buckets (refill rate + burst, charged in
prompt+decode tokens), and batch formation picks work by priority tier
first, then weighted fair share across tenants (start-time virtual
clocks), then arrival order.  Selection is *work-conserving*: a tenant
that has drained its bucket is deprioritized, never starved, so the
scheduler keeps serving when only over-budget work is queued.  Requests
whose SLO is already unmeetable (estimated from queue depth and the
measured batch service rate) are shed with a terminal ``rejected`` status
instead of wasting capacity — every request still reaches exactly one
terminal status.  With a single default tenant the policy degenerates to
the original FIFO order, byte for byte.

Two drive modes share the same batch-formation logic:

* **synchronous** (no worker thread) — ``step()`` / ``run_until_idle()``
  form and execute micro-batches inline.  With an injected fake
  ``clock``/``sleep`` pair this is a deterministic discrete-event
  simulation of the server (requests may be pre-submitted with future
  ``arrival_s`` values); with real time it is a single-threaded server
  loop.  ``CompletionFuture.result()`` drives the scheduler until that
  request completes, so closed-loop scenarios need no thread.
* **threaded** — ``start()`` spawns a worker that coalesces concurrently
  submitted requests under a condition variable; ``batch_timeout_ms``
  bounds how long a non-full batch waits for stragglers.

The scheduler also owns the *slot* bookkeeping for continuous batching
(:class:`SlotPool`): a fixed pool of KV-cache slots where finished
sequences free their slot and queued prompts are admitted at decode-step
boundaries (used by ``repro_torch.serve.engine.ServingEngine.serve_continuous``).

This module is the port's copy of ``repro.serve.scheduler``, whole: it is
pure Python, and the port keeps its own copy so that it never imports
``repro``.  The platform's scenarios drive it synchronously on an injected
clock; the static engine's driver (``repro_torch.launch.serve``) runs it
threaded on ``time.perf_counter``.
"""
from __future__ import annotations

import bisect
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "CompletionFuture",
    "DeadlineExceeded",
    "PRIORITY_TIERS",
    "PagedSlotPool",
    "PrefillBudget",
    "RequestScheduler",
    "RetriesExhausted",
    "ScheduledRequest",
    "SchedulerConfig",
    "SchedulerQueueFull",
    "SlotPool",
    "SpecLedger",
    "TenantLedger",
    "TenantSpec",
    "TokenBucket",
    "backoff_delay",
]

# priority tiers, lowest first: tier 0 is shed first and preempted first
PRIORITY_TIERS = ("best_effort", "standard", "premium")


class SchedulerQueueFull(RuntimeError):
    """Raised when a non-blocking submit finds the bounded queue full."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed before it could execute (its completion
    future raises this — a deadlined request is terminal, never silent)."""


class RetriesExhausted(RuntimeError):
    """A request failed and its retry budget is spent; carries the last
    underlying error as ``__cause__``."""


def backoff_delay(attempt: int, base_s: float, cap_s: float,
                  jitter: float = 0.0,
                  rng: Optional[random.Random] = None) -> float:
    """Capped exponential backoff: ``min(cap, base * 2**(attempt-1))``,
    optionally scaled by a symmetric ``±jitter`` fraction drawn from ``rng``
    (a seeded :class:`random.Random` keeps retry schedules deterministic).
    Shared by the scheduler retry path, the fleet requeue path and the
    server's re-dispatch loop."""
    if attempt < 1:
        raise ValueError("attempt must be >= 1")
    d = min(cap_s, base_s * (2.0 ** (attempt - 1)))
    if jitter > 0.0 and rng is not None:
        d *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
    return max(d, 0.0)


@dataclass
class TenantSpec:
    """One tenant's contract: priority tier, fair-share weight, and an
    optional token-bucket rate limit (charged in prompt+decode tokens).

    ``burst_tokens`` is the bucket capacity; 0 defaults to one second of
    refill.  ``slo_ms`` is the tenant's default latency SLO, applied to
    submissions that do not override it.
    """

    name: str
    priority: int = 1                 # index into PRIORITY_TIERS (higher wins)
    weight: float = 1.0               # fair-share weight within the tier
    rate_tokens_per_s: float = 0.0    # bucket refill rate (0 = unlimited)
    burst_tokens: float = 0.0         # bucket capacity (0 = 1s of refill)
    slo_ms: float = 0.0               # default per-request SLO (0 = none)

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError("tenant weight must be > 0")
        if self.priority < 0:
            raise ValueError("tenant priority must be >= 0")
        if self.rate_tokens_per_s < 0 or self.burst_tokens < 0:
            raise ValueError("tenant rate/burst must be >= 0")

    @property
    def tier(self) -> str:
        return PRIORITY_TIERS[min(self.priority, len(PRIORITY_TIERS) - 1)]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "priority": self.priority,
            "weight": self.weight,
            "rate_tokens_per_s": self.rate_tokens_per_s,
            "burst_tokens": self.burst_tokens,
            "slo_ms": self.slo_ms,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TenantSpec":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


class TokenBucket:
    """Classic token bucket, driven by caller-supplied clock readings so an
    injected fake clock yields deterministic admission decisions.

    Charges clamp at zero (leaky, work-conserving): a tenant served while
    over budget does not accumulate unbounded debt, it just stays *dry*
    (``available < cost``) until the refill catches up with its demand.
    """

    def __init__(self, rate_per_s: float, burst: float) -> None:
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("token bucket needs rate > 0 and burst > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last: Optional[float] = None
        self.charged_total = 0.0

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last:
            self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now if self._last is None else max(self._last, now)

    def available(self, now: float) -> float:
        self._refill(now)
        return self.tokens

    def dry(self, cost: float, now: float) -> bool:
        return self.available(now) < cost

    def charge(self, cost: float, now: float) -> None:
        """Deduct ``cost`` tokens (floored at zero — see class docstring)."""
        self._refill(now)
        self.tokens = max(0.0, self.tokens - cost)
        self.charged_total += cost

    def time_until(self, cost: float, now: float) -> float:
        """Seconds until ``cost`` tokens will be available (0 if already)."""
        have = self.available(now)
        if have >= cost:
            return 0.0
        return (min(cost, self.burst) - have) / self.rate


class TenantLedger:
    """Per-tenant admission state: token buckets, fair-share virtual
    clocks, and the shed/defer audit counters.

    Fair dequeue is start-time weighted fair queuing: each admission
    advances the tenant's virtual time by ``cost/weight``; the scheduler
    picks the queued request with the smallest ``(dry, -priority, vtime)``
    key, so rate limits bind first, then tiers, then fair share.  A tenant
    returning from idle resumes at the ledger's current virtual time — no
    banked backlog advantage.
    """

    def __init__(self, specs: Sequence[TenantSpec] = ()) -> None:
        self.specs: Dict[str, TenantSpec] = {}
        self.buckets: Dict[str, TokenBucket] = {}
        self.vtime: Dict[str, float] = {}
        self.admitted: Dict[str, int] = {}
        self.tokens_admitted: Dict[str, float] = {}
        self.shed: Dict[str, int] = {}
        self.deferred: Dict[str, int] = {}
        self._vnow = 0.0
        for spec in specs:
            self.register(spec)

    def register(self, spec: TenantSpec) -> TenantSpec:
        self.specs[spec.name] = spec
        if spec.rate_tokens_per_s > 0:
            burst = spec.burst_tokens or spec.rate_tokens_per_s
            self.buckets[spec.name] = TokenBucket(spec.rate_tokens_per_s, burst)
        for ledger in (self.admitted, self.shed, self.deferred):
            ledger.setdefault(spec.name, 0)
        self.tokens_admitted.setdefault(spec.name, 0.0)
        self.vtime.setdefault(spec.name, self._vnow)
        return spec

    def spec_of(self, name: str) -> TenantSpec:
        """The tenant's spec, auto-registering an unlimited default one."""
        spec = self.specs.get(name)
        if spec is None:
            spec = self.register(TenantSpec(name=name))
        return spec

    def dry(self, name: str, cost: float, now: float) -> bool:
        bucket = self.buckets.get(name)
        return bucket is not None and bucket.dry(cost, now)

    def refill_in(self, name: str, cost: float, now: float) -> float:
        bucket = self.buckets.get(name)
        return 0.0 if bucket is None else bucket.time_until(cost, now)

    def on_admit(self, name: str, cost: float, now: float) -> None:
        """Charge the bucket and advance the fair-share virtual clock."""
        spec = self.spec_of(name)
        bucket = self.buckets.get(name)
        if bucket is not None:
            bucket.charge(cost, now)
        base = max(self.vtime.get(name, 0.0), self._vnow)
        self.vtime[name] = base + cost / spec.weight
        self._vnow = base
        self.admitted[name] = self.admitted.get(name, 0) + 1
        self.tokens_admitted[name] = self.tokens_admitted.get(name, 0.0) + cost

    def note_shed(self, name: str) -> None:
        self.spec_of(name)
        self.shed[name] = self.shed.get(name, 0) + 1

    def note_defer(self, name: str) -> None:
        self.spec_of(name)
        self.deferred[name] = self.deferred.get(name, 0) + 1

    def stats(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, spec in self.specs.items():
            bucket = self.buckets.get(name)
            out[name] = {
                "priority": float(spec.priority),
                "weight": float(spec.weight),
                "admitted": float(self.admitted.get(name, 0)),
                "tokens_admitted": float(self.tokens_admitted.get(name, 0.0)),
                "shed": float(self.shed.get(name, 0)),
                "deferred": float(self.deferred.get(name, 0)),
                "bucket_charged": bucket.charged_total if bucket else 0.0,
            }
        return out


@dataclass
class SchedulerConfig:
    """Knobs for the request scheduler (part of the user input; the server
    threads this through dispatch so an evaluation can select the
    scheduler-backed executor)."""

    max_batch: int = 8             # micro-batch coalescing limit (requests)
    batch_timeout_ms: float = 2.0  # admission window for a non-full batch
    queue_depth: int = 1024        # bounded queue (admission control)
    num_slots: int = 8             # KV slots for continuous batching
    page_size: int = 16            # tokens per KV page (paged engine)
    num_pages: int = 0             # global KV page pool size (0 = engine default)
    prefill_chunk: int = 0         # chunked-prefill tokens per step (0 = default)
    prefill_budget: int = 0        # packed-prefill tokens per boundary (0 = default)
    spec_k: int = 0                # speculative draft depth (0 = disabled)
    spec_ngram: int = 3            # prompt-lookup n-gram match length
    prefix_cache: bool = False     # automatic prefix caching (paged engine)
    deadline_ms: float = 0.0       # per-request TTL (0 = no deadline)
    max_retries: int = 0           # batch-failure retry budget per request
    backoff_base_ms: float = 10.0  # retry backoff: base delay
    backoff_cap_ms: float = 1000.0 # retry backoff: cap
    backoff_jitter: float = 0.0    # retry backoff: ±fraction (0 = none)
    retry_seed: int = 0            # jitter RNG seed (determinism)
    fairness: bool = True          # tier + weighted-fair dequeue (off = FIFO)
    slo_shed: bool = True          # shed work whose SLO is already unmeetable

    def to_dict(self) -> Dict[str, Any]:
        return {
            "max_batch": self.max_batch,
            "batch_timeout_ms": self.batch_timeout_ms,
            "queue_depth": self.queue_depth,
            "num_slots": self.num_slots,
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "prefill_chunk": self.prefill_chunk,
            "prefill_budget": self.prefill_budget,
            "spec_k": self.spec_k,
            "spec_ngram": self.spec_ngram,
            "prefix_cache": self.prefix_cache,
            "deadline_ms": self.deadline_ms,
            "max_retries": self.max_retries,
            "backoff_base_ms": self.backoff_base_ms,
            "backoff_cap_ms": self.backoff_cap_ms,
            "backoff_jitter": self.backoff_jitter,
            "retry_seed": self.retry_seed,
            "fairness": self.fairness,
            "slo_shed": self.slo_shed,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SchedulerConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


@dataclass
class ScheduledRequest:
    """One unit of scheduled work plus its measured lifecycle times.

    All times are in scheduler-clock units (``clock()`` values), so an
    injected fake clock yields fully deterministic latencies.
    """

    request_id: int
    batch_size: int = 1
    arrival_s: float = 0.0      # when the request enters the system
    payload: Any = None
    submit_s: float = 0.0       # when submit() was called
    start_s: float = 0.0        # micro-batch execution start
    end_s: float = 0.0          # micro-batch execution end
    deadline_s: Optional[float] = None  # absolute clock deadline (TTL)
    attempts: int = 0           # failed executions so far (retry ledger)
    status: str = "queued"      # queued | completed | failed | rejected
    tenant: str = "default"     # owning tenant (fairness + rate limiting)
    priority: int = 1           # tier (index into PRIORITY_TIERS)
    slo_ms: float = 0.0         # latency SLO for goodput (0 = none)
    cost_tokens: float = 1.0    # bucket charge (prompt+decode tokens)
    future: "CompletionFuture" = None  # type: ignore[assignment]

    @property
    def queue_s(self) -> float:
        return max(0.0, self.start_s - self.arrival_s)

    @property
    def service_s(self) -> float:
        return self.end_s - self.start_s

    @property
    def latency_s(self) -> float:
        """End-to-end latency including queueing delay."""
        return self.end_s - self.arrival_s


class CompletionFuture:
    """Per-request completion handle.

    In threaded mode ``result()`` blocks on an event; in synchronous mode it
    drives the scheduler until this request's micro-batch has executed.
    """

    __slots__ = ("request", "_scheduler", "_event", "_value", "_error", "_done")

    def __init__(self, scheduler: "RequestScheduler", request: ScheduledRequest):
        self.request = request
        self._scheduler = scheduler
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = False

    def done(self) -> bool:
        return self._done

    def _set(self, value: Any = None, error: Optional[BaseException] = None) -> None:
        self._value = value
        self._error = error
        self._done = True
        self._event.set()
        # a done future needs no scheduler: dropping it breaks the chain
        # future <-> request -> scheduler -> execute, which would otherwise
        # keep whatever ``execute`` closes over (an engine and its weights)
        # alive until the cycle collector runs
        self._scheduler = None

    def result(self, timeout: Optional[float] = None) -> Any:
        sched = self._scheduler  # None once done (_set clears it after _done)
        if sched is not None and not self._done:
            if sched.running:
                if not self._event.wait(timeout):
                    raise TimeoutError(
                        f"request {self.request.request_id} not done in {timeout}s"
                    )
            else:
                sched._drive_until(self)
        if self._error is not None:
            raise self._error
        return self._value


class RequestScheduler:
    """Bounded-queue, micro-batching request scheduler.

    ``execute`` runs one coalesced micro-batch: it receives the list of
    :class:`ScheduledRequest` and returns either one result per request, or
    a single value shared by all of them (or ``None``).
    """

    def __init__(
        self,
        execute: Callable[[List[ScheduledRequest]], Any],
        config: Optional[SchedulerConfig] = None,
        *,
        clock: Callable[[], float] = time.perf_counter,
        sleep: Callable[[float], None] = time.sleep,
        tracer=None,
        tenants: Sequence[TenantSpec] = (),
    ) -> None:
        self.execute = execute
        self.config = config or SchedulerConfig()
        if self.config.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.config.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.clock = clock
        self.sleep = sleep
        self.tracer = tracer
        self._cond = threading.Condition()
        # pending requests sorted by (arrival_s, request_id): FIFO within
        # identical arrivals, earliest-arrival-first otherwise
        self._queue: List[ScheduledRequest] = []
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self.running = False
        # stats series: (time, value) samples recorded at each batch execution
        self.queue_depth_series: List[tuple] = []
        self.batch_occupancy_series: List[tuple] = []
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.batches = 0
        self.retries = 0            # re-enqueues after a failed batch
        self.deadline_failures = 0  # requests terminal via DeadlineExceeded
        self.retry_failures = 0     # requests terminal via RetriesExhausted
        # graceful degradation: the router flips this at its top degrade
        # level so NEW admissions are shed with an explicit rejected status
        # (already-queued work still drains)
        self.shedding = False
        self._retry_rng = random.Random(self.config.retry_seed)
        # tenant-aware admission: buckets, fair-share clocks, audit counters
        self.ledger = TenantLedger(tenants)
        self.shed = 0        # requests terminal via SLO-unmeetable admission
        self.deferred = 0    # tenant-boundary deferrals (bucket ran dry)
        self._service_ewma = 0.0  # measured per-batch service time (s)

    # -- submission ----------------------------------------------------------
    def submit(
        self,
        payload: Any = None,
        batch_size: int = 1,
        arrival_s: Optional[float] = None,
        block: bool = True,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
        priority: Optional[int] = None,
        slo_ms: Optional[float] = None,
        cost_tokens: Optional[float] = None,
    ) -> CompletionFuture:
        """Enqueue one request; returns its completion future.

        ``arrival_s`` is an absolute scheduler-clock time; pre-submitting
        future arrivals turns the synchronous drive into a discrete-event
        simulation.  With ``block=False`` a full queue (counting only
        requests whose arrival has passed) raises :class:`SchedulerQueueFull`
        — the admission-control path.  ``deadline_s`` is an absolute clock
        deadline (defaults to ``arrival + config.deadline_ms`` when the
        config sets one); a request still queued past its deadline fails
        with :class:`DeadlineExceeded` instead of executing.

        ``tenant``/``priority``/``slo_ms`` place the request in the
        fairness policy (defaults come from the tenant's registered
        :class:`TenantSpec`); ``cost_tokens`` is the token-bucket charge —
        prompt + expected decode tokens — defaulting to ``batch_size``.
        """
        with self._cond:
            if self.shedding:
                self.rejected += 1
                raise SchedulerQueueFull(
                    "admission shed: scheduler is in degraded (shedding) mode"
                )
            if self._arrived_depth(self.clock()) >= self.config.queue_depth:
                if not block:
                    self.rejected += 1
                    raise SchedulerQueueFull(
                        f"queue depth {self.config.queue_depth} exceeded"
                    )
                if self.running:
                    while self._arrived_depth(self.clock()) >= self.config.queue_depth:
                        self._cond.wait()
            now = self.clock()
            arrival = now if arrival_s is None else arrival_s
            if deadline_s is None and self.config.deadline_ms > 0:
                deadline_s = arrival + self.config.deadline_ms / 1e3
            spec = self.ledger.spec_of(tenant)
            req = ScheduledRequest(
                request_id=self._next_id,
                batch_size=batch_size,
                arrival_s=arrival,
                payload=payload,
                submit_s=now,
                deadline_s=deadline_s,
                tenant=tenant,
                priority=spec.priority if priority is None else priority,
                slo_ms=spec.slo_ms if slo_ms is None else slo_ms,
                cost_tokens=float(batch_size) if cost_tokens is None
                else float(cost_tokens),
            )
            self._next_id += 1
            req.future = CompletionFuture(self, req)
            bisect.insort(self._queue, req, key=lambda r: (r.arrival_s, r.request_id))
            self.submitted += 1
            self._cond.notify_all()
        return req.future

    def _arrived_depth(self, now: float) -> int:
        """Queued requests whose arrival time has passed (the *real* queue);
        pre-submitted future arrivals are not yet in the system."""
        return bisect.bisect_right(self._queue, (now, float("inf")),
                                   key=lambda r: (r.arrival_s, r.request_id))

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- synchronous drive ---------------------------------------------------
    def step(self) -> int:
        """Form and execute one micro-batch; returns the number of requests
        served (0 when the queue is empty).  Sleeps (via the injected
        ``sleep``) to the next arrival when nothing has arrived yet."""
        batch = self._form_batch_sync()
        if not batch:
            return 0
        self._run_batch(batch)
        return len(batch)

    def run_until_idle(self) -> int:
        """Drain the queue completely; returns total requests served."""
        served = 0
        while True:
            n = self.step()
            if n == 0:
                return served
            served += n

    def _drive_until(self, future: CompletionFuture) -> None:
        while not future.done():
            if self.step() == 0:
                raise RuntimeError(
                    f"request {future.request.request_id} unreachable: queue idle"
                )

    # -- tenant-aware selection ---------------------------------------------
    def _policy_key(self, req: ScheduledRequest, now: float) -> tuple:
        """Dequeue order: rate limits bind first (dry tenants sink), then
        priority tier, then weighted fair share, then arrival order."""
        dry = 1 if self.ledger.dry(req.tenant, req.cost_tokens, now) else 0
        return (dry, -req.priority, self.ledger.vtime.get(req.tenant, 0.0),
                req.arrival_s, req.request_id)

    def _pop_policy(self, now: float) -> Optional[ScheduledRequest]:
        """Pop the next arrived request under the fairness policy (caller
        holds the lock).  Work-conserving: when every arrived tenant is
        dry, the best-ranked request is still served."""
        n = self._arrived_depth(now)
        if n == 0:
            return None
        if n == 1 or not self.config.fairness:
            idx = 0
        else:
            idx = min(range(n),
                      key=lambda i: self._policy_key(self._queue[i], now))
        req = self._queue.pop(idx)
        self.ledger.on_admit(req.tenant, req.cost_tokens, now)
        return req

    def _shed_sweep(self, now: float) -> None:
        """Shed arrived requests whose SLO is already unmeetable, estimated
        from queue position and the measured batch service time (caller
        holds the lock).  Terminal ``rejected`` status — never silent."""
        if not self.config.slo_shed or self.batches == 0:
            return
        est = self._service_ewma
        if est <= 0.0:
            return
        idxs = list(range(self._arrived_depth(now)))
        if self.config.fairness:
            # service order is the POLICY order, not arrival order: a
            # high-priority or under-budget tenant deep in the arrival
            # queue will be served early and must not be shed for the
            # backlog in front of it (stable sort: untagged queues keep
            # their arrival ranks exactly)
            idxs.sort(key=lambda i: self._policy_key(self._queue[i], now))
        doomed: List[ScheduledRequest] = []
        for rank, i in enumerate(idxs):
            req = self._queue[i]
            if req.slo_ms <= 0:
                continue
            # rank/max_batch batches ahead of this request, plus its own
            est_finish = now + est * (1.0 + rank / self.config.max_batch)
            if est_finish > req.arrival_s + req.slo_ms / 1e3:
                doomed.append(req)
        for req in doomed:
            self._queue.remove(req)
            req.start_s = req.end_s = now
            req.status = "rejected"
            self.shed += 1
            self.ledger.note_shed(req.tenant)
            req.future._set(None, DeadlineExceeded(
                f"request {req.request_id} shed at admission: "
                f"{req.slo_ms:.0f}ms SLO unmeetable"
            ))
            self._emit_tenant(req)

    def _note_defers(self, now: float) -> None:
        """Count tenants whose arrived work was passed over because their
        bucket ran dry — one deferral per tenant per batch formation."""
        if not self.config.fairness:
            return
        seen: set = set()
        for i in range(self._arrived_depth(now)):
            req = self._queue[i]
            if req.tenant in seen:
                continue
            if self.ledger.dry(req.tenant, req.cost_tokens, now):
                seen.add(req.tenant)
                self.ledger.note_defer(req.tenant)
                self.deferred += 1
                if self.tracer is not None:
                    self.tracer.event("sched:defer", now, now,
                                      tenant=req.tenant)

    def _emit_tenant(self, req: ScheduledRequest) -> None:
        """Publish one ``sched:tenant`` event per terminal request."""
        if self.tracer is None:
            return
        latency = max(0.0, req.end_s - req.arrival_s)
        slo_ok = (req.status == "completed"
                  and (req.slo_ms <= 0 or latency * 1e3 <= req.slo_ms))
        self.tracer.event(
            "sched:tenant",
            req.start_s,
            req.end_s,
            tenant=req.tenant,
            priority=req.priority,
            status=req.status,
            latency_s=latency,
            slo_ms=req.slo_ms,
            slo_ok=slo_ok,
            tokens=req.cost_tokens,
        )

    def _form_batch_sync(self) -> List[ScheduledRequest]:
        timeout_s = self.config.batch_timeout_ms / 1e3
        while True:
            with self._cond:
                if not self._queue:
                    return []
                first = self._queue[0]
            now = self.clock()
            if first.arrival_s > now:
                self.sleep(first.arrival_s - now)
                now = self.clock()
            deadline = now + timeout_s
            batch: List[ScheduledRequest] = []
            with self._cond:
                self._shed_sweep(now)
                while len(batch) < self.config.max_batch:
                    req = self._pop_policy(now)
                    if req is not None:
                        batch.append(req)
                        continue
                    if not batch or not self._queue:
                        break
                    nxt = self._queue[0]
                    if timeout_s > 0 and nxt.arrival_s <= deadline:
                        # hold the batch open until the straggler arrives
                        self.sleep(nxt.arrival_s - now)
                        now = self.clock()
                    else:
                        break
                self._note_defers(now)
                self._cond.notify_all()
                if batch or not self._queue:
                    return batch
            # everything arrived was shed; loop on to the next arrival

    # -- threaded drive ------------------------------------------------------
    def start(self) -> "RequestScheduler":
        if self._thread is not None:
            return self
        self.running = True
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self, wait: bool = True) -> None:
        with self._cond:
            self.running = False
            self._cond.notify_all()
        if self._thread is not None and wait:
            self._thread.join()
            self._thread = None

    def _pop_threaded(self) -> ScheduledRequest:
        """Policy pop for the worker thread: prefer the fairness ranking
        over arrived requests, fall back to the queue head (caller holds
        the lock and has checked the queue is non-empty)."""
        req = self._pop_policy(self.clock())
        if req is None:
            req = self._queue.pop(0)
            self.ledger.on_admit(req.tenant, req.cost_tokens, self.clock())
        return req

    def _worker(self) -> None:
        timeout_s = self.config.batch_timeout_ms / 1e3
        while True:
            batch: List[ScheduledRequest] = []
            with self._cond:
                while self.running and not self._queue:
                    self._cond.wait()
                if not self.running and not self._queue:
                    return
                batch.append(self._pop_threaded())
                deadline = time.monotonic() + timeout_s
                while len(batch) < self.config.max_batch:
                    if self._queue:
                        batch.append(self._pop_threaded())
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self.running:
                        break
                    self._cond.wait(remaining)
                    if not self._queue and time.monotonic() >= deadline:
                        break
                self._cond.notify_all()
            self._run_batch(batch)

    # -- execution -----------------------------------------------------------
    def _run_batch(self, batch: List[ScheduledRequest]) -> None:
        start = self.clock()
        with self._cond:
            depth = self._arrived_depth(start)
        # deadline enforcement BEFORE execution: a request whose TTL passed
        # while queued is terminal (DeadlineExceeded), never silently run
        # late and never left hanging
        live: List[ScheduledRequest] = []
        for req in batch:
            if req.deadline_s is not None and start > req.deadline_s:
                req.start_s = req.end_s = start
                req.status = "failed"
                self.deadline_failures += 1
                req.future._set(None, DeadlineExceeded(
                    f"request {req.request_id} missed deadline "
                    f"({start - req.deadline_s:.3f}s late)"
                ))
                self._emit_tenant(req)
            else:
                live.append(req)
        error: Optional[BaseException] = None
        out: Any = None
        if live:
            try:
                out = self.execute(live)
            except BaseException as e:  # noqa: BLE001 - propagated via futures
                error = e
        end = self.clock()
        terminal = len(batch) - len(live)
        if error is not None and self.config.max_retries > 0:
            # failed batch with a retry budget: re-enqueue what still has
            # budget (capped exponential backoff + jitter pushes the retry
            # arrival into the future), fail the rest terminally
            retried: List[ScheduledRequest] = []
            for req in live:
                req.attempts += 1
                if req.attempts <= self.config.max_retries:
                    delay = backoff_delay(
                        req.attempts,
                        self.config.backoff_base_ms / 1e3,
                        self.config.backoff_cap_ms / 1e3,
                        self.config.backoff_jitter,
                        self._retry_rng,
                    )
                    req.arrival_s = end + delay
                    retried.append(req)
                    self.retries += 1
                else:
                    req.start_s, req.end_s = start, end
                    req.status = "failed"
                    self.retry_failures += 1
                    terminal += 1
                    exhausted = RetriesExhausted(
                        f"request {req.request_id} failed after "
                        f"{req.attempts} attempt(s): {error}"
                    )
                    exhausted.__cause__ = error
                    req.future._set(None, exhausted)
                    self._emit_tenant(req)
            if retried:
                with self._cond:
                    for req in retried:
                        bisect.insort(
                            self._queue, req,
                            key=lambda r: (r.arrival_s, r.request_id),
                        )
                    self._cond.notify_all()
        else:
            results: Sequence[Any]
            if isinstance(out, (list, tuple)) and len(out) == len(live):
                results = out
            else:
                results = [out] * len(live)
            for req, value in zip(live, results):
                req.start_s = start
                req.end_s = end
                req.status = "failed" if error is not None else "completed"
                req.future._set(value, error)
                self._emit_tenant(req)
            terminal += len(live)
        if live:
            # measured batch service time feeds the SLO-shed estimator
            dt = end - start
            self._service_ewma = (dt if self._service_ewma <= 0.0
                                  else 0.5 * dt + 0.5 * self._service_ewma)
        self.batches += 1
        self.completed += terminal
        self.queue_depth_series.append((start, depth))
        self.batch_occupancy_series.append((start, len(batch)))
        if self.tracer is not None:
            self.tracer.event(
                "scheduler:batch",
                start,
                end,
                occupancy=len(batch),
                queue_depth=depth,
                inputs=sum(r.batch_size for r in batch),
            )
        with self._cond:
            self._cond.notify_all()

    # -- reporting -----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Scalar summary of the queue/batching series (metrics block)."""
        occ = [v for _, v in self.batch_occupancy_series]
        dep = [v for _, v in self.queue_depth_series]
        return {
            "batches": float(self.batches),
            "submitted": float(self.submitted),
            "completed": float(self.completed),
            "rejected": float(self.rejected),
            "retries": float(self.retries),
            "deadline_failures": float(self.deadline_failures),
            "retry_failures": float(self.retry_failures),
            "shed": float(self.shed),
            "deferred": float(self.deferred),
            "mean_batch_occupancy": sum(occ) / len(occ) if occ else 0.0,
            "max_queue_depth": float(max(dep)) if dep else 0.0,
            "mean_queue_depth": sum(dep) / len(dep) if dep else 0.0,
        }


class SlotPool:
    """Fixed pool of KV-cache slots for continuous batching.

    Finished sequences release their slot; queued prompts are admitted into
    free slots at decode-step boundaries.  Pure bookkeeping — the engine owns
    the actual cache tensors — so admission order and slot reuse are testable
    without a model.
    """

    def __init__(self, num_slots: int) -> None:
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self._free: List[int] = list(range(num_slots - 1, -1, -1))  # pop() -> 0,1,..
        self.active: Dict[int, Any] = {}
        # admission log: (step, slot, request) — the slot-reuse audit trail
        self.admissions: List[tuple] = []

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return len(self.active)

    def admit(self, request: Any, step: int = 0) -> Optional[int]:
        """Assign a free slot to ``request``; None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.active[slot] = request
        self.admissions.append((step, slot, request))
        return slot

    def release(self, slot: int) -> Any:
        """Free a slot; returns the request that held it."""
        if slot not in self.active:
            raise KeyError(f"slot {slot} is not active")
        req = self.active.pop(slot)
        self._free.append(slot)
        return req


class PrefillBudget:
    """Per-boundary prefill-token ledger for the packed-prefill pipeline.

    The paged engine coalesces every admissible prompt chunk into one packed
    varlen launch per decode-step boundary; this ledger caps the *real*
    prompt tokens granted per boundary (``tokens_per_step``) so a burst of
    queued prompts cannot starve decoding slots — the knob that bounds
    decode latency under the server scenario.  Pure bookkeeping (testable
    without a model); the engine owns the packed buffer itself.
    """

    def __init__(self, tokens_per_step: int) -> None:
        if tokens_per_step < 1:
            raise ValueError("tokens_per_step must be >= 1")
        self.tokens_per_step = tokens_per_step
        self.steps = 0
        self.requested_total = 0
        self.granted_total = 0
        self.cached_total = 0
        self._remaining = 0
        # (step_index, granted_this_step) samples, one per begin_step window
        self.granted_series: List[tuple] = []

    @property
    def remaining(self) -> int:
        return self._remaining

    def begin_step(self) -> None:
        """Open a fresh per-boundary budget window."""
        self.steps += 1
        self._remaining = self.tokens_per_step
        self.granted_series.append((self.steps - 1, 0))

    def grant(self, tokens: int) -> int:
        """Grant up to ``tokens`` from this boundary's remaining budget."""
        if tokens < 0:
            raise ValueError("cannot request a negative token count")
        self.requested_total += tokens
        g = min(tokens, self._remaining)
        self._remaining -= g
        self.granted_total += g
        if self.granted_series:
            step, sofar = self.granted_series[-1]
            self.granted_series[-1] = (step, sofar + g)
        return g

    def defer(self, tokens: int) -> None:
        """Record demand that could NOT be served this boundary (prompt
        tokens left waiting once the budget/buffer filled) — the starvation
        signal ``stats()`` reports as ``starved_tokens``."""
        if tokens < 0:
            raise ValueError("cannot defer a negative token count")
        self.requested_total += tokens

    def credit(self, tokens: int) -> None:
        """Record prompt tokens served straight from the prefix cache: they
        enter the system but are ZERO-COST to the ledger — never requested,
        never granted, never starving anyone — so a cache-heavy boundary
        keeps its whole budget for the uncached suffixes."""
        if tokens < 0:
            raise ValueError("cannot credit a negative token count")
        self.cached_total += tokens

    def stats(self) -> Dict[str, float]:
        """Scalar summary: how saturated the per-boundary budget ran."""
        cap = self.steps * self.tokens_per_step
        return {
            "steps": float(self.steps),
            "tokens_per_step": float(self.tokens_per_step),
            "granted_tokens": float(self.granted_total),
            "requested_tokens": float(self.requested_total),
            "cached_tokens": float(self.cached_total),
            "budget_utilization": self.granted_total / cap if cap else 0.0,
            "starved_tokens": float(self.requested_total - self.granted_total),
        }


class SpecLedger:
    """Per-request draft accounting for speculative decoding.

    The paged engine's draft/verify/accept loop records, per request, how
    many draft tokens the prompt-lookup drafter proposed and how many the
    verification launch accepted — the acceptance rate is the whole story
    of whether speculation pays (accepted drafts are free tokens; rejected
    ones are wasted verify FLOPs).  Pure bookkeeping, testable without a
    model; the engine owns the draft/verify loop itself.
    """

    def __init__(self) -> None:
        self.proposed: Dict[int, int] = {}   # request_id -> drafts proposed
        self.accepted: Dict[int, int] = {}   # request_id -> drafts accepted
        self.launches = 0                    # verify launches (windows > 1)
        self.fallback_steps = 0              # boundaries with no drafts at all
        self.rollback_pages = 0              # pages freed by rejected suffixes

    def record(self, request_id: int, proposed: int, accepted: int) -> None:
        """Record one request's share of a verify launch."""
        if proposed < 0 or accepted < 0 or accepted > proposed:
            raise ValueError(
                f"invalid draft accounting: proposed={proposed} "
                f"accepted={accepted}"
            )
        self.proposed[request_id] = self.proposed.get(request_id, 0) + proposed
        self.accepted[request_id] = self.accepted.get(request_id, 0) + accepted

    def record_launch(self, speculative: bool) -> None:
        if speculative:
            self.launches += 1
        else:
            self.fallback_steps += 1

    def record_rollback(self, pages: int) -> None:
        """Pages handed back because a rejected draft had opened them."""
        if pages < 0:
            raise ValueError("cannot roll back a negative page count")
        self.rollback_pages += pages

    def of(self, request_id: int) -> tuple:
        """(proposed, accepted) for one request."""
        return (
            self.proposed.get(request_id, 0),
            self.accepted.get(request_id, 0),
        )

    def stats(self) -> Dict[str, float]:
        """Scalar summary of the draft economy over one run."""
        prop = float(sum(self.proposed.values()))
        acc = float(sum(self.accepted.values()))
        return {
            "spec_launches": float(self.launches),
            "fallback_steps": float(self.fallback_steps),
            "draft_proposed": prop,
            "draft_accepted": acc,
            "acceptance_rate": acc / prop if prop else 0.0,
            "rollback_pages": float(self.rollback_pages),
        }


class PagedSlotPool(SlotPool):
    """Slot pool whose admission is keyed on *free KV pages*, not free slots.

    A request is admitted only when a slot AND all the pages its prompt
    needs are available; releasing a slot returns its pages to the pool.
    The pool publishes ``pages:occupancy`` events (used/free/active) to the
    tracer so page pressure shows up in the analysis workflow next to the
    scheduler's queue-depth series.
    """

    def __init__(self, num_slots: int, pool, tracer=None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        super().__init__(num_slots)
        self.pool = pool
        self.tracer = tracer
        self.clock = clock
        self.preemptions = 0
        self.pages_in_use_series: List[tuple] = []  # (step, pages_in_use)

    def can_admit(self, npages: int) -> bool:
        return bool(self._free) and self.pool.num_free >= npages

    def admit_paged(self, request: Any, npages: int, step: int = 0):
        """Admit ``request`` with ``npages`` prompt pages; returns
        ``(slot, pages)`` or ``None`` when either resource is exhausted."""
        if not self.can_admit(npages):
            return None
        pages = self.pool.alloc(npages)
        if pages is None:  # pragma: no cover - guarded by can_admit
            return None
        slot = self.admit(request, step=step)
        return slot, pages

    def grow(self, n: int = 1):
        """Allocate ``n`` more pages for a decoding slot (page-boundary
        crossing); None signals the caller to preempt."""
        return self.pool.alloc(n)

    def release_paged(self, slot: int, pages: List[int],
                      preempted: bool = False) -> Any:
        """Free a slot and return its pages to the pool."""
        req = self.release(slot)
        if pages:
            self.pool.free(pages)
        if preempted:
            self.preemptions += 1
        return req

    def record_occupancy(self, step: int) -> None:
        """Sample page occupancy at a decode-step boundary."""
        self.pages_in_use_series.append((step, self.pool.num_in_use))
        if self.tracer is not None:
            now = self.clock()
            self.tracer.event(
                "pages:occupancy",
                now,
                now,
                step=step,
                pages_in_use=self.pool.num_in_use,
                pages_free=self.pool.num_free,
                # allocatable pages (reserved scratch excluded), so
                # pages_in_use / num_pages reaches 1.0 at saturation
                num_pages=self.pool.capacity,
                active_slots=self.num_active,
            )
