"""Request scheduling and slot bookkeeping of the serving engines.

:class:`RequestScheduler` is the FIFO threaded core of
``repro.serve.scheduler.RequestScheduler``: a bounded request queue, a
worker thread that coalesces up to ``max_batch`` requests arriving within
a ``batch_timeout_ms`` window into one micro-batch, and per-request
completion futures.  The static engine's driver runs ``generate`` behind
it.  What waits for the tenants/SLO work: tenants, token buckets and
priority tiers (the dequeue order here is arrival order), deadlines,
retries with backoff, SLO shedding, and the synchronous discrete-event
drive (``step``/``run_until_idle`` and the injectable clock it runs on;
here a future of a scheduler that is not running raises, and times are
``time.perf_counter()``) and the tracer events.

``SlotPool``, ``PrefillBudget``, ``SpecLedger`` and ``PagedSlotPool`` are
copies of the classes of the same names (their tracer argument stays
optional).  Everything is pure Python; the port keeps its own copy so that
it never imports ``repro``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "CompletionFuture",
    "PagedSlotPool",
    "PrefillBudget",
    "RequestScheduler",
    "ScheduledRequest",
    "SchedulerConfig",
    "SchedulerQueueFull",
    "SlotPool",
    "SpecLedger",
]


class SchedulerQueueFull(RuntimeError):
    """Admission control: the bounded request queue is full."""


@dataclass
class SchedulerConfig:
    """Knobs of the request scheduler."""

    max_batch: int = 8             # micro-batch coalescing limit (requests)
    batch_timeout_ms: float = 2.0  # admission window for a non-full batch
    queue_depth: int = 1024        # bounded queue (admission control)


@dataclass
class ScheduledRequest:
    """One unit of scheduled work plus its measured lifecycle times, all
    ``time.perf_counter()`` values."""

    request_id: int
    arrival_s: float = 0.0      # when submit() was called
    payload: Any = None
    start_s: float = 0.0        # micro-batch execution start
    end_s: float = 0.0          # micro-batch execution end
    status: str = "queued"      # queued | completed | failed
    future: "CompletionFuture" = None  # type: ignore[assignment]

    @property
    def latency_s(self) -> float:
        """End-to-end latency including queueing delay."""
        return self.end_s - self.arrival_s


class CompletionFuture:
    """Per-request completion handle: ``result()`` blocks until the worker
    has run the request's micro-batch."""

    __slots__ = ("request", "_scheduler", "_event", "_value", "_error", "_done")

    def __init__(self, scheduler: "RequestScheduler", request: ScheduledRequest):
        self.request = request
        self._scheduler = scheduler
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = False

    def _set(self, value: Any = None, error: Optional[BaseException] = None) -> None:
        self._value = value
        self._error = error
        self._done = True
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done:
            if not self._scheduler.running:
                raise RuntimeError(
                    f"request {self.request.request_id} is queued on a scheduler that "
                    f"is not running (start() it; the synchronous drive is not ported)"
                )
            if not self._event.wait(timeout):
                raise TimeoutError(
                    f"request {self.request.request_id} not done in {timeout}s"
                )
        if self._error is not None:
            raise self._error
        return self._value


class RequestScheduler:
    """Bounded-queue, micro-batching request scheduler (threaded, FIFO).

    ``execute`` runs one coalesced micro-batch: it receives the list of
    :class:`ScheduledRequest` and returns either one result per request, or
    a single value shared by all of them (or ``None``).  An exception
    fails every request of the batch through its future.
    """

    def __init__(
        self,
        execute: Callable[[List[ScheduledRequest]], Any],
        config: Optional[SchedulerConfig] = None,
    ) -> None:
        self.execute = execute
        self.config = config or SchedulerConfig()
        if self.config.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.config.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self._cond = threading.Condition()
        # pending requests in arrival order
        self._queue: List[ScheduledRequest] = []
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self.running = False
        # (time, value) samples recorded at each batch execution
        self.queue_depth_series: List[tuple] = []
        self.batch_occupancy_series: List[tuple] = []
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.batches = 0

    # -- submission ----------------------------------------------------------
    def submit(self, payload: Any = None, block: bool = True) -> CompletionFuture:
        """Enqueue one request; returns its completion future.  A full queue
        blocks the caller while the worker runs, or raises
        :class:`SchedulerQueueFull` with ``block=False``."""
        with self._cond:
            if len(self._queue) >= self.config.queue_depth:
                if not block:
                    self.rejected += 1
                    raise SchedulerQueueFull(
                        f"queue depth {self.config.queue_depth} exceeded"
                    )
                while self.running and len(self._queue) >= self.config.queue_depth:
                    self._cond.wait()
            req = ScheduledRequest(request_id=self._next_id, arrival_s=time.perf_counter(),
                                   payload=payload)
            self._next_id += 1
            req.future = CompletionFuture(self, req)
            self._queue.append(req)
            self.submitted += 1
            self._cond.notify_all()
        return req.future

    # -- threaded drive ------------------------------------------------------
    def start(self) -> "RequestScheduler":
        if self._thread is not None:
            return self
        self.running = True
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker once the queue has drained, and join it."""
        with self._cond:
            self.running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _worker(self) -> None:
        timeout_s = self.config.batch_timeout_ms / 1e3
        while True:
            batch: List[ScheduledRequest] = []
            with self._cond:
                while self.running and not self._queue:
                    self._cond.wait()
                if not self.running and not self._queue:
                    return
                batch.append(self._queue.pop(0))
                deadline = time.monotonic() + timeout_s
                while len(batch) < self.config.max_batch:
                    if self._queue:
                        batch.append(self._queue.pop(0))
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
        start = time.perf_counter()
        with self._cond:
            depth = len(self._queue)
        error: Optional[BaseException] = None
        out: Any = None
        try:
            out = self.execute(batch)
        except BaseException as e:  # noqa: BLE001 - propagated via futures
            error = e
        end = time.perf_counter()
        results: Sequence[Any]
        if isinstance(out, (list, tuple)) and len(out) == len(batch):
            results = out
        else:
            results = [out] * len(batch)
        for req, value in zip(batch, results):
            req.start_s = start
            req.end_s = end
            req.status = "failed" if error is not None else "completed"
            req.future._set(value, error)
        self.batches += 1
        self.completed += len(batch)
        self.queue_depth_series.append((start, depth))
        self.batch_occupancy_series.append((start, len(batch)))
        with self._cond:
            self._cond.notify_all()

    # -- reporting -----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Scalar summary of the queue/batching series."""
        occ = [v for _, v in self.batch_occupancy_series]
        dep = [v for _, v in self.queue_depth_series]
        return {
            "batches": float(self.batches),
            "submitted": float(self.submitted),
            "completed": float(self.completed),
            "rejected": float(self.rejected),
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
