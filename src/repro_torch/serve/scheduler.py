"""Slot and prefill-budget bookkeeping of the paged serving loop.

A copy of ``SlotPool``, ``PrefillBudget``, ``SpecLedger`` and
``PagedSlotPool`` from ``repro.serve.scheduler`` (pure Python; the port keeps its own copy so that
it never imports ``repro``).  The tracer argument stays optional.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["PagedSlotPool", "PrefillBudget", "SlotPool", "SpecLedger"]


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
