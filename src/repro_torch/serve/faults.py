"""Deterministic fault injection for the serving fleet.

The port's copy of ``repro.serve.faults`` (pure Python: the port keeps its
own copy so that it never imports ``repro``).  The fleet's failure model is only testable if failures are *scripted*: a
seeded :class:`FaultPlan` lists exactly which worker fails how and at which
engine-loop boundary, so a fault run is as reproducible as a fault-free one
(same seed -> same deaths -> same requeues -> same tokens).  Three fault
kinds cover the failure classes the router must survive:

* ``crash``   — the worker raises :class:`WorkerCrash` at the boundary; the
  engine attaches a resumable snapshot (finished results + every request
  not yet finished) before re-raising, and the router replays the pending
  requests from their prompts on the survivors.
* ``stall``   — the worker sleeps at the boundary (GC pause / network
  partition stand-in).  A stall longer than the worker's lease TTL makes
  the next heartbeat renewal fail, which the fleet turns into a
  self-inflicted :class:`WorkerCrash` — lease expiry and crash share one
  recovery path.
* ``pressure``— the fault seizes pages from the worker's pool for a number
  of boundaries (a noisy-neighbour / fragmentation stand-in), exercising
  preemption and the router's degrade ladder without killing anyone.
* ``corrupt`` — the fault flips the bytes of one page inside the worker's
  latest live-KV checkpoint WITHOUT touching its checksum ledger (bit-rot /
  torn-write stand-in).  Nothing dies; the corruption is only *observable*
  when a later migration tries to restore that snapshot — the import-side
  checksum verify must catch it and downgrade the request to
  replay-from-prompt (corrupted state is never served).  A corrupt spec
  whose step has arrived but whose worker holds no checkpoint yet stays
  pending until one exists (it needs a victim to bite).

Two faults may not share a ``worker:step`` slot: the firing order inside
one boundary would be ambiguous, so :meth:`FaultPlan.parse` rejects the
duplicate naming the offending spec token.

The engine loop calls the per-worker hook once per boundary behind a no-op
default (``fault_hook=None`` costs nothing), and every injected fault emits
a ``fault:*`` tracer event so recovery shows up in the analysis timeline
next to the ``fleet:*`` events it triggers.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "FaultContext",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "WorkerCrash",
    "WorkerDrain",
]

FAULT_KINDS = ("crash", "stall", "pressure", "corrupt")


class FaultError(RuntimeError):
    """Base class for injected faults."""


class WorkerCrash(FaultError):
    """A worker died (injected crash, or a lease the worker failed to renew).

    The engine catches this at the serve loop, attaches a *resumable
    snapshot* — ``results`` (every request already finished, commit-worthy)
    and ``pending`` (every request not yet finished, replayable from its
    prompt exactly like a preempted request) — and re-raises for the router.
    """

    def __init__(self, worker: int, step: int, reason: str = "crash") -> None:
        super().__init__(f"worker {worker} died at step {step} ({reason})")
        self.worker = worker
        self.step = step
        self.reason = reason
        self.results: List[Any] = []   # RequestResult, attached by the engine
        self.pending: List[Any] = []   # ServeRequest, attached by the engine


class WorkerDrain(WorkerCrash):
    """Planned elasticity: the router asked this worker to hand off its
    live work and leave the fleet.

    Shares the :class:`WorkerCrash` recovery path, with one upgrade: the
    engine catches it at the boundary and snapshots EVERY live decoding
    slot into the worker's checkpoint store *before* re-raising — the
    snapshots are as-of the drain boundary, so every migrated request
    resumes with zero recomputed tokens (a crash can only offer the last
    periodic checkpoint; a drain is voluntary, so it gets a fresh one).
    """

    def __init__(self, worker: int, step: int) -> None:
        super().__init__(worker, step, reason="drain")


@dataclass
class FaultContext:
    """What the engine exposes to a boundary hook: enough to observe and
    perturb the run, nothing that would let a fault corrupt bookkeeping.
    The engine is worker-agnostic — a hook that needs its worker index
    carries it itself (see :class:`_WorkerHook`)."""

    step: int
    pool: Any = None      # the worker's PagePool (pressure faults)
    clock: Callable[[], float] = time.perf_counter
    tracer: Any = None
    checkpoints: Any = None   # worker's {request_id: PageSnapshot} store
    #                           (corrupt faults bite the latest snapshot)


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: ``kind`` hits ``worker`` at loop ``step``."""

    kind: str
    worker: int
    step: int
    duration_s: float = 0.0   # stall: how long the boundary sleeps
    pages: int = 0            # pressure: pages seized from the pool
    hold_steps: int = 1       # pressure: boundaries the seizure lasts

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.worker < 0 or self.step < 0:
            raise ValueError("worker and step must be >= 0")
        if self.kind == "stall" and self.duration_s < 0:
            raise ValueError("stall duration_s must be >= 0")
        if self.kind == "pressure" and (self.pages < 1 or self.hold_steps < 1):
            raise ValueError("pressure needs pages >= 1 and hold_steps >= 1")
        # corrupt takes no extra arguments: it bites the worker's latest
        # checkpoint, whichever request that happens to cover

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "worker": self.worker, "step": self.step,
            "duration_s": self.duration_s, "pages": self.pages,
            "hold_steps": self.hold_steps,
        }


class _WorkerHook:
    """Per-worker boundary hook: fires this worker's specs in step order.

    A spec fires at the first boundary whose step counter has *reached* its
    scripted step (admission-only boundaries do not advance the decode step
    counter, so exact equality would be racy) and fires exactly once.
    Pressure seizures are returned to the pool ``hold_steps`` boundaries
    later, or on :meth:`release` if the run ends while they are held.
    """

    def __init__(self, worker: int, specs: Sequence[FaultSpec],
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.worker = worker
        self.sleep = sleep
        self._pending = sorted(specs, key=lambda s: (s.step, FAULT_KINDS.index(s.kind)))
        self._boundary = 0                      # boundaries seen (monotonic)
        self._seized: List[tuple] = []          # (release_at_boundary, pages, pool)
        self.fired: List[FaultSpec] = []

    def __call__(self, ctx: FaultContext) -> None:
        self._boundary += 1
        # return seizures whose hold has elapsed
        due = [t for t in self._seized if t[0] <= self._boundary]
        for release_at, pages, pool in due:
            pool.free(pages)
            self._seized.remove((release_at, pages, pool))
            if ctx.tracer is not None:
                now = ctx.clock()
                ctx.tracer.event("fault:pressure_release", now, now,
                                 worker=self.worker, pages=len(pages))
        while self._pending and self._pending[0].step <= ctx.step:
            spec = self._pending[0]
            if spec.kind == "corrupt" and not ctx.checkpoints:
                # nothing checkpointed yet: the fault needs a victim, so it
                # stays pending (holding any later specs — step order is
                # the contract) until a snapshot exists to corrupt
                break
            self._pending.pop(0)
            self.fired.append(spec)
            self._fire(spec, ctx)

    def _fire(self, spec: FaultSpec, ctx: FaultContext) -> None:
        t0 = ctx.clock()
        if spec.kind == "crash":
            if ctx.tracer is not None:
                ctx.tracer.event("fault:crash", t0, t0,
                                 worker=self.worker, step=ctx.step)
            raise WorkerCrash(self.worker, ctx.step, reason="injected-crash")
        if spec.kind == "stall":
            self.sleep(spec.duration_s)
            if ctx.tracer is not None:
                ctx.tracer.event("fault:stall", t0, ctx.clock(),
                                 worker=self.worker, step=ctx.step,
                                 duration_s=spec.duration_s)
            return
        if spec.kind == "corrupt":
            # bite the latest snapshot in the worker's checkpoint store
            # (max request_id of equal-step snapshots is deterministic);
            # the checksum ledger is deliberately left stale — only a
            # later restore's verify can observe the damage
            store = ctx.checkpoints
            rid = max(store, key=lambda r: (store[r].step, r))
            store[rid].corrupt(page=0)
            if ctx.tracer is not None:
                ctx.tracer.event("fault:corrupt", t0, t0,
                                 worker=self.worker, step=ctx.step,
                                 request=rid)
            return
        # pressure: seize what the pool can spare right now
        pool = ctx.pool
        take = min(spec.pages, pool.num_free) if pool is not None else 0
        pages = pool.alloc(take) if take > 0 else None
        if pages:
            self._seized.append((self._boundary + spec.hold_steps, pages, pool))
        if ctx.tracer is not None:
            ctx.tracer.event("fault:pressure", t0, t0, worker=self.worker,
                             step=ctx.step, pages=len(pages or ()),
                             requested=spec.pages, hold_steps=spec.hold_steps)

    def release(self) -> int:
        """Return every still-held seizure to its pool (end-of-run cleanup);
        returns the number of pages released."""
        n = 0
        for _, pages, pool in self._seized:
            pool.free(pages)
            n += len(pages)
        self._seized.clear()
        return n


class FaultPlan:
    """A seeded, deterministic schedule of faults across a worker fleet."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0) -> None:
        self.specs = list(specs)
        self.seed = seed

    def __bool__(self) -> bool:
        return bool(self.specs)

    def for_worker(self, worker: int) -> List[FaultSpec]:
        return [s for s in self.specs if s.worker == worker]

    def hook_for(self, worker: int,
                 sleep: Callable[[float], None] = time.sleep
                 ) -> Optional[_WorkerHook]:
        """The boundary hook for ``worker`` — None when the plan never
        touches it, so the engine keeps its zero-cost default path."""
        specs = self.for_worker(worker)
        if not specs:
            return None
        return _WorkerHook(worker, specs, sleep=sleep)

    @classmethod
    def generate(cls, num_workers: int, seed: int = 0, *,
                 max_step: int = 16, crashes: int = 1, stalls: int = 0,
                 pressures: int = 0, stall_s: float = 0.05,
                 pages: int = 4, hold_steps: int = 2) -> "FaultPlan":
        """A random-but-seeded plan: same seed, same schedule."""
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        rng = random.Random(seed)
        specs: List[FaultSpec] = []
        for _ in range(crashes):
            specs.append(FaultSpec("crash", rng.randrange(num_workers),
                                   rng.randrange(1, max_step + 1)))
        for _ in range(stalls):
            specs.append(FaultSpec("stall", rng.randrange(num_workers),
                                   rng.randrange(1, max_step + 1),
                                   duration_s=stall_s))
        for _ in range(pressures):
            specs.append(FaultSpec("pressure", rng.randrange(num_workers),
                                   rng.randrange(1, max_step + 1),
                                   pages=pages, hold_steps=hold_steps))
        return cls(specs, seed=seed)

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``--fault-plan`` CLI syntax: comma-separated items

        * ``crash@W:S``           — crash worker W at step S
        * ``stall@W:S:DUR``       — stall worker W at step S for DUR seconds
        * ``pressure@W:S:PxH``    — seize P pages on worker W at step S for
          H boundaries
        * ``corrupt@W:S``         — flip bytes in worker W's latest live-KV
          checkpoint at step S (checksums stay stale; a later restore's
          verify must catch it)

        e.g. ``crash@1:6,stall@0:3:0.05,pressure@2:4:6x2``; empty or
        ``none`` parses to an empty plan.  Two items landing on the same
        ``worker:step`` are rejected (the firing order inside one boundary
        would be ambiguous) with an error naming the offending token.
        """
        text = (text or "").strip()
        if not text or text.lower() == "none":
            return cls(seed=seed)
        specs: List[FaultSpec] = []
        taken: set = set()              # (worker, step) slots already used
        for item in text.replace(";", ",").split(","):
            item = item.strip()
            if not item:
                continue
            try:
                kind, rest = item.split("@", 1)
                parts = rest.split(":")
                worker, step = int(parts[0]), int(parts[1])
                if (worker, step) in taken:
                    raise ValueError(
                        f"duplicate fault at worker {worker} step {step} "
                        f"(one fault per worker:step slot)"
                    )
                taken.add((worker, step))
                if kind == "crash":
                    specs.append(FaultSpec("crash", worker, step))
                elif kind == "stall":
                    dur = float(parts[2]) if len(parts) > 2 else 0.05
                    specs.append(FaultSpec("stall", worker, step,
                                           duration_s=dur))
                elif kind == "pressure":
                    pages, hold = 4, 2
                    if len(parts) > 2:
                        p = parts[2].lower().split("x")
                        pages = int(p[0])
                        hold = int(p[1]) if len(p) > 1 else 2
                    specs.append(FaultSpec("pressure", worker, step,
                                           pages=pages, hold_steps=hold))
                elif kind == "corrupt":
                    specs.append(FaultSpec("corrupt", worker, step))
                else:
                    raise ValueError(f"unknown fault kind {kind!r}")
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad fault-plan item {item!r}: {e}"
                ) from None
        return cls(specs, seed=seed)

    def describe(self) -> str:
        if not self.specs:
            return "none"
        out = []
        for s in sorted(self.specs, key=lambda s: (s.step, s.worker)):
            if s.kind in ("crash", "corrupt"):
                out.append(f"{s.kind}@{s.worker}:{s.step}")
            elif s.kind == "stall":
                out.append(f"stall@{s.worker}:{s.step}:{s.duration_s:g}")
            else:
                out.append(
                    f"pressure@{s.worker}:{s.step}:{s.pages}x{s.hold_steps}"
                )
        return ",".join(out)

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "specs": [s.to_dict() for s in self.specs]}
