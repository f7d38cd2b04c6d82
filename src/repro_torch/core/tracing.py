"""Across-stack tracing (paper F9, §4.4.4/§4.5.3).

MLModelScope captures profiles at model-, framework-, and system-level via
"tracing hooks" (a pair of start/end snippets producing *trace events*), and
aggregates all events into a single timeline on a *tracing server*.

In the port the stack levels are:

  MODEL      spans around pipeline operators (pre-process, predict, post-process)
  FRAMEWORK  per-layer spans of the instrumented forward, each layer
             synchronized with the device
  SYSTEM     the device's counters of each predict (``system:cuda``: device
             busy time by torch.profiler, kernel launches by name, peak
             memory) and host /proc counters

Events are published asynchronously to a :class:`TracingServer` which merges
them (by trace id) into one end-to-end timeline — timestamps need not be wall
clock (simulated clocks are allowed, mirroring the paper).

The port's copy of ``repro.core.tracing``, output for output
(``Span.to_dict``, ``dump`` and ``load`` write the same JSON).  Every module
of ``repro_torch`` keeps its own copy of what it needs so that it never
imports ``repro``.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


class TraceLevel(IntEnum):
    """Listing 4's TraceLevel enum."""

    NONE = 0
    MODEL = 1       # steps in the evaluation pipeline
    FRAMEWORK = 2   # + layers within the framework
    SYSTEM = 3      # + system profilers
    FULL = 4        # all of the above

    @classmethod
    def parse(cls, value: "TraceLevel | str | int") -> "TraceLevel":
        if isinstance(value, TraceLevel):
            return value
        if isinstance(value, int):
            return cls(value)
        return cls[str(value).upper()]


_span_ids = itertools.count(1)


@dataclass
class Span:
    """A trace event: a named interval with context + metadata."""

    name: str
    level: TraceLevel
    trace_id: str
    span_id: int = field(default_factory=lambda: next(_span_ids))
    parent_id: Optional[int] = None
    begin: float = 0.0
    end: float = 0.0
    tags: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.begin

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "level": int(self.level),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "begin": self.begin,
            "end": self.end,
            "tags": self.tags,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(
            name=d["name"],
            level=TraceLevel(d["level"]),
            trace_id=d["trace_id"],
            span_id=d["span_id"],
            parent_id=d.get("parent_id"),
            begin=d["begin"],
            end=d["end"],
            tags=d.get("tags", {}),
        )


class TracingServer:
    """Aggregates asynchronously-published spans into per-trace timelines.

    Thread-safe; spans may arrive out of order (the paper publishes events
    asynchronously) and are merged by ``trace_id`` and sorted by begin time.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queue: "queue.SimpleQueue[Span]" = queue.SimpleQueue()
        self._traces: Dict[str, List[Span]] = {}

    def publish(self, span: Span) -> None:
        self._queue.put(span)

    def _drain(self) -> None:
        while True:
            try:
                span = self._queue.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                self._traces.setdefault(span.trace_id, []).append(span)

    def timeline(self, trace_id: str) -> List[Span]:
        """The single end-to-end timeline for one evaluation."""
        self._drain()
        with self._lock:
            spans = list(self._traces.get(trace_id, ()))
        spans.sort(key=lambda s: (s.begin, s.span_id))
        return spans

    def trace_ids(self) -> List[str]:
        self._drain()
        with self._lock:
            return list(self._traces)

    def clear(self, trace_id: Optional[str] = None) -> None:
        self._drain()
        with self._lock:
            if trace_id is None:
                self._traces.clear()
            else:
                self._traces.pop(trace_id, None)

    # -- persistence ---------------------------------------------------
    def dump(self, trace_id: str, path: str) -> None:
        spans = self.timeline(trace_id)
        with open(path, "w") as f:
            json.dump([s.to_dict() for s in spans], f)

    @staticmethod
    def load(path: str) -> List[Span]:
        with open(path) as f:
            return [Span.from_dict(d) for d in json.load(f)]


class Tracer:
    """A tracing hook factory bound to one evaluation (``trace_id``).

    Only spans at or below the configured :class:`TraceLevel` are recorded —
    the user-selectable granularity of Listing 4. ``clock`` is injectable so
    simulators can publish virtual time (explicitly allowed by the paper).
    """

    def __init__(
        self,
        trace_id: str,
        server: TracingServer,
        level: TraceLevel = TraceLevel.FULL,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.trace_id = trace_id
        self.server = server
        self.level = TraceLevel.parse(level)
        self.clock = clock
        self._stack: threading.local = threading.local()

    def enabled(self, level: TraceLevel) -> bool:
        if self.level == TraceLevel.NONE:
            return False
        if self.level == TraceLevel.FULL:
            return True
        return int(level) <= int(self.level)

    def _parent(self) -> Optional[int]:
        stack = getattr(self._stack, "spans", None)
        return stack[-1].span_id if stack else None

    @contextmanager
    def span(
        self, name: str, level: TraceLevel = TraceLevel.MODEL, **tags: Any
    ) -> Iterator[Optional[Span]]:
        """The start/end tracing-hook pair of §4.4.4."""
        if not self.enabled(level):
            yield None
            return
        sp = Span(
            name=name,
            level=level,
            trace_id=self.trace_id,
            parent_id=self._parent(),
            tags=dict(tags),
        )
        stack = getattr(self._stack, "spans", None)
        if stack is None:
            stack = []
            self._stack.spans = stack
        stack.append(sp)
        sp.begin = self.clock()
        try:
            yield sp
        finally:
            sp.end = self.clock()
            stack.pop()
            self.server.publish(sp)

    def event(
        self,
        name: str,
        begin: float,
        end: float,
        level: TraceLevel = TraceLevel.SYSTEM,
        parent_id: Optional[int] = None,
        **tags: Any,
    ) -> Span:
        """Publish an externally-timed event (e.g. from a profile dump)."""
        sp = Span(
            name=name,
            level=level,
            trace_id=self.trace_id,
            parent_id=parent_id if parent_id is not None else self._parent(),
            begin=begin,
            end=end,
            tags=dict(tags),
        )
        if self.enabled(level):
            self.server.publish(sp)
        return sp


class NullTracer(Tracer):
    """Trace level NONE — all hooks are no-ops (conditional-disable, §4.6)."""

    def __init__(self) -> None:
        super().__init__("null", TracingServer(), TraceLevel.NONE)


def host_counters() -> Dict[str, float]:
    """SYSTEM-level host counters from /proc (the PAPI/perf stand-in)."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        tick = os.sysconf("SC_CLK_TCK")
        out["utime_s"] = int(parts[13]) / tick
        out["stime_s"] = int(parts[14]) / tick
        out["rss_bytes"] = int(parts[23]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):  # pragma: no cover
        pass
    return out


def summarize(spans: Sequence[Span]) -> Dict[str, Dict[str, float]]:
    """Aggregate spans by name: count/total/mean duration (report helper)."""
    agg: Dict[str, Dict[str, float]] = {}
    for s in spans:
        a = agg.setdefault(s.name, {"count": 0, "total_s": 0.0})
        a["count"] += 1
        a["total_s"] += s.duration
    for a in agg.values():
        a["mean_s"] = a["total_s"] / max(a["count"], 1)
    return agg
