"""Workload generators (paper F7, §4.1.3).

The server generates an inference request load from the benchmarking
scenario: batched inference, or online inference with a configurable
arrival-time distribution (e.g. Poisson). Generators are pluggable.

The port's copy of ``repro.core.workload``.  Every module of ``repro_torch``
keeps its own copy of what it needs so that it never imports ``repro``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


@dataclass
class Request:
    """One inference request in a generated load."""

    request_id: int
    arrival_s: float       # offset from scenario start
    batch_size: int = 1
    tags: Dict[str, object] = field(default_factory=dict)


class WorkloadGenerator:
    name = "base"

    def requests(self) -> Iterator[Request]:  # pragma: no cover - interface
        raise NotImplementedError


class BatchedLoad(WorkloadGenerator):
    """Offline/batched scenario: all requests available at t=0."""

    name = "batched"

    def __init__(self, num_requests: int, batch_size: int) -> None:
        self.num_requests = num_requests
        self.batch_size = batch_size

    def requests(self) -> Iterator[Request]:
        for i in range(self.num_requests):
            yield Request(request_id=i, arrival_s=0.0, batch_size=self.batch_size)


class PoissonLoad(WorkloadGenerator):
    """Online scenario: exponential inter-arrivals at ``rate_hz`` (batch 1)."""

    name = "poisson"

    def __init__(self, num_requests: int, rate_hz: float, seed: int = 0) -> None:
        if rate_hz <= 0:
            raise ValueError("rate_hz must be positive")
        self.num_requests = num_requests
        self.rate_hz = rate_hz
        self.seed = seed

    def requests(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        for i in range(self.num_requests):
            t += float(rng.exponential(1.0 / self.rate_hz))
            yield Request(request_id=i, arrival_s=t, batch_size=1)


class UniformLoad(WorkloadGenerator):
    """Interactive scenario: fixed-interval arrivals."""

    name = "uniform"

    def __init__(self, num_requests: int, interval_s: float, batch_size: int = 1) -> None:
        self.num_requests = num_requests
        self.interval_s = interval_s
        self.batch_size = batch_size

    def requests(self) -> Iterator[Request]:
        for i in range(self.num_requests):
            yield Request(
                request_id=i, arrival_s=i * self.interval_s, batch_size=self.batch_size
            )


class BurstyLoad(WorkloadGenerator):
    """On/off-modulated Poisson arrivals (interrupted Poisson process).

    Time alternates between an ``on_s``-long burst phase at
    ``rate_hz * burst_factor`` and an ``off_s``-long quiet phase at
    ``rate_hz``.  With ``burst_factor=1`` this degenerates to plain
    Poisson.  The overload story's arrival process: short bursts that
    exceed sustainable capacity while the long-run average does not."""

    name = "bursty"

    def __init__(self, num_requests: int, rate_hz: float,
                 burst_factor: float = 3.0, on_s: float = 1.0,
                 off_s: float = 4.0, seed: int = 0) -> None:
        if rate_hz <= 0:
            raise ValueError("rate_hz must be positive")
        if burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1")
        if on_s <= 0 or off_s < 0:
            raise ValueError("need on_s > 0 and off_s >= 0")
        self.num_requests = num_requests
        self.rate_hz = rate_hz
        self.burst_factor = burst_factor
        self.on_s = on_s
        self.off_s = off_s
        self.seed = seed

    def requests(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        period = self.on_s + self.off_s
        t = 0.0
        for i in range(self.num_requests):
            while True:
                phase = t % period
                in_burst = phase < self.on_s
                rate = self.rate_hz * (self.burst_factor if in_burst else 1.0)
                dt = float(rng.exponential(1.0 / rate))
                # an arrival drawn past the current phase boundary is
                # discarded and the clock restarts at the boundary with the
                # next phase's rate (standard piecewise-constant thinning)
                boundary = self.on_s if in_burst else period
                if phase + dt <= boundary:
                    t += dt
                    break
                t += boundary - phase
            yield Request(
                request_id=i, arrival_s=t, batch_size=1,
                tags={"burst": bool((t % period) < self.on_s)},
            )


class DiurnalLoad(WorkloadGenerator):
    """Sinusoidally rate-modulated Poisson arrivals (diurnal cycle).

    Instantaneous rate ``rate_hz * (1 + amplitude * sin(2*pi*t/period_s))``
    sampled by Lewis-Shedler thinning against the peak rate, so the
    arrival process is an exact non-homogeneous Poisson process."""

    name = "diurnal"

    def __init__(self, num_requests: int, rate_hz: float,
                 period_s: float = 60.0, amplitude: float = 0.8,
                 seed: int = 0) -> None:
        if rate_hz <= 0:
            raise ValueError("rate_hz must be positive")
        if not 0.0 <= amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        self.num_requests = num_requests
        self.rate_hz = rate_hz
        self.period_s = period_s
        self.amplitude = amplitude
        self.seed = seed

    def _rate(self, t: float) -> float:
        return self.rate_hz * (
            1.0 + self.amplitude * math.sin(2.0 * math.pi * t / self.period_s)
        )

    def requests(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        peak = self.rate_hz * (1.0 + self.amplitude)
        t = 0.0
        for i in range(self.num_requests):
            while True:
                t += float(rng.exponential(1.0 / peak))
                if rng.random() < self._rate(t) / peak:
                    break
            yield Request(request_id=i, arrival_s=t, batch_size=1)


class MultiTenantLoad(WorkloadGenerator):
    """Superposition of independent per-tenant Poisson streams.

    Each tenant is a dict with at least ``name`` and ``rate_hz``; optional
    keys ``num_requests`` (default ``num_requests`` split evenly),
    ``priority``, ``slo_ms``, ``prompt_len``, ``gen_tokens`` ride along in
    each request's tags so scheduler-level scenarios can submit with the
    tenant's identity and shape (prefill-heavy vs decode-heavy mixes are
    just different prompt_len/gen_tokens per tenant).  Streams are merged
    by arrival time and re-numbered globally."""

    name = "multi_tenant"

    def __init__(self, num_requests: int,
                 tenants: List[Dict[str, object]], seed: int = 0) -> None:
        if not tenants:
            raise ValueError("need at least one tenant")
        for t in tenants:
            if "name" not in t or float(t.get("rate_hz", 0.0)) <= 0:
                raise ValueError(
                    "each tenant needs a name and a positive rate_hz"
                )
        self.num_requests = num_requests
        self.tenants = [dict(t) for t in tenants]
        self.seed = seed

    def requests(self) -> Iterator[Request]:
        per_default = max(1, self.num_requests // len(self.tenants))
        merged: List[Request] = []
        for k, spec in enumerate(self.tenants):
            rng = np.random.default_rng((self.seed, k))
            n = int(spec.get("num_requests", per_default))
            rate = float(spec["rate_hz"])
            tags = {
                "tenant": str(spec["name"]),
                "priority": int(spec.get("priority", 1)),
                "slo_ms": float(spec.get("slo_ms", 0.0)),
                "prompt_len": int(spec.get("prompt_len", 0)),
                "gen_tokens": int(spec.get("gen_tokens", 0)),
            }
            t = 0.0
            for _ in range(n):
                t += float(rng.exponential(1.0 / rate))
                merged.append(Request(
                    request_id=0, arrival_s=t, batch_size=1,
                    tags=dict(tags),
                ))
        merged.sort(key=lambda r: r.arrival_s)
        for i, req in enumerate(merged):
            req.request_id = i
            yield req


class SingleStreamLoad(BatchedLoad):
    """MLPerf single-stream: back-to-back batch-1 requests (latency-bound)."""

    name = "single_stream"

    def __init__(self, num_requests: int) -> None:
        super().__init__(num_requests, 1)


class TraceReplayLoad(WorkloadGenerator):
    """Custom/emerging workloads: replay recorded (arrival, batch) pairs.

    ``tags`` optionally carries per-request metadata recorded with the
    trace (e.g. the shared-prefix composition of replayed prompts), passed
    through on each :class:`Request` so scheduler-level scenarios can
    reconstruct the prompt mix."""

    name = "trace"

    def __init__(self, arrivals: List[float], batch_sizes: Optional[List[int]] = None,
                 tags: Optional[List[Dict[str, object]]] = None) -> None:
        self.arrivals = list(arrivals)
        self.batch_sizes = list(batch_sizes) if batch_sizes else [1] * len(self.arrivals)
        if len(self.batch_sizes) != len(self.arrivals):
            raise ValueError("arrivals and batch_sizes length mismatch")
        self.tags = list(tags) if tags else None
        if self.tags is not None and len(self.tags) != len(self.arrivals):
            raise ValueError("arrivals and tags length mismatch")

    def requests(self) -> Iterator[Request]:
        for i, (t, b) in enumerate(zip(self.arrivals, self.batch_sizes)):
            yield Request(
                request_id=i, arrival_s=float(t), batch_size=int(b),
                tags=dict(self.tags[i]) if self.tags else {},
            )


class SharedPrefixLoad(WorkloadGenerator):
    """Shared-prefix serving mix: the workload the prefix cache eats.

    A configurable fraction (``share_ratio``) of requests reuse one of
    ``num_groups`` common prompt prefixes of ``prefix_len`` tokens (system
    prompts / few-shot templates), each followed by a ``suffix_len``-token
    unique tail; the rest are fully unique prompts of the same total
    length.  Arrivals are Poisson at ``rate_hz`` (all at t=0 when 0).  The
    generator emits *composition tags*, not tokens — ``prefix_group`` (-1
    for unique requests), ``prefix_len`` and ``prompt_len`` — so scheduler-
    level scenarios measure the mix without a tokenizer, and
    :func:`shared_prefix_prompts` materializes token arrays for the engine
    (same-group requests share their first ``prefix_len`` tokens
    bit-for-bit)."""

    name = "shared_prefix"

    def __init__(self, num_requests: int, rate_hz: float = 0.0,
                 prefix_len: int = 64, suffix_len: int = 16,
                 share_ratio: float = 0.75, num_groups: int = 1,
                 seed: int = 0) -> None:
        if prefix_len < 0 or suffix_len < 0:
            raise ValueError("prefix_len and suffix_len must be >= 0")
        if not 0.0 <= share_ratio <= 1.0:
            raise ValueError("share_ratio must be in [0, 1]")
        if num_groups < 1:
            raise ValueError("num_groups must be >= 1")
        self.num_requests = num_requests
        self.rate_hz = rate_hz
        self.prefix_len = prefix_len
        self.suffix_len = suffix_len
        self.share_ratio = share_ratio
        self.num_groups = num_groups
        self.seed = seed

    def requests(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        total = self.prefix_len + self.suffix_len
        for i in range(self.num_requests):
            if self.rate_hz > 0:
                t += float(rng.exponential(1.0 / self.rate_hz))
            shared = bool(rng.random() < self.share_ratio)
            group = int(rng.integers(0, self.num_groups)) if shared else -1
            yield Request(
                request_id=i,
                arrival_s=t,
                batch_size=1,
                tags={
                    "prefix_group": group,
                    "prefix_len": self.prefix_len if shared else 0,
                    "prompt_len": total,
                },
            )


def shared_prefix_prompts(
    requests: List[Request], vocab_size: int, seed: int = 0
) -> List["np.ndarray"]:
    """Materialize token arrays for a shared-prefix load: requests tagged
    with the same ``prefix_group`` (>= 0) share their first ``prefix_len``
    tokens bit-for-bit (generated once per group from ``seed``); the
    remainder of every prompt is unique.  The engine-side counterpart of
    :class:`SharedPrefixLoad` — prompts feed ``serve_paged`` directly."""
    rng = np.random.default_rng(seed)
    prefixes: Dict[int, np.ndarray] = {}
    prompts: List[np.ndarray] = []
    for req in requests:
        total = int(req.tags.get("prompt_len", 0))
        plen = int(req.tags.get("prefix_len", 0))
        group = int(req.tags.get("prefix_group", -1))
        if group >= 0 and plen > 0:
            if group not in prefixes:
                grng = np.random.default_rng((seed, group))
                prefixes[group] = grng.integers(
                    0, vocab_size, (plen,)
                ).astype(np.int32)
            tail = rng.integers(0, vocab_size, (total - plen,)).astype(np.int32)
            prompts.append(np.concatenate([prefixes[group], tail]))
        else:
            prompts.append(rng.integers(0, vocab_size, (total,)).astype(np.int32))
    return prompts


_GENERATORS: Dict[str, Callable[..., WorkloadGenerator]] = {
    "batched": BatchedLoad,
    "poisson": PoissonLoad,
    "uniform": UniformLoad,
    "trace": TraceReplayLoad,
    "single_stream": SingleStreamLoad,
    # the server scenario's open-loop arrival process is Poisson
    "server": PoissonLoad,
    # shared-prefix request mixes (system prompts / few-shot templates)
    "shared_prefix": SharedPrefixLoad,
    # overload / multi-tenant arrival processes
    "bursty": BurstyLoad,
    "diurnal": DiurnalLoad,
    "multi_tenant": MultiTenantLoad,
}


def register_generator(name: str, factory: Callable[..., WorkloadGenerator]) -> None:
    """Pluggable workload generators (§1)."""
    _GENERATORS[name] = factory


def make_generator(name: str, **kwargs) -> WorkloadGenerator:
    try:
        return _GENERATORS[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown workload generator {name!r}; have {sorted(_GENERATORS)}")
