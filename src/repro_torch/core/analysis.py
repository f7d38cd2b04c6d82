"""Latency metrics (a copy of ``trimmed_mean``, ``percentile`` and
``latency_summary`` from ``repro.core.analysis``; the port keeps its own
copy so that it never imports ``repro``)."""
from __future__ import annotations

import math
from typing import Dict, Sequence


def trimmed_mean(values: Sequence[float], trim: float = 0.2) -> float:
    """The paper's trimmed mean: drop the smallest/largest ``trim`` fraction.

    TrimmedMean(list) = Mean(Sort(list)[floor(trim*len) : -floor(trim*len)])
    """
    if not values:
        raise ValueError("trimmed_mean of empty sequence")
    if not 0.0 <= trim < 0.5:
        raise ValueError("trim must be in [0, 0.5)")
    s = sorted(values)
    k = math.floor(trim * len(s))
    core = s[k : len(s) - k] if k else s
    return sum(core) / len(core)


def percentile(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile (pct in [0, 100])."""
    if not values:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= pct <= 100.0:
        raise ValueError("pct must be in [0, 100]")
    s = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(s)))
    return s[rank - 1]


def latency_summary(latencies_s: Sequence[float]) -> Dict[str, float]:
    """Standard latency metrics block used by every scenario."""
    if not latencies_s:
        return {"trimmed_mean_ms": float("nan"), "p90_ms": float("nan")}
    return {
        "trimmed_mean_ms": trimmed_mean(latencies_s) * 1e3,
        "p90_ms": percentile(latencies_s, 90.0) * 1e3,
        "min_ms": min(latencies_s) * 1e3,
        "max_ms": max(latencies_s) * 1e3,
    }
