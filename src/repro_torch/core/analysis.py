"""Benchmarking analysis & reporting (paper F8, §4.3/§5.3).

Automated analysis over raw benchmarking output: the paper's metrics
(trimmed-mean latency, 90th-percentile latency, max throughput, throughput
scalability across batch sizes) plus the across-stack trace summaries
(top-K most time-consuming layers, per-level breakdowns — Table 3 / Fig 8),
and human-readable report generation.

The port's copy of what the platform calls from ``repro.core.analysis``: the
paper metrics, the scheduler summary, Jain's index and the trace and report
helpers.  The serving-event summaries (page occupancy, prefill saturation,
speculation, TP, prefix cache, fleet, recovery, SLO serving, KV divergence)
wait for the slices that emit those events.  Every module of ``repro_torch``
keeps its own copy of what it needs so that it never imports ``repro``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .tracing import Span, TraceLevel


# --------------------------------------------------------------------------
# Paper metrics
# --------------------------------------------------------------------------
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


def slo_attainment(latencies_s: Sequence[float], slo_ms: float) -> Dict[str, float]:
    """Server-scenario SLO accounting: violation count + attained fraction."""
    if not latencies_s:
        return {"slo_violations": 0.0, "slo_attainment": 1.0}
    violations = sum(1 for l in latencies_s if l * 1e3 > slo_ms)
    return {
        "slo_violations": float(violations),
        "slo_attainment": 1.0 - violations / len(latencies_s),
    }


def scheduler_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize the scheduler's queue-depth / batch-occupancy trace series.

    The request scheduler publishes one ``scheduler:batch`` event per
    executed micro-batch, tagged with ``queue_depth`` (arrived-but-unserved
    requests at batch formation), ``occupancy`` (coalesced requests) and
    ``inputs`` (total model batch).  This aggregates them into the queueing
    block of the analysis workflow."""
    depths: List[float] = []
    occs: List[float] = []
    inputs = 0.0
    for s in spans:
        if s.name != "scheduler:batch":
            continue
        depths.append(float(s.tags.get("queue_depth", 0)))
        occs.append(float(s.tags.get("occupancy", 0)))
        inputs += float(s.tags.get("inputs", 0))
    if not occs:
        return {}
    return {
        "batches": float(len(occs)),
        "total_inputs": inputs,
        "mean_batch_occupancy": sum(occs) / len(occs),
        "max_batch_occupancy": max(occs),
        "mean_queue_depth": sum(depths) / len(depths),
        "max_queue_depth": max(depths),
    }


def jain_index(shares: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant shares: (Σx)² / (n·Σx²).

    1.0 when every tenant got an equal share, 1/n when one tenant got
    everything.  Defined as 1.0 for empty or all-zero inputs (no
    contention — nothing was unfair)."""
    xs = [float(x) for x in shares if x > 0]
    if not xs:
        return 1.0
    total = sum(xs)
    sq = sum(x * x for x in xs)
    return total * total / (len(xs) * sq) if sq > 0 else 1.0


def throughput_scalability(
    per_batch: Dict[int, float]
) -> Dict[int, float]:
    """Figure 6: throughput speedup over batch size 1 for each batch size."""
    if not per_batch:
        return {}
    base = per_batch.get(1)
    if base is None or base <= 0:
        base = per_batch[min(per_batch)]
    return {bs: tput / base for bs, tput in sorted(per_batch.items())}


# --------------------------------------------------------------------------
# Trace analysis (Table 3 / Figure 8)
# --------------------------------------------------------------------------
@dataclass
class LayerStat:
    name: str
    count: int
    total_s: float
    mean_s: float
    tags: Dict[str, Any]


def layer_breakdown(
    spans: Iterable[Span], level: TraceLevel = TraceLevel.FRAMEWORK
) -> List[LayerStat]:
    """Aggregate FRAMEWORK-level layer spans; sorted by total time desc."""
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        if s.level != level:
            continue
        a = agg.setdefault(s.name, {"count": 0, "total": 0.0, "tags": dict(s.tags)})
        a["count"] += 1
        a["total"] += s.duration
    stats = [
        LayerStat(
            name=k,
            count=v["count"],
            total_s=v["total"],
            mean_s=v["total"] / max(v["count"], 1),
            tags=v["tags"],
        )
        for k, v in agg.items()
    ]
    stats.sort(key=lambda x: -x.total_s)
    return stats


def top_layers(spans: Iterable[Span], k: int = 5) -> List[LayerStat]:
    """Table 3: the top-K most time-consuming layers."""
    return layer_breakdown(spans)[:k]


def critical_path(spans: Sequence[Span]) -> List[Span]:
    """Longest chain of non-overlapping child spans under the root span
    (the "zoom-in" path of Figure 8)."""
    if not spans:
        return []
    by_parent: Dict[Optional[int], List[Span]] = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s)
    roots = by_parent.get(None, [])
    if not roots:
        return []
    root = max(roots, key=lambda s: s.duration)
    path = [root]
    cur = root
    while True:
        children = by_parent.get(cur.span_id, [])
        if not children:
            return path
        cur = max(children, key=lambda s: s.duration)
        path.append(cur)


def level_breakdown(spans: Iterable[Span]) -> Dict[str, float]:
    """Total time spent per trace level (hierarchical view)."""
    out: Dict[str, float] = {}
    for s in spans:
        out[s.level.name] = out.get(s.level.name, 0.0) + s.duration
    return out


# --------------------------------------------------------------------------
# Reports (F8 reporting; consumed by the CLI/web clients)
# --------------------------------------------------------------------------
def comparison_table(
    rows: List[Dict[str, Any]], columns: Sequence[str], sort_by: Optional[str] = None
) -> str:
    """Render an aligned text table (the paper's summary reports)."""
    if sort_by:
        rows = sorted(rows, key=lambda r: r.get(sort_by, 0), reverse=True)
    headers = list(columns)
    table = [headers] + [
        [_fmt(r.get(c)) for c in columns] for r in rows
    ]
    widths = [max(len(row[i]) for row in table) for i in range(len(headers))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(cell.ljust(w) for cell, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.2f}" if abs(v) >= 0.01 else f"{v:.3g}"
    return str(v)


def markdown_report(
    title: str, sections: List[Tuple[str, str]]
) -> str:
    """Assemble a markdown report (analysis workflow output, step e)."""
    parts = [f"# {title}", ""]
    for heading, body in sections:
        parts += [f"## {heading}", "", body, ""]
    return "\n".join(parts)
