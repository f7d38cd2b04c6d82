"""Benchmarking analysis & reporting (paper F8, §4.3/§5.3).

Automated analysis over raw benchmarking output: the paper's metrics
(trimmed-mean latency, 90th-percentile latency, max throughput, throughput
scalability across batch sizes) plus the across-stack trace summaries
(top-K most time-consuming layers, per-level breakdowns — Table 3 / Fig 8),
and human-readable report generation.

The port's copy of what the platform and the serving driver call from
``repro.core.analysis``: the paper metrics, the scheduler summary, Jain's
index, the trace and report helpers, and the summaries of the paged
engine's events (page occupancy, prefill saturation, speculation, prefix
cache, SLO serving), of the fleet's (``fleet:*``/``fault:*``) and of live
KV migration (``ckpt:*``/``migrate:*``), of tensor-parallel serving's
``tp:collective`` ledger (:func:`tp_summary`), inter-token latency and KV
divergence.
Every module of ``repro_torch`` keeps its own copy of what it needs so that
it never imports ``repro``.
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


# --------------------------------------------------------------------------
# Serving-event summaries (copies of repro.core.analysis)
# --------------------------------------------------------------------------
def page_occupancy_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize the paged engine's KV-page occupancy trace series.

    The paged slot pool publishes one ``pages:occupancy`` event per decode-
    step boundary, tagged with ``pages_in_use`` / ``pages_free`` /
    ``num_pages`` / ``active_slots``.  This aggregates them into the memory
    block of the analysis workflow: utilization tells whether the HBM page
    budget (not compute) caps concurrency."""
    used: List[float] = []
    active: List[float] = []
    total = 0.0
    for s in spans:
        if s.name != "pages:occupancy":
            continue
        used.append(float(s.tags.get("pages_in_use", 0)))
        active.append(float(s.tags.get("active_slots", 0)))
        total = max(total, float(s.tags.get("num_pages", 0)))
    if not used:
        return {}
    cap = max(total, 1.0)
    return {
        "samples": float(len(used)),
        "num_pages": total,
        "mean_pages_in_use": sum(used) / len(used),
        "peak_pages_in_use": max(used),
        "mean_page_utilization": sum(used) / len(used) / cap,
        "peak_page_utilization": max(used) / cap,
        "mean_active_slots": sum(active) / len(active),
        "peak_active_slots": max(active),
    }


def page_occupancy_section(spans: Iterable[Span]) -> str:
    """Render the page-occupancy block as a report section (markdown-safe
    text table); empty string when no paged run was traced."""
    summary = page_occupancy_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def prefill_saturation_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize the packed-prefill pipeline's saturation trace series.

    The paged engine publishes one ``prefill:packed`` event per packed
    varlen launch, tagged with ``tokens`` (real prompt tokens), ``padding``
    (buffer slots spent on chunk/tail pad), ``chunks`` (coalesced spans),
    ``buffer`` (packed-buffer size) and ``budget`` (the per-boundary token
    knob).  This aggregates them into the prefill block of the analysis
    workflow: buffer utilization tells whether prompt traffic saturates the
    packed launches, chunks/launch how much cross-request coalescing the
    mix allows."""
    tokens: List[float] = []
    chunks: List[float] = []
    pad = 0.0
    buffer = 0.0
    total_s = 0.0
    for s in spans:
        if s.name != "prefill:packed":
            continue
        tokens.append(float(s.tags.get("tokens", 0)))
        chunks.append(float(s.tags.get("chunks", 0)))
        pad += float(s.tags.get("padding", 0))
        buffer = max(buffer, float(s.tags.get("buffer", 0)))
        total_s += s.duration
    if not tokens:
        return {}
    cap = max(buffer, 1.0) * len(tokens)
    total = sum(tokens)
    return {
        "launches": float(len(tokens)),
        "buffer_tokens": buffer,
        "prefill_tokens": total,
        "padded_tokens": pad,
        "mean_chunks_per_launch": sum(chunks) / len(chunks),
        "mean_buffer_utilization": total / cap,
        "peak_buffer_utilization": max(tokens) / max(buffer, 1.0),
        "pad_fraction": pad / max(total + pad, 1.0),
        "prefill_tokens_per_s": total / total_s if total_s > 0 else 0.0,
    }


def prefill_saturation_section(spans: Iterable[Span]) -> str:
    """Render the prefill-saturation block as a report section; empty string
    when no packed-prefill run was traced."""
    summary = prefill_saturation_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def spec_decode_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize the speculative-decoding verify trace series.

    The paged engine publishes one ``spec:verify`` event per multi-token
    verification launch, tagged with ``window`` (the k+1 launch width),
    ``slots`` (decoding slots scored), ``proposed`` / ``accepted`` (draft
    tokens in/out of the greedy exact-match acceptance test) and ``emitted``
    (tokens committed by the launch: one per slot plus every accepted
    draft).  This aggregates them into the decode block of the analysis
    workflow: the acceptance rate is whether prompt-lookup drafting pays,
    and ``mean_tokens_per_launch`` vs 1.0 is the decode-step amplification
    the verification kernel bought."""
    proposed = 0.0
    accepted = 0.0
    emitted = 0.0
    slots = 0.0
    launches = 0
    window = 0.0
    total_s = 0.0
    for s in spans:
        if s.name != "spec:verify":
            continue
        launches += 1
        proposed += float(s.tags.get("proposed", 0))
        accepted += float(s.tags.get("accepted", 0))
        emitted += float(s.tags.get("emitted", 0))
        slots += float(s.tags.get("slots", 0))
        window = max(window, float(s.tags.get("window", 0)))
        total_s += s.duration
    if not launches:
        return {}
    return {
        "spec_launches": float(launches),
        "window": window,
        "draft_proposed": proposed,
        "draft_accepted": accepted,
        "acceptance_rate": accepted / proposed if proposed else 0.0,
        "emitted_tokens": emitted,
        "mean_tokens_per_launch": emitted / max(slots, 1.0),
        "emitted_tokens_per_s": emitted / total_s if total_s > 0 else 0.0,
    }


def spec_decode_section(spans: Iterable[Span]) -> str:
    """Render the speculative-decoding block as a report section; empty
    string when no speculative run was traced."""
    summary = spec_decode_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def tp_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize tensor-parallel communication from ``tp:collective`` events.

    The paged engine publishes one event per sharded launch, tagged with
    ``phase`` (prefill / decode / verify), ``kind`` (psum vs
    reduce_scatter), ``tp``, ``count`` (collectives in the launch: two per
    transformer layer — the attention-output -> o-proj boundary and the MLP
    down-proj), ``payload_bytes`` (summed block-output bytes) and
    ``moved_bytes`` (ring-algorithm wire traffic per shard).  This
    aggregates them per boundary kind and phase so bottleneck attribution
    can rank communication against the compute stack levels."""
    tp = 0.0
    launches = 0
    count: Dict[str, float] = {}
    payload: Dict[str, float] = {}
    moved: Dict[str, float] = {}
    phase_moved: Dict[str, float] = {}
    for s in spans:
        if s.name != "tp:collective":
            continue
        launches += 1
        tp = max(tp, float(s.tags.get("tp", 0)))
        kind = str(s.tags.get("kind", "psum"))
        count[kind] = count.get(kind, 0.0) + float(s.tags.get("count", 0))
        payload[kind] = payload.get(kind, 0.0) + float(
            s.tags.get("payload_bytes", 0)
        )
        moved[kind] = moved.get(kind, 0.0) + float(s.tags.get("moved_bytes", 0))
        phase = str(s.tags.get("phase", ""))
        phase_moved[phase] = phase_moved.get(phase, 0.0) + float(
            s.tags.get("moved_bytes", 0)
        )
    if not launches:
        return {}
    out: Dict[str, float] = {"tp": tp, "sharded_launches": float(launches)}
    for kind in sorted(count):
        out[f"{kind}_count"] = count[kind]
        out[f"{kind}_payload_bytes"] = payload[kind]
        out[f"{kind}_moved_bytes"] = moved[kind]
    for phase in sorted(phase_moved):
        out[f"{phase}_moved_bytes"] = phase_moved[phase]
    out["total_moved_bytes"] = sum(moved.values())
    return out


def tp_section(spans: Iterable[Span]) -> str:
    """Render the tensor-parallel communication block as a report section;
    empty string when no sharded run was traced."""
    summary = tp_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def prefix_cache_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize the automatic prefix cache's trace series.

    The paged engine publishes one ``prefix:lookup`` event per admitted
    request (tagged ``prompt_tokens`` / ``cached_tokens`` / ``hit_pages`` /
    ``full_hit``), a ``prefix:cow`` event per copy-on-write page split, and
    a ``prefix:evict`` event per reclamation of cached-unreferenced pages
    (tagged ``pages``).  This aggregates them into the serving block of the
    analysis workflow: the hit rate and saved-token fraction say how much
    prefill the workload's shared prefixes amortize, COW copies how often
    shared last pages had to split, and evictions whether the page budget
    is recycling the cache under pressure."""
    prompt = 0.0
    cached = 0.0
    hit_pages = 0.0
    lookups = 0
    hits = 0
    full_hits = 0
    cow = 0
    evicted = 0.0
    for s in spans:
        if s.name == "prefix:lookup":
            lookups += 1
            p = float(s.tags.get("prompt_tokens", 0))
            c = float(s.tags.get("cached_tokens", 0))
            prompt += p
            cached += c
            hit_pages += float(s.tags.get("hit_pages", 0))
            if c > 0:
                hits += 1
            if s.tags.get("full_hit"):
                full_hits += 1
        elif s.name == "prefix:cow":
            cow += 1
        elif s.name == "prefix:evict":
            evicted += float(s.tags.get("pages", 0))
    if not lookups and not cow and not evicted:
        return {}
    return {
        "lookups": float(lookups),
        "hits": float(hits),
        "full_hits": float(full_hits),
        "hit_rate": hits / lookups if lookups else 0.0,
        "hit_pages": hit_pages,
        "prompt_tokens": prompt,
        "saved_prefill_tokens": cached,
        "saved_fraction": cached / prompt if prompt else 0.0,
        "cow_copies": float(cow),
        "evicted_pages": evicted,
    }


def prefix_cache_section(spans: Iterable[Span]) -> str:
    """Render the prefix-cache block as a report section; empty string when
    no prefix-cached run was traced."""
    summary = prefix_cache_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def fleet_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize a fault-tolerant fleet run from ``fleet:*``/``fault:*`` events.

    The fleet router publishes one ``fleet:commit`` per terminal completion
    (tagged ``duplicate`` / ``within_deadline`` / ``latency_s``), a
    ``fleet:death`` per worker crash or lease expiry (tagged ``requeued``),
    a ``fleet:recovered`` per drained death whose span duration IS the
    recovery time (death observed -> every orphaned request terminal), plus
    ``fleet:requeue`` / ``fleet:failed`` / ``fleet:shed`` / ``fleet:hedge``
    / ``fleet:degrade`` transitions, and the fault injector publishes one
    ``fault:*`` event per fired fault.  This aggregates them into the
    robustness block of the analysis workflow: goodput (completed within
    deadline over all admitted-and-terminal requests) says how much service
    the fleet retained through the faults, and recovery time how quickly
    orphaned work was replayed onto survivors."""
    commits = 0
    dups = 0
    within = 0
    failed = 0
    shed = 0
    requeued = 0
    deaths = 0
    hedged = 0
    degrades = 0
    max_level = 0
    rounds = 0
    peak_pressure = 0.0
    recovery: List[float] = []
    latencies: List[float] = []
    faults: Dict[str, int] = {}
    for s in spans:
        if s.name == "fleet:commit":
            if s.tags.get("duplicate"):
                dups += 1
            else:
                commits += 1
                within += int(bool(s.tags.get("within_deadline", 1)))
                latencies.append(float(s.tags.get("latency_s", 0.0)))
        elif s.name == "fleet:failed":
            failed += 1
        elif s.name == "fleet:shed":
            shed += 1
        elif s.name == "fleet:requeue":
            requeued += 1
        elif s.name == "fleet:death":
            deaths += 1
        elif s.name == "fleet:hedge":
            hedged += 1
        elif s.name == "fleet:recovered":
            recovery.append(s.duration)
        elif s.name == "fleet:degrade":
            degrades += 1
            max_level = max(max_level, int(s.tags.get("to", 0)))
        elif s.name == "fleet:round":
            rounds += 1
            peak_pressure = max(
                peak_pressure, float(s.tags.get("pressure", 0.0))
            )
        elif s.name.startswith("fault:") and s.name != "fault:pressure_release":
            kind = s.name.split(":", 1)[1]
            faults[kind] = faults.get(kind, 0) + 1
    terminal = commits + failed
    if not terminal and not deaths and not shed and not faults:
        return {}
    out = {
        "rounds": float(rounds),
        "completed": float(commits),
        "failed": float(failed),
        "shed": float(shed),
        "goodput": within / terminal if terminal else 0.0,
        "requeued": float(requeued),
        "deaths": float(deaths),
        "hedged": float(hedged),
        "duplicate_commits": float(dups),
        "degrade_transitions": float(degrades),
        "max_degrade_level": float(max_level),
        "peak_pressure": peak_pressure,
    }
    if latencies:
        out["latency_p90_ms"] = percentile(latencies, 90.0) * 1e3
    if recovery:
        out["recoveries"] = float(len(recovery))
        out["recovery_mean_s"] = sum(recovery) / len(recovery)
        out["recovery_max_s"] = max(recovery)
    for kind in sorted(faults):
        out[f"faults_{kind}"] = float(faults[kind])
    return out


def fleet_section(spans: Iterable[Span]) -> str:
    """Render the fleet-robustness block as a report section; empty string
    when no fleet run was traced."""
    summary = fleet_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def recovery_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize KV-migration recovery from ``ckpt:*``/``migrate:*`` events.

    The engine publishes one ``ckpt:save`` per slot snapshot (tagged
    ``bytes``/``pages``/``tokens``), one ``migrate:restore`` per orphan
    rebuilt from a snapshot on a survivor (the O(bytes) failover path) and
    one ``migrate:checksum_fail`` per snapshot whose per-page checksums
    failed verification (downgraded to replay — corrupted state is never
    served).  The router tags each ``fleet:death``/``fleet:drain`` with how
    many orphans are migrating vs how many prompt tokens the replay path
    must recompute.  Together: migrated vs recomputed tokens, bytes moved,
    and recovery time — the ledger deciding whether failover cost scales
    with bytes moved or tokens recomputed."""
    ckpts = 0
    ckpt_bytes = 0
    migrated = 0
    migrated_tokens = 0
    bytes_moved = 0
    checksum_failures = 0
    recomputed_tokens = 0
    drains = 0
    joins = 0
    recovery: List[float] = []
    restore_s: List[float] = []
    saw = False
    for s in spans:
        if s.name == "ckpt:save":
            saw = True
            ckpts += 1
            ckpt_bytes += int(s.tags.get("bytes", 0))
        elif s.name == "migrate:restore":
            saw = True
            migrated += 1
            migrated_tokens += int(s.tags.get("length", 0))
            bytes_moved += int(s.tags.get("bytes", 0))
            restore_s.append(s.duration)
        elif s.name == "migrate:checksum_fail":
            saw = True
            checksum_failures += 1
        elif s.name in ("fleet:death", "fleet:drain"):
            saw = saw or s.name == "fleet:drain"
            recomputed_tokens += int(s.tags.get("recompute_tokens", 0))
            if s.name == "fleet:drain":
                drains += 1
        elif s.name == "fleet:join":
            saw = True
            joins += 1
        elif s.name == "fleet:recovered":
            recovery.append(s.duration)
    if not saw:
        return {}
    out = {
        "checkpoints_saved": float(ckpts),
        "checkpoint_bytes": float(ckpt_bytes),
        "migrated": float(migrated),
        "migrated_tokens": float(migrated_tokens),
        "recomputed_prefill_tokens": float(recomputed_tokens),
        "bytes_moved": float(bytes_moved),
        "checksum_failures": float(checksum_failures),
        "drains": float(drains),
        "joins": float(joins),
    }
    total = migrated_tokens + recomputed_tokens
    if total:
        out["migrated_token_fraction"] = migrated_tokens / total
    if restore_s:
        out["restore_mean_s"] = sum(restore_s) / len(restore_s)
    if recovery:
        out["recovery_mean_s"] = sum(recovery) / len(recovery)
        out["recovery_max_s"] = max(recovery)
    return out


def recovery_section(spans: Iterable[Span]) -> str:
    """Render the KV-migration recovery block as a report section; empty
    string when no checkpoint/migration activity was traced."""
    summary = recovery_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def slo_summary(spans: Iterable[Span]) -> Dict[str, float]:
    """Summarize a multi-tenant SLO run from ``sched:tenant`` events.

    The scheduler and the paged engine publish one ``sched:tenant`` event
    per terminal request, tagged ``tenant`` / ``priority`` / ``status``
    (completed | failed | rejected) / ``latency_s`` / ``slo_ms`` /
    ``slo_ok`` (completed within its SLO) / ``tokens`` (admission cost).
    This aggregates them into the SLO block of the analysis workflow:
    goodput-under-SLO (the headline — completed-within-SLO over all
    terminal requests, so shed and late work both count against it),
    per-tenant p99 latency (``<tenant>_p99_ms``), shed/defer counters and
    Jain's fairness index over per-tenant *served* tokens — the number
    token buckets + weighted fair dequeue are supposed to hold near 1.0
    when tenants offer equal load."""
    terminal = 0
    completed = 0
    rejected = 0
    failed = 0
    slo_ok = 0
    deferred = 0
    latencies: Dict[str, List[float]] = {}
    served_tokens: Dict[str, float] = {}
    shed_by: Dict[str, float] = {}
    for s in spans:
        if s.name == "sched:defer":
            deferred += 1
            continue
        if s.name != "sched:tenant":
            continue
        tenant = str(s.tags.get("tenant", "default"))
        status = str(s.tags.get("status", "completed"))
        terminal += 1
        if status == "completed":
            completed += 1
            latencies.setdefault(tenant, []).append(
                float(s.tags.get("latency_s", 0.0))
            )
            served_tokens[tenant] = served_tokens.get(tenant, 0.0) + float(
                s.tags.get("tokens", 0.0)
            )
            if s.tags.get("slo_ok", True):
                slo_ok += 1
        elif status == "rejected":
            rejected += 1
            shed_by[tenant] = shed_by.get(tenant, 0.0) + 1.0
        else:
            failed += 1
    if not terminal:
        return {}
    out: Dict[str, float] = {
        "requests": float(terminal),
        "completed": float(completed),
        "rejected": float(rejected),
        "failed": float(failed),
        "deferred": float(deferred),
        "goodput_slo": slo_ok / terminal,
        "slo_attainment": slo_ok / completed if completed else 0.0,
        "jain_index": jain_index(list(served_tokens.values())),
        "tenants": float(len(set(latencies) | set(shed_by))),
    }
    for tenant in sorted(latencies):
        ls = latencies[tenant]
        out[f"{tenant}_p99_ms"] = percentile(ls, 99.0) * 1e3
        out[f"{tenant}_completed"] = float(len(ls))
        out[f"{tenant}_served_tokens"] = served_tokens.get(tenant, 0.0)
    for tenant in sorted(shed_by):
        out[f"{tenant}_shed"] = shed_by[tenant]
    return out


def slo_section(spans: Iterable[Span]) -> str:
    """Render the multi-tenant SLO block as a report section; empty string
    when no tenant-tagged run was traced."""
    summary = slo_summary(spans)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))


def itl_summary(itls_s: Sequence[float]) -> Dict[str, float]:
    """Inter-token latency block: the serving-quality metric the paged
    decode loop optimizes (speculative boundaries emit several tokens at
    one instant, so accepted drafts surface as near-zero gaps)."""
    if not itls_s:
        return {}
    return {
        "samples": float(len(itls_s)),
        "itl_mean_ms": sum(itls_s) / len(itls_s) * 1e3,
        "itl_p50_ms": percentile(itls_s, 50.0) * 1e3,
        "itl_p99_ms": percentile(itls_s, 99.0) * 1e3,
    }


def kv_divergence_summary(
    ref_tokens: Sequence[Sequence[int]],
    test_tokens: Sequence[Sequence[int]],
) -> Dict[str, float]:
    """Token-divergence block for the KV-quantization accuracy harness.

    Compares per-request greedy token streams from a quantized-KV serving
    run against the full-precision replay of the SAME workload (greedy
    decoding is deterministic per request, so any mismatch is caused by the
    quantization error, not scheduling).  Reports the exact-match fraction,
    the position of the first diverging token (later is better — the
    quantized run tracked the reference longer), and the mean matched-prefix
    fraction across requests.
    """
    if len(ref_tokens) != len(test_tokens):
        raise ValueError(
            f"mismatched request counts: {len(ref_tokens)} reference vs "
            f"{len(test_tokens)} test streams"
        )
    n = len(ref_tokens)
    if not n:
        return {}
    exact = 0
    first_div: List[int] = []
    prefix_frac: List[float] = []
    for r, t in zip(ref_tokens, test_tokens):
        r = [int(x) for x in r]
        t = [int(x) for x in t]
        m = min(len(r), len(t))
        i = next((j for j in range(m) if r[j] != t[j]), m)
        if i == m and len(r) == len(t):
            exact += 1
        else:
            first_div.append(i)
        prefix_frac.append(i / max(len(r), 1))
    out = {
        "requests": float(n),
        "exact_matches": float(exact),
        "exact_match_fraction": exact / n,
        "diverged_requests": float(n - exact),
        "divergence_fraction": (n - exact) / n,
        "matched_prefix_fraction": float(sum(prefix_frac) / n),
    }
    if first_div:
        out["first_divergence_min"] = float(min(first_div))
        out["first_divergence_mean"] = float(sum(first_div) / len(first_div))
    return out


def kv_divergence_section(
    ref_tokens: Sequence[Sequence[int]],
    test_tokens: Sequence[Sequence[int]],
) -> str:
    """Render the KV-quantization divergence block as a report section;
    empty string when there are no requests to compare."""
    summary = kv_divergence_summary(ref_tokens, test_tokens)
    if not summary:
        return ""
    rows = [{"metric": k, "value": v} for k, v in summary.items()]
    return comparison_table(rows, ("metric", "value"))



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
