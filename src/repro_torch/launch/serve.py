"""Serving driver of the port: ``python -m repro_torch.launch.serve``.

The flags of ``repro.launch.serve`` that the port supports so far, plus
``--device``, ``--dtype``, ``--seed``, ``--full`` and ``--prompt-len-min``.
Three engines (``--engine``, or its alias ``--mode``):

* ``paged`` (the default here, so existing callers are unchanged; the JAX
  driver defaults to ``static``): paged-KV continuous batching.
  ``--prefill-mode packed`` (default) packs every prefilling slot's next
  span into one varlen-prefill launch of ``--prefill-budget`` tokens;
  ``chunked`` runs one ``--prefill-chunk``-token chunk per slot.
  ``--prefix-cache on`` (the default, as in the reference) shares full
  prompt pages across requests with copy-on-write; ``--prefix-len`` makes
  a shared-prefix workload (``--prefix-share``, ``--prefix-groups``).
  ``--overcommit`` above 1 admits past the worst-case page commitment and
  preempts when the pool runs dry.  ``--tenants``, ``--priority-mix``,
  ``--deadline-ms``, ``--slo-ms`` and ``--fairness`` drive multi-tenant
  admission.  ``--spec-k``/``--spec-ngram`` turn on speculative decoding,
  ``--kv-dtype int8|fp8`` a quantized pool.  The run is traced and prints
  the reference's page-occupancy, prefill-saturation, speculative-decoding,
  prefix-cache and multi-tenant SLO sections.
  ``--fleet N`` serves the same requests over N paged workers (one model,
  one page pool each) behind the fault-tolerant ``FleetRouter``:
  ``--fault-plan`` scripts crashes, stalls, pool pressure and corrupted
  checkpoints, ``--drain-at`` planned removals, ``--recovery migrate``
  restores an orphan from its worker's latest KV checkpoint (taken every
  ``--checkpoint-every`` decode steps) where ``replay`` prefills it again,
  and ``--retries``/``--lease-ttl-s`` bound requeues and heartbeats; the
  run prints each request's outcome and the fleet and KV-migration
  sections.
* ``static``: Poisson arrivals at ``--rate-hz`` go through the threaded
  request scheduler, which coalesces up to ``--engine-batch`` requests
  within ``--batch-timeout-ms`` into one ``generate`` batch on the dense
  cache; prints each batch's prefill and decode times and a summary.
* ``continuous``: slot-based continuous batching on the dense cache
  (``serve_continuous``) over the same prompts, offline; prints each
  request's TTFT and tokens/s and a summary.

``--arch`` picks the model: the MoE ``qwen3-moe-30b-a3b`` and the dense
``deepseek-67b``, ``granite-20b``, ``glm4-9b``, ``gemma2-27b`` and
``chameleon-34b`` (every engine); ``llama4-maverick-400b-a17b`` (MoE
layers interleaved with dense ones) and ``mamba2-130m`` (SSM) on
``static`` and ``continuous`` only: neither has a paged layout, so
``--engine paged`` stops with the reference's reason.  The enc-dec
``whisper-large-v3`` runs ``static`` only, each batch over zero encoder
frames ``(batch, 1500, 1280)`` as the reference driver feeds it;
``--engine continuous`` and ``paged`` raise the engine's
``NotImplementedError``, as the reference's continuous engine does.  A MoE model's
header and report name its experts, top k and capacity factor.  Runs on
``cuda`` unless ``--device cpu`` is given.  The model config is the
reduced one unless ``--full`` asks for the published widths and depth;
weights are random, from ``--seed``.  ``--full`` refuses a model whose
weights alone exceed the card's memory: ``deepseek-67b`` (125.6 GiB in
bf16) and ``llama4-maverick-400b-a17b`` (740.8 GiB) run reduced only on
one 80 GB card; the others fit at full width (``qwen3-moe-30b-a3b``:
56.9 GiB).
Every run prints the reference's knobs header (``[serve] engine=paged
kv_dtype=... page_size=... spec_k=... prefix_cache=... tp=1``); with
``--evaldb PATH`` its summary and those knobs land in that evaluation
database as one record (backend ``torch``, scenario ``serve-<engine>``, or
``serve-fleet<N>`` with a fleet, whose knobs then carry ``--recovery`` and
``--checkpoint-every``), which either package's ``EvalDB`` reads.
Prompts are random tokens with lengths drawn uniformly from
``[--prompt-len-min, --prompt-len]`` (with ``--tenants``, each tenant's
``prompt`` length; with ``--prefix-len``, ``--prompt-len`` tokens).

``--tp N`` (paged engine only, as in the reference) serves on ``N`` ranks
started by :func:`repro_torch.launch.mesh.run_ranks` (gloo; on the card
every rank on its own device, or all of them sharing one card), each
holding its heads, columns, experts and vocabulary share of the weights
(``serve_rules``) and ``kv_heads / N`` heads of every page;
``--rs-block-outputs`` reduce-scatters a packed prefill's block outputs
over tokens.  The header prints the requested and effective tp (1 where
the heads do not split: every rank then serves the whole model), the
report adds the tensor-parallel collectives section, and the metrics and
the evaldb record carry ``tp``; rank 0 prints and records.  ``--fleet``
takes no ``--tp``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import random
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, list_archs
from ..core.analysis import (
    fleet_section,
    latency_summary,
    page_occupancy_section,
    percentile,
    prefill_saturation_section,
    prefix_cache_section,
    recovery_section,
    slo_section,
    spec_decode_section,
    tp_section,
)
from ..core.evaldb import EvalDB, EvaluationRecord
from ..core.manifest import EngineKnobs
from ..core.tracing import Tracer, TracingServer
from ..core.workload import (
    MultiTenantLoad, PoissonLoad, Request, SharedPrefixLoad, shared_prefix_prompts,
)
from ..device import DTYPES, resolve_device
from ..kernels.kvquant import KV_DTYPES
from ..models.lm import NOT_PAGED, NOT_PAGED_ENCDEC, build_model
from ..serve.engine import NOT_CONTINUOUS_ENCDEC, ServeRequest, ServingEngine
from ..serve.faults import FaultPlan
from ..serve.fleet import FleetConfig, FleetRouter
from ..serve.scheduler import PRIORITY_TIERS, RequestScheduler, SchedulerConfig, TenantSpec
from ..sharding.specs import serve_rules, tp_degree
from .mesh import make_host_mesh, run_ranks


def make_requests(n: int, lo: int, hi: int, max_new_tokens: int, vocab: int,
                  seed: int) -> List[ServeRequest]:
    """``n`` random prompts with lengths uniform in ``[lo, hi]``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [
        ServeRequest(
            request_id=i,
            prompt=rng.integers(0, vocab, (int(L),)).astype(np.int32),
            max_new_tokens=max_new_tokens,
        )
        for i, L in enumerate(lens)
    ]


def _parse_tenants(s: str):
    """Parse ``--tenants`` (a copy of the reference's): semicolon-separated
    tenants, each ``name[,key=value...]`` with keys ``prio`` (tier index or
    name), ``weight``, ``rate`` (bucket refill tokens/s), ``burst`` (bucket
    depth), ``hz`` (arrival rate), ``slo`` (ms), ``prompt``/``gen`` (token
    shape).  Example::

        --tenants "prem,prio=2,weight=2,hz=20;best,prio=0,rate=400,burst=120"
    """
    out = []
    for chunk in s.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = [p.strip() for p in chunk.split(",")]
        t = {"name": parts[0]}
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            k = k.strip()
            v = v.strip()
            field, conv = _TENANT_KEYS.get(k, (None, None))
            if field is None:
                raise ValueError(f"unknown tenant key {k!r} in {chunk!r}")
            try:
                t[field] = conv(v)
            except ValueError:
                raise ValueError(f"bad tenant value {k}={v!r} in {chunk!r}") from None
        out.append(t)
    return out


def _parse_priority(v: str) -> int:
    return PRIORITY_TIERS.index(v) if v in PRIORITY_TIERS else int(v)


_TENANT_KEYS = {
    "prio": ("priority", _parse_priority),
    "priority": ("priority", _parse_priority),
    "weight": ("weight", float),
    "rate": ("rate_tokens_per_s", float),
    "burst": ("burst_tokens", float),
    "hz": ("rate_hz", float),
    "slo": ("slo_ms", float),
    "prompt": ("prompt_len", int),
    "gen": ("gen_tokens", int),
}


def _parse_priority_mix(s: str):
    """Parse ``--priority-mix``: ``tier=frac`` pairs, e.g.
    ``best_effort=0.25,standard=0.5,premium=0.25``."""
    out = {}
    for kv in s.split(","):
        k, _, v = kv.partition("=")
        out[k.strip()] = float(v)
    return out


def _tagged_requests(args, load, prompts) -> List[ServeRequest]:
    """Engine requests carrying each workload request's tenant tags (a copy
    of the reference's)."""
    reqs = []
    for i, (req, p) in enumerate(zip(load, prompts)):
        tags = req.tags
        reqs.append(ServeRequest(
            request_id=i, prompt=p, max_new_tokens=args.max_new_tokens,
            tenant=str(tags.get("tenant", "default")),
            priority=int(tags.get("priority", 1)),
            slo_ms=float(tags.get("slo_ms", 0.0) or args.slo_ms),
        ))
    return reqs


def workload_requests(args, vocab: int) -> List[ServeRequest]:
    """The run's requests: with ``--tenants`` superposed per-tenant Poisson
    streams (each tenant's prompt length, tier and SLO in its tags); with
    ``--prefix-len`` the shared-prefix mix, whose same-group prompts share
    their first ``--prefix-len`` tokens; otherwise :func:`make_requests`.
    ``--priority-mix`` then stamps tiers onto a single-tenant load by a
    seeded draw."""
    rng = np.random.default_rng(args.seed)
    if args.tenants:
        tenant_dicts = _parse_tenants(args.tenants)
        for t in tenant_dicts:
            t.setdefault("rate_hz", args.rate_hz / len(tenant_dicts))
            t.setdefault("slo_ms", args.slo_ms)
            t.setdefault("prompt_len", args.prompt_len)
            t.setdefault("gen_tokens", args.max_new_tokens)
        load = list(MultiTenantLoad(args.requests, tenant_dicts, seed=args.seed).requests())
        prompts = [rng.integers(0, vocab, (int(r.tags.get("prompt_len") or args.prompt_len),)
                                ).astype(np.int32) for r in load]
    elif args.prefix_len > 0:
        load = list(SharedPrefixLoad(
            args.requests, rate_hz=args.rate_hz, prefix_len=args.prefix_len,
            suffix_len=args.prompt_len - args.prefix_len, share_ratio=args.prefix_share,
            num_groups=args.prefix_groups, seed=args.seed,
        ).requests())
        prompts = shared_prefix_prompts(load, vocab, seed=args.seed)
    else:
        lo = args.prompt_len_min or args.prompt_len
        prompts = [r.prompt for r in make_requests(args.requests, lo, args.prompt_len,
                                                   args.max_new_tokens, vocab, args.seed)]
        load = [Request(request_id=i, arrival_s=0.0) for i in range(len(prompts))]
    if args.priority_mix and not args.tenants:
        mix = _parse_priority_mix(args.priority_mix)
        tiers = [PRIORITY_TIERS.index(k) if k in PRIORITY_TIERS else int(k) for k in mix]
        weights = [float(v) for v in mix.values()]
        mrng = random.Random(args.seed)
        for r in load:
            r.tags["priority"] = mrng.choices(tiers, weights)[0]
    return _tagged_requests(args, load, prompts)


@dataclass
class StaticRun:
    """One static serve: per request (in submission order) its tokens,
    latency (arrival to batch end) and TTFT (arrival to its batch's prefill
    end); per ``generate`` batch its size, real prompt tokens, prefill and
    decode seconds; the tokens each request asked for, the wall time and
    the scheduler's stats."""

    tokens: List[np.ndarray]
    latencies_s: List[float]
    ttfts_s: List[float]
    batches: List[tuple]
    max_new_tokens: int
    wall_s: float
    sched_stats: Dict[str, float]


def serve_static(engine: ServingEngine, prompts: Sequence[np.ndarray], arrivals_s: Sequence[float],
                 max_new_tokens: int, batch_timeout_ms: float, log=print) -> StaticRun:
    """Submit ``prompts`` at their arrival offsets (seconds from the start)
    to a threaded :class:`RequestScheduler` whose micro-batches of up to
    ``engine.max_batch`` requests run ``engine.generate``; an enc-dec
    model's batches take zero encoder frames, as the reference driver
    gives them."""
    batches: List[tuple] = []
    cfg = engine.model.cfg
    frames = (np.zeros((engine.max_batch, cfg.encoder_seq, cfg.d_model), np.float32)
              if cfg.family == "encdec" else None)

    def execute(batch):
        ps = [r.payload for r in batch]
        extra = None if frames is None else {"frames": frames[:len(ps)]}
        res = engine.generate(ps, max_new_tokens, extra_inputs=extra)
        batches.append((len(ps), sum(len(p) for p in ps), res.prefill_s, res.decode_s))
        log(f"[serve] batch of {len(ps)}: prefill {res.prefill_s * 1e3:.1f} ms, "
            f"decode {res.decode_s * 1e3:.1f} ms ({res.tokens_per_s:,.1f} tok/s)")
        return [(res.tokens[i], res.first_token_s - r.arrival_s) for i, r in enumerate(batch)]

    sched = RequestScheduler(execute, SchedulerConfig(
        max_batch=engine.max_batch, batch_timeout_ms=batch_timeout_ms)).start()
    t_start = time.perf_counter()
    futs = []
    try:
        for arrival, prompt in zip(arrivals_s, prompts):
            now = time.perf_counter() - t_start
            if arrival > now:
                time.sleep(arrival - now)
            futs.append(sched.submit(payload=prompt))
        out = [f.result() for f in futs]
    finally:
        sched.stop()
    return StaticRun(
        tokens=[tok for tok, _ in out],
        latencies_s=[f.request.latency_s for f in futs],
        ttfts_s=[ttft for _, ttft in out],
        batches=batches,
        max_new_tokens=max_new_tokens,
        wall_s=time.perf_counter() - t_start,
        sched_stats=sched.stats(),
    )


def _metrics(latencies_s, ttfts_s, requests, generated, wall_s, prefill_tokens, prefill_s,
             steps, decode_tokens, decode_s) -> Dict[str, float]:
    """The end-to-end metrics every engine reports: latency summary, TTFT
    p50/p99, prefill tok/s over real prompt tokens and prefill wall time,
    decode tok/s and mean step ms over decode wall time."""
    ttfts = [t * 1e3 for t in ttfts_s]
    return {
        **latency_summary(latencies_s),
        "requests": requests,
        "generated_tokens": generated,
        "wall_s": wall_s,
        "tokens_per_s": generated / wall_s if wall_s > 0 else float("inf"),
        "prefill_tok_per_s": prefill_tokens / prefill_s if prefill_s else 0.0,
        "decode_steps": steps,
        "decode_step_ms": decode_s / steps * 1e3 if steps else 0.0,
        "decode_tok_per_s": decode_tokens / decode_s if decode_s else 0.0,
        "ttft_p50_ms": percentile(ttfts, 50.0),
        "ttft_p99_ms": percentile(ttfts, 99.0),
    }


def static_metrics(run: StaticRun) -> Dict[str, float]:
    """End-to-end metrics of a static serve.  Every batch runs
    ``max_new_tokens`` lockstep decode steps, and all its rows decode."""
    n = len(run.tokens)
    steps = len(run.batches) * run.max_new_tokens
    return _metrics(run.latencies_s, run.ttfts_s, n, n * run.max_new_tokens, run.wall_s,
                    sum(b[1] for b in run.batches), sum(b[2] for b in run.batches), steps,
                    n * run.max_new_tokens, sum(b[3] for b in run.batches))


def engine_metrics(stats) -> Dict[str, float]:
    """End-to-end metrics of a ``serve_continuous`` (``ContinuousStats``) or
    ``serve_paged`` (``PagedStats``) run, over its completed requests.  Each
    request's first token comes from its prefill (a full prefix hit's from
    its first decode step), the rest from decode steps."""
    res = [r for r in stats.results if r.status == "completed"]
    return _metrics([r.latency_s for r in res], [r.ttft_s for r in res], len(res),
                    stats.total_tokens, stats.wall_s, stats.prefill_tokens, stats.prefill_s,
                    stats.steps, stats.total_tokens - len(res), stats.decode_s)


def _static(engine, reqs, args) -> Dict[str, float]:
    load = PoissonLoad(len(reqs), args.rate_hz, seed=args.seed).requests()
    run = serve_static(engine, [r.prompt for r in reqs], [r.arrival_s for r in load],
                       args.max_new_tokens, args.batch_timeout_ms)
    return {**static_metrics(run), **{f"sched_{k}": v for k, v in run.sched_stats.items()}}


def _print_requests(stats) -> None:
    for r in stats.results:
        if r.status != "completed":
            print(f"[serve] req {r.request_id}: {r.status} ({r.reason})")
            continue
        print(f"[serve] req {r.request_id}: slot {r.slot} (admitted step "
              f"{r.admit_step}), ttft {r.ttft_s * 1e3:.1f} ms, "
              f"{r.tokens_per_s:,.1f} tok/s")


def _continuous(engine, reqs, args) -> Dict[str, float]:
    stats = engine.serve_continuous(reqs, num_slots=args.engine_batch)
    _print_requests(stats)
    return {**engine_metrics(stats), "mean_slot_occupancy": stats.mean_slot_occupancy}


# the report sections of a traced paged run, as the reference driver prints them
PAGED_SECTIONS = (
    ("page occupancy", page_occupancy_section),
    ("prefill saturation", prefill_saturation_section),
    ("speculative decoding", spec_decode_section),
    ("prefix cache", prefix_cache_section),
    ("tensor-parallel collectives", tp_section),
    ("multi-tenant SLO", slo_section),
)


def _paged(engine, reqs, args) -> Dict[str, float]:
    tenant_dicts = _parse_tenants(args.tenants) if args.tenants else []
    server = TracingServer()
    stats = engine.serve_paged(
        reqs, num_slots=args.engine_batch, page_size=args.page_size,
        num_pages=args.num_pages or None,
        prefill_chunk=args.prefill_chunk or None,
        overcommit=args.overcommit,
        prefill_mode=args.prefill_mode,
        prefill_budget=args.prefill_budget or None,
        spec_k=args.spec_k, spec_ngram=args.spec_ngram,
        prefix_cache=args.prefix_cache == "on",
        deadline_ms=args.deadline_ms,
        tenants=[TenantSpec.from_dict(t) for t in tenant_dicts] or None,
        fairness=args.fairness == "on",
        tracer=Tracer("serve-paged", server),
    )
    _print_requests(stats)
    spans = server.timeline("serve-paged")
    for title, section in PAGED_SECTIONS:
        text = section(spans)
        if text:
            print(f"[serve] {title}:")
            for line in text.splitlines():
                print(f"[serve]   {line}")
    return {
        **engine_metrics(stats),
        "completed": stats.completed,
        "rejected": stats.rejected,
        "deferred": stats.deferred,
        "goodput": stats.goodput,
        "preemptions": stats.preemptions,
        "prefill_launches": stats.prefill_launches,
        "prefill_tokens": stats.prefill_tokens,
        "prompt_tokens_admitted": stats.prompt_tokens_admitted,
        "saved_prefill_tokens": stats.saved_prefill_tokens,
        "prefill_tokens_dropped": stats.prefill_tokens_dropped,
        "cow_copies": stats.cow_copies,
        "cache_evictions": stats.cache_evictions,
        "peak_pages_in_use": stats.peak_pages_in_use,
        "kv_bytes_per_token": stats.kv_bytes_per_token,
        "itl_p50_ms": stats.itl_p50_ms,
        "itl_p99_ms": stats.itl_p99_ms,
        "tp": stats.tp,
        **stats.spec_stats,
    }


def _fleet(engines, reqs, args) -> Dict[str, float]:
    """The fault-tolerant fleet: ``engines`` (paged workers) behind the
    ``FleetRouter``, with the reference driver's lines and summary."""
    tenant_dicts = _parse_tenants(args.tenants) if args.tenants else []
    server = TracingServer()
    tracer = Tracer("serve-fleet", server)
    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else FaultPlan()
    if plan:
        print(f"[serve] fault plan: {plan.describe()}")
    router = FleetRouter(
        engines,
        FleetConfig(
            deadline_s=args.deadline_ms / 1e3,
            max_retries=args.retries,
            lease_ttl_s=args.lease_ttl_s,
            fairness=args.fairness == "on",
            recovery=args.recovery,
            checkpoint_every=args.checkpoint_every,
        ),
        tenants=[TenantSpec.from_dict(t) for t in tenant_dicts],
        engine_kwargs=dict(
            num_slots=args.engine_batch,
            page_size=args.page_size,
            num_pages=args.num_pages or None,
            prefill_chunk=args.prefill_chunk or None,
            overcommit=args.overcommit,
            prefill_mode=args.prefill_mode,
            prefill_budget=args.prefill_budget or None,
            spec_k=args.spec_k,
            spec_ngram=args.spec_ngram,
            prefix_cache=args.prefix_cache == "on",
        ),
        fault_plan=plan,
        tracer=tracer,
    )
    for worker, step in _parse_drains(args.drain_at):
        router.drain(worker, step)
    stats = router.serve(reqs)
    for r in stats.results:
        tail = f"{len(r.tokens)} tokens" if r.status == "completed" else f"reason={r.reason}"
        print(f"[serve] req {r.request_id}: {r.status} on worker {r.worker} "
              f"after {r.attempts} attempt(s), {tail}")
    spans = server.timeline("serve-fleet")
    for title, section in (("fleet robustness", fleet_section),
                           ("KV-migration recovery", recovery_section)):
        text = section(spans)
        if text:
            print(f"[serve] {title}:")
            for line in text.splitlines():
                print(f"[serve]   {line}")
    latencies = [r.latency_s for r in stats.results if r.status == "completed"]
    summary = latency_summary(latencies) if latencies else {}
    summary.update({
        "tokens_per_s": stats.throughput_tps,
        "fleet_workers": float(stats.num_workers),
        "rounds": float(stats.rounds),
        "completed": float(stats.completed),
        "failed": float(stats.failed),
        "rejected": float(stats.rejected),
        "deaths": float(stats.deaths),
        "requeued": float(stats.requeued),
        "hedged": float(stats.hedged),
        "duplicate_commits": float(stats.duplicate_commits),
        "goodput": stats.goodput,
        "max_degrade_level": float(stats.max_degrade_level),
        "migrated": float(stats.migrated),
        "migrated_tokens": float(stats.migrated_tokens),
        "recomputed_prefill_tokens": float(stats.recomputed_prefill_tokens),
        "bytes_moved": float(stats.bytes_moved),
        "checkpoints_saved": float(stats.checkpoints_saved),
        "checksum_failures": float(stats.checksum_failures),
        "drains": float(stats.drains),
        "joins": float(stats.joins),
    })
    if stats.recovery_s:
        summary["recovery_max_s"] = max(stats.recovery_s)
    return summary


def _parse_drains(text: str) -> List[tuple]:
    """Parse ``--drain-at``: comma-separated ``worker:step`` items."""
    out = []
    for item in filter(None, (t.strip() for t in text.split(","))):
        try:
            worker, step = item.split(":")
            out.append((int(worker), int(step)))
        except ValueError:
            raise ValueError(f"bad --drain-at item {item!r} (expected worker:step)") from None
    return out


ENGINES = {"paged": _paged, "static": _static, "continuous": _continuous}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: the reduced config); "
                         "refused where the weights alone exceed the card's memory: "
                         "deepseek-67b and llama4-maverick-400b-a17b run reduced only on "
                         "one 80 GB card")
    ap.add_argument("--engine", "--mode", dest="engine", default="paged", choices=list(ENGINES),
                    help="paged: paged-KV continuous batching; static: the request "
                         "scheduler batching generate() on a dense cache; continuous: "
                         "slot-based continuous batching on a dense cache")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain path)")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="weights, activations and KV cache (default: bfloat16 on "
                         "cuda, float32 on cpu)")
    ap.add_argument("--seed", type=int, default=0, help="weights, prompts and arrivals")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate-hz", type=float, default=20.0,
                    help="Poisson arrival rate of the static engine's requests")
    ap.add_argument("--batch-timeout-ms", type=float, default=10.0,
                    help="static engine: how long a non-full batch waits for arrivals")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="longest prompt (tokens)")
    ap.add_argument("--prompt-len-min", type=int, default=0,
                    help="shortest prompt (0 = --prompt-len: all equal)")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--engine-batch", type=int, default=4,
                    help="decode slots (paged, continuous) or largest batch (static)")
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged); the prefill-length and "
                         "decode-bound bucket floor (static, continuous)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="global KV page pool size (0 = slots * max pages + 1)")
    ap.add_argument("--prefill-mode", default="packed", choices=["packed", "chunked"],
                    help="packed: one token-packed varlen launch per boundary; chunked: "
                         "one batch-1 chunk per prefilling slot")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill tokens per slot and boundary (0 = 4 pages)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="packed-prefill tokens per boundary (0 = 4 prefill chunks)")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="paged admission overcommit factor (>1 admits past the worst-case "
                         "page commitment; preemption is the valve)")
    ap.add_argument("--prefix-cache", default="on", choices=["on", "off"],
                    help="automatic prefix caching: share committed KV pages across requests "
                         "with common prompt prefixes (copy-on-write on append)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared-prefix workload: tokens of common prompt prefix "
                         "(0 = independent random prompts)")
    ap.add_argument("--prefix-share", type=float, default=0.75,
                    help="fraction of requests reusing a shared prefix")
    ap.add_argument("--prefix-groups", type=int, default=1,
                    help="distinct shared prefixes in the workload")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="run TTL from submit: late completions fall out of goodput, work "
                         "still queued past it is rejected (0 = none)")
    ap.add_argument("--tenants", default="",
                    help="multi-tenant mix: semicolon-separated 'name[,prio=T][,weight=W]"
                         "[,rate=TOK/S][,burst=TOK][,hz=QPS][,slo=MS][,prompt=N][,gen=N]' "
                         "entries (requires --engine paged)")
    ap.add_argument("--priority-mix", default="",
                    help="tier fractions for a single-tenant load, e.g. "
                         "'best_effort=0.25,standard=0.5,premium=0.25' (ignored with "
                         "--tenants)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request latency SLO for goodput accounting (0 = none)")
    ap.add_argument("--fairness", default="on", choices=["on", "off"],
                    help="tenant-fair admission (token buckets, priority tiers, weighted "
                         "fair dequeue); off = FIFO")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft depth: prompt lookup proposes up to k "
                         "tokens per slot, one verify step scores all k+1 (0 = off)")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="prompt-lookup n-gram match length for drafting")
    ap.add_argument("--kv-dtype", default=None, choices=sorted(KV_DTYPES),
                    help="store the KV pool as int8/fp8 codes with float32 per-row "
                         "scales (default: the pool in --dtype)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="fault-tolerant fleet: run N paged workers behind the FleetRouter "
                         "(load balancing, requeue-on-death, graceful degradation; "
                         "0 = single engine)")
    ap.add_argument("--retries", type=int, default=2,
                    help="fleet requeues per request after a worker death before the "
                         "request is failed")
    ap.add_argument("--lease-ttl-s", type=float, default=30.0,
                    help="fleet worker heartbeat lease TTL; a worker that misses renewal "
                         "past the TTL is treated as dead")
    ap.add_argument("--fault-plan", default="",
                    help="scripted fault injection, e.g. 'crash@1:2,stall@0:3:0.5,"
                         "pressure@2:1:8x4' (kind@worker:step[:arg]; corrupt@W:S flips bytes "
                         "in worker W's latest KV checkpoint at step S; empty = no faults)")
    ap.add_argument("--recovery", default="migrate", choices=["replay", "migrate"],
                    help="fleet orphan recovery: migrate restores the latest KV checkpoint "
                         "on a survivor (O(bytes) failover, bit-identical continuation); "
                         "replay re-prefills from the prompt (also the fallback when no "
                         "checkpoint exists or checksums fail)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="decode steps between KV page checkpoints on each fleet worker "
                         "(0 = none: only planned drains migrate; requires --recovery "
                         "migrate to matter)")
    ap.add_argument("--drain-at", default="",
                    help="planned elasticity: comma-separated worker:step items, e.g. '1:4' "
                         "drains worker 1 at boundary step 4; every live slot migrates with "
                         "zero recompute before the worker is removed")
    ap.add_argument("--evaldb", default="",
                    help="insert the run's summary and engine knobs as one evaluation "
                         "record into this sqlite file (default: none)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree over the mesh 'model' axis: that many ranks "
                         "(gloo), each with its share of the heads, columns, experts and "
                         "vocabulary (1 = one process; --engine paged only)")
    ap.add_argument("--rs-block-outputs", action="store_true",
                    help="reduce-scatter block outputs instead of all-reduce on "
                         "seq-shardable (packed prefill) launches")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    lo = args.prompt_len_min or args.prompt_len
    if not 1 <= lo <= args.prompt_len:
        ap.error("need 1 <= --prompt-len-min <= --prompt-len")
    if args.engine != "paged" and (args.spec_k or args.kv_dtype):
        ap.error("--spec-k and --kv-dtype need --engine paged")
    if args.rate_hz <= 0:
        ap.error("--rate-hz must be positive")
    if args.prefix_len > 0 and args.prefix_len >= args.prompt_len:
        ap.error(f"--prefix-len {args.prefix_len} must be smaller than --prompt-len "
                 f"{args.prompt_len} (the shared prefix is a strict prefix; every prompt "
                 f"keeps a unique tail)")
    if args.fleet > 0 and args.engine != "paged":
        ap.error("--fleet requires --engine paged (the fleet routes over paged workers)")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.tp > 1 and args.engine != "paged":
        ap.error("--tp > 1 requires --engine paged")
    if args.tp > 1 and args.fleet > 0:
        ap.error("--tp > 1 with --fleet is not supported (each fleet worker is one process)")
    try:
        _parse_drains(args.drain_at)
        FaultPlan.parse(args.fault_plan)
    except ValueError as e:
        ap.error(str(e))
    if args.tenants and args.engine != "paged":
        ap.error("--tenants requires --engine paged (tenant-aware admission lives in the "
                 "paged engine)")
    if args.tenants:
        try:
            _parse_tenants(args.tenants)
        except ValueError as e:
            ap.error(str(e))
    if args.priority_mix:
        try:
            _parse_priority_mix(args.priority_mix)
        except ValueError as e:
            ap.error(f"bad --priority-mix {args.priority_mix!r}: {e}")

    device = resolve_device(args.device)
    if args.tp > 1:
        # every rank runs the rest of this function on its own device; rank
        # 0's lines come back and are printed here
        rc, text = run_ranks(_serve_rank, args.tp,
                             list(sys.argv[1:] if argv is None else argv), device=device)
        print(text, end="")
        return rc
    return _serve(ap, args, device)


def _serve_rank(rank: int, device: torch.device, argv: Optional[List[str]]):
    """One rank of a ``--tp`` run: the driver on ``device`` with its lines
    captured; returns (exit code, rank 0's lines)."""
    ap = _parser()
    args = ap.parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _serve(ap, args, device, rank=rank)
    return rc, buf.getvalue()


def _serve(ap, args, device: torch.device, rank: int = 0) -> int:
    """The driver's run on ``device`` (at ``--tp`` above 1, as rank
    ``rank`` of a world that ``run_ranks`` started)."""
    if device.type == "cuda":
        # fp32 matmuls stay full fp32 (no TF32) wherever the port runs fp32
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.family == "encdec" and args.engine != "static":
        raise NotImplementedError(NOT_PAGED_ENCDEC if args.engine == "paged"
                                  else NOT_CONTINUOUS_ENCDEC)
    model = build_model(cfg, device=device, dtype=args.dtype)
    if args.engine == "paged" and (model.stateful or model.interleaved):
        ap.error(f"--engine paged with {cfg.name}: {NOT_PAGED}")
    rules = None
    if args.tp > 1:
        rules = serve_rules(make_host_mesh(args.tp), rs_block_outputs=args.rs_block_outputs)
    # at an effective tp above 1 each rank draws only its shards
    sharded = tp_degree(rules, cfg.num_heads, cfg.num_kv_heads) > 1
    try:
        params = model.init(seed=args.seed, rules=rules if sharded else None, rank=rank)
    except MemoryError as e:
        ap.error(f"{e} (drop --full)")
    def make_engine():
        return ServingEngine(model, params, max_batch=args.engine_batch,
                             max_seq=args.max_seq, page_size=args.page_size,
                             device=device, kv_dtype=args.kv_dtype, rules=rules)

    engine = make_engine()
    # the engine knobs this run serves under, as the reference's header and
    # evaldb record give them; the recovery knobs are the fleet's, so a
    # single engine keeps replay and no checkpoints
    knobs = EngineKnobs(
        engine=args.engine,
        kv_dtype=engine._kv_dtype_name(),
        page_size=args.page_size if args.engine == "paged" else 0,
        spec_k=args.spec_k if args.engine == "paged" else 0,
        prefix_cache=args.engine == "paged" and args.prefix_cache == "on",
        tp=engine.tp,
        recovery=args.recovery if args.fleet else "replay",
        checkpoint_every=args.checkpoint_every if args.fleet else 0,
    )
    print(f"[serve] {knobs.describe()}")
    if args.tp > 1:
        print(f"[serve] tensor parallelism: requested tp={args.tp}, effective tp={engine.tp} "
              f"({'heads split' if engine.tp > 1 else 'replication fallback'})")
    reqs = workload_requests(args, cfg.vocab_size)
    paged = args.engine == "paged"
    print(f"[serve] {cfg.name} on {device} ({model.dtype}), engine {args.engine}, "
          f"{args.engine_batch} slots, page {args.page_size}, max_seq {args.max_seq}, "
          f"kv_dtype {engine._kv_dtype_name()}, spec_k {args.spec_k}"
          + (f", prefill {args.prefill_mode}, prefix_cache {args.prefix_cache}, "
             f"overcommit {args.overcommit}" if paged else "")
          + (f", fleet of {args.fleet}" if args.fleet else ""))
    if cfg.family == "moe":
        print(f"[serve] {moe_summary(cfg)}")
    if args.fleet > 0:
        # the workers share the model and its weights (read-only while
        # serving); each engine holds its own page pool and slots
        engines = [engine] + [make_engine() for _ in range(args.fleet - 1)]
        summary = _fleet(engines, reqs, args)
    else:
        summary = ENGINES[args.engine](engine, reqs, args)
    if cfg.family == "moe":
        summary["moe"] = moe_summary(cfg)
    for k, v in summary.items():
        print(f"[serve]   {k:20s} {v:.2f}" if isinstance(v, float) else f"[serve]   {k:20s} {v}")
    if args.evaldb and rank == 0:
        db = EvalDB(args.evaldb)
        try:
            db.insert(EvaluationRecord(
                model=cfg.name, model_version="1.0.0", backend="torch",
                backend_version="1.0.0", system="local",
                scenario=f"serve-fleet{args.fleet}" if args.fleet else f"serve-{args.engine}",
                batch_size=args.engine_batch, trace_level="NONE", agent_id="serve-driver",
                metrics={**summary, "engine_knobs": knobs.to_dict()},
            ))
        finally:
            db.close()
    return 0


def moe_summary(cfg) -> str:
    """A MoE config in one line: experts, top k, capacity factor, expert
    width, and the dense layers it interleaves."""
    line = (f"moe: {cfg.num_experts} experts of d_ff {cfg.d_ff}, top "
            f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor}")
    if cfg.moe_every == 2:
        line += (f", every other of {cfg.num_layers} layers (dense layers of d_ff "
                 f"{cfg.dense_d_ff} between)")
    return line


if __name__ == "__main__":
    raise SystemExit(main())
