"""Serving driver of the port: ``python -m repro_torch.launch.serve``.

The flag subset of ``repro.launch.serve`` that the port supports so far,
plus ``--device`` and ``--dtype``.  Three engines (``--engine``):

* ``paged`` (the default here, so existing callers are unchanged; the JAX
  driver defaults to ``static``): paged-KV continuous batching with packed
  varlen prefill; ``--spec-k``/``--spec-ngram`` turn on speculative
  decoding, ``--kv-dtype int8|fp8`` a quantized pool.
* ``static``: Poisson arrivals at ``--rate-hz`` go through the threaded
  request scheduler, which coalesces up to ``--engine-batch`` requests
  within ``--batch-timeout-ms`` into one ``generate`` batch on the dense
  cache; prints each batch's prefill and decode times and a summary.
* ``continuous``: slot-based continuous batching on the dense cache
  (``serve_continuous``) over the same prompts, offline; prints each
  request's TTFT and tokens/s and a summary.

``--arch`` picks the model: the dense ``deepseek-67b``, ``granite-20b``,
``glm4-9b``, ``gemma2-27b`` and ``chameleon-34b`` (every engine) or
``mamba2-130m`` (SSM: ``static`` and ``continuous``; its state is not
paged, so ``--engine paged`` stops with the reference's reason).  Runs on
``cuda`` unless ``--device cpu`` is given.  The model config is the
reduced one unless ``--full`` asks for the published widths and depth;
weights are random, from ``--seed``.  ``--full`` refuses a model whose
weights alone exceed the card's memory: ``deepseek-67b`` (125.6 GiB in
bf16) runs reduced only on one 80 GB card; the others fit at full width.  Prompts are random tokens with
lengths drawn uniformly from ``[--prompt-len-min, --prompt-len]``.  Prints a
plain summary (the analysis report sections of the JAX driver come with a
later slice).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, list_archs
from ..core.analysis import latency_summary, percentile
from ..core.workload import PoissonLoad
from ..device import DTYPES, resolve_device
from ..kernels.kvquant import KV_DTYPES
from ..models.lm import NOT_PAGED, DecoderLM
from ..serve.engine import ServeRequest, ServingEngine
from ..serve.scheduler import RequestScheduler, SchedulerConfig


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
    ``engine.max_batch`` requests run ``engine.generate``."""
    batches: List[tuple] = []

    def execute(batch):
        ps = [r.payload for r in batch]
        res = engine.generate(ps, max_new_tokens)
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
    ``serve_paged`` (``PagedStats``) run.  Each request's first token comes
    from its prefill, the rest from decode steps."""
    res = stats.results
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
        print(f"[serve] req {r.request_id}: slot {r.slot} (admitted step "
              f"{r.admit_step}), ttft {r.ttft_s * 1e3:.1f} ms, "
              f"{r.tokens_per_s:,.1f} tok/s")


def _continuous(engine, reqs, args) -> Dict[str, float]:
    stats = engine.serve_continuous(reqs, num_slots=args.engine_batch)
    _print_requests(stats)
    return {**engine_metrics(stats), "mean_slot_occupancy": stats.mean_slot_occupancy}


def _paged(engine, reqs, args) -> Dict[str, float]:
    stats = engine.serve_paged(
        reqs, num_slots=args.engine_batch, page_size=args.page_size,
        num_pages=args.num_pages or None,
        prefill_budget=args.prefill_budget or None,
        spec_k=args.spec_k, spec_ngram=args.spec_ngram,
    )
    _print_requests(stats)
    return {
        **engine_metrics(stats),
        "prefill_launches": stats.prefill_launches,
        "prefill_tokens": stats.prefill_tokens,
        "peak_pages_in_use": stats.peak_pages_in_use,
        "kv_bytes_per_token": stats.kv_bytes_per_token,
        **stats.spec_stats,
    }


ENGINES = {"paged": _paged, "static": _static, "continuous": _continuous}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: the reduced config); "
                         "refused where the weights alone exceed the card's memory: "
                         "deepseek-67b runs reduced only on one 80 GB card")
    ap.add_argument("--engine", default="paged", choices=list(ENGINES),
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
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="packed-prefill tokens per boundary (0 = 16 pages)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft depth: prompt lookup proposes up to k "
                         "tokens per slot, one verify step scores all k+1 (0 = off)")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="prompt-lookup n-gram match length for drafting")
    ap.add_argument("--kv-dtype", default=None, choices=sorted(KV_DTYPES),
                    help="store the KV pool as int8/fp8 codes with float32 per-row "
                         "scales (default: the pool in --dtype)")
    args = ap.parse_args(argv)
    lo = args.prompt_len_min or args.prompt_len
    if not 1 <= lo <= args.prompt_len:
        ap.error("need 1 <= --prompt-len-min <= --prompt-len")
    if args.engine != "paged" and (args.spec_k or args.kv_dtype):
        ap.error("--spec-k and --kv-dtype need --engine paged")
    if args.rate_hz <= 0:
        ap.error("--rate-hz must be positive")

    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 matmuls stay full fp32 (no TF32) wherever the port runs fp32
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, reduced=not args.full)
    model = DecoderLM(cfg, device=device, dtype=args.dtype)
    if args.engine == "paged" and model.ssm:
        ap.error(f"--engine paged with {cfg.name}: {NOT_PAGED}")
    try:
        params = model.init(seed=args.seed)
    except MemoryError as e:
        ap.error(f"{e} (drop --full)")
    engine = ServingEngine(model, params, max_batch=args.engine_batch,
                           max_seq=args.max_seq, page_size=args.page_size,
                           device=device, kv_dtype=args.kv_dtype)
    reqs = make_requests(args.requests, lo, args.prompt_len, args.max_new_tokens,
                         cfg.vocab_size, args.seed)
    print(f"[serve] {cfg.name} on {device} ({model.dtype}), engine {args.engine}, "
          f"{args.engine_batch} slots, page {args.page_size}, max_seq {args.max_seq}, "
          f"kv_dtype {engine._kv_dtype_name()}, spec_k {args.spec_k}")
    summary = ENGINES[args.engine](engine, reqs, args)
    for k, v in summary.items():
        print(f"[serve]   {k:20s} {v:.2f}" if isinstance(v, float) else f"[serve]   {k:20s} {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
