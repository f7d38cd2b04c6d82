"""Serving driver of the port: ``python -m repro_torch.launch.serve --engine paged``.

The flag subset of ``repro.launch.serve`` that the port supports so far,
plus ``--device`` and ``--dtype``.  Runs on ``cuda`` unless ``--device cpu``
is given.  The model config is the reduced one unless ``--full`` asks for
the published widths and depth; weights are random, from ``--seed``.
Prompts are random tokens with lengths drawn uniformly from
``[--prompt-len-min, --prompt-len]``.  ``--spec-k``/``--spec-ngram`` turn
on speculative decoding, ``--kv-dtype int8|fp8`` a quantized pool.  Prints
a plain summary (the analysis report sections of the JAX driver come with a
later slice).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config, list_archs
from ..device import DTYPES, resolve_device
from ..kernels.kvquant import KV_DTYPES
from ..models.lm import DecoderLM
from ..serve.engine import ServeRequest, ServingEngine, percentile


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


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: the reduced config)")
    ap.add_argument("--engine", default="paged", choices=["paged"],
                    help="serving engine (only the paged engine is ported)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain path)")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="weights, activations and pool (default: bfloat16 on "
                         "cuda, float32 on cpu)")
    ap.add_argument("--seed", type=int, default=0, help="weights and prompts")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="longest prompt (tokens)")
    ap.add_argument("--prompt-len-min", type=int, default=0,
                    help="shortest prompt (0 = --prompt-len: all equal)")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--engine-batch", type=int, default=4, help="decode slots")
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
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

    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 matmuls stay full fp32 (no TF32) wherever the port runs fp32
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, reduced=not args.full)
    model = DecoderLM(cfg, device=device, dtype=args.dtype)
    params = model.init(seed=args.seed)
    engine = ServingEngine(model, params, max_batch=args.engine_batch,
                           max_seq=args.max_seq, page_size=args.page_size,
                           device=device, kv_dtype=args.kv_dtype)
    reqs = make_requests(args.requests, lo, args.prompt_len, args.max_new_tokens,
                         cfg.vocab_size, args.seed)
    print(f"[serve] {cfg.name} on {device} ({model.dtype}), "
          f"{args.engine_batch} slots, page {args.page_size}, max_seq {args.max_seq}, "
          f"kv_dtype {engine._kv_dtype_name()}, spec_k {args.spec_k}")
    stats = engine.serve_paged(
        reqs, num_slots=args.engine_batch, page_size=args.page_size,
        num_pages=args.num_pages or None,
        prefill_budget=args.prefill_budget or None,
        spec_k=args.spec_k, spec_ngram=args.spec_ngram,
    )
    for r in stats.results:
        print(f"[serve] req {r.request_id}: slot {r.slot} (admitted step "
              f"{r.admit_step}), ttft {r.ttft_s * 1e3:.1f} ms, "
              f"{r.tokens_per_s:,.1f} tok/s")
    ttfts = [r.ttft_s * 1e3 for r in stats.results]
    summary = {
        "requests": len(stats.results),
        "generated_tokens": stats.total_tokens,
        "wall_s": stats.wall_s,
        "tokens_per_s": stats.throughput_tps,
        "prefill_launches": stats.prefill_launches,
        "prefill_tokens": stats.prefill_tokens,
        "prefill_tok_per_s": stats.prefill_tokens / stats.prefill_s if stats.prefill_s else 0.0,
        "decode_steps": stats.steps,
        "decode_step_ms": stats.decode_s / stats.steps * 1e3 if stats.steps else 0.0,
        "decode_tok_per_s": (stats.total_tokens - len(stats.results)) / stats.decode_s
        if stats.decode_s else 0.0,
        "ttft_p50_ms": percentile(ttfts, 50.0),
        "ttft_p99_ms": percentile(ttfts, 99.0),
        "peak_pages_in_use": stats.peak_pages_in_use,
        "kv_bytes_per_token": stats.kv_bytes_per_token,
        **stats.spec_stats,
    }
    for k, v in summary.items():
        print(f"[serve]   {k:20s} {v:.2f}" if isinstance(v, float) else f"[serve]   {k:20s} {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
