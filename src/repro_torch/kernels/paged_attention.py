"""Paged decode attention: wrapper of the CUDA kernels.

Replaces the TPU kernel ``repro/kernels/paged_attention.py:paged_attention``,
for a pool of q's dtype or an int8/fp8 pool with float32 per-row scales
(dequantized inside the kernel).  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.paged_attention`); a CUDA tensor launches
a kernel or raises.  ``launches`` counts calls that launched.

The kernel is chosen by dtype (:func:`.decode_split.plan`), a dispatch and
not a fallback: bfloat16 runs the one-token instance of the split-KV
tensor-core routine ``csrc/decode_split.cuh`` (two CUDA launches a call),
float32 the exact CUDA-core tile of ``csrc/paged_attention.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, decode_split, ref

launches = 0


def paged_attention(
    q: torch.Tensor,            # (b, 1, h, d)
    k_pages: torch.Tensor,      # (num_pages, page_size, kvh, d) global pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (b, max_pages) int32 page ids per request
    lengths: torch.Tensor,      # (b,) int32 live tokens per request
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kvh) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token decode attention over each request's live pages.
    ``pages_bound`` caps the pages visited per request (the kernel otherwise
    walks exactly ``ceil(len / page_size)`` of them).  ``k_scales``/
    ``v_scales`` come with an int8/fp8 pool, and only with one."""
    global launches
    width = page_table.shape[-1]
    bound = width if pages_bound is None else max(min(int(pages_bound), width), 1)
    if q.device.type == "cpu":
        return ref.paged_attention(
            q, k_pages, v_pages, page_table[:, :bound], lengths,
            softcap=softcap, window=window, scale=scale,
            k_scales=k_scales, v_scales=v_scales,
        )
    req = _build.require
    req(q.device.type == "cuda", f"paged_attention: unsupported device {q.device}")
    req(q.dim() == 4 and q.shape[1] == 1, f"paged_attention: q {tuple(q.shape)} != (b, 1, h, d)")
    b, _, h, d = q.shape
    req(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
        "paged_attention: pools must be (num_pages, page_size, kvh, d) and alike")
    _, ps, kvh, dk = k_pages.shape
    req(dk == d and h % kvh == 0, f"paged_attention: heads {h}/{kvh} or head dim {dk} != {d}")
    req(page_table.dim() == 2 and page_table.shape[0] == b, "paged_attention: table must be (b, max_pages)")
    req(lengths.shape == (b,), "paged_attention: lengths must be (b,)")
    req(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
        "paged_attention: table and lengths must be int32")
    for t in (k_pages, v_pages, page_table, lengths):
        req(t.device == q.device, "paged_attention: inputs on different devices")
    for t in (q, k_pages, v_pages, page_table, lengths):
        req(t.is_contiguous(), "paged_attention: inputs must be contiguous")
    store = _build.kv_store_code("paged_attention", q, k_pages, v_pages, k_scales, v_scales)
    p = decode_split.plan(q.dtype, d, h // kvh, 1, ps, quantized=store != 0)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    if p.kernel == "mma":
        out = decode_split.launch(
            "paged_attention", p, q, k_pages, v_pages, page_table, lengths, None,
            max_pages=bound, key_cap=None, window=w, scale=scale, softcap=float(softcap),
            store=store, k_scales=k_scales, v_scales=v_scales)
    else:
        # the float32 tile holds the whole GQA group
        _build.check_tile("paged_attention", h // kvh, ps, d)
        out = torch.empty_like(q)
        err = _build.library().rt_paged_attention_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _build.ptr(k_scales), _build.ptr(v_scales),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kvh, d, ps, width, bound, w, scale, float(softcap), store,
            _build.stream_of(q),
        )
        _build.check_launch(err, "paged_attention")
    launches += 1
    return out
