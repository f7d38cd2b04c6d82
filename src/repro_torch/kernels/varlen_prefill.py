"""Packed varlen prefill attention: wrapper of the CUDA kernel
``csrc/varlen_prefill.cu``.

Replaces the TPU kernel ``repro/kernels/varlen_prefill.py:varlen_prefill``,
for a pool of q's dtype or an int8/fp8 pool with float32 per-row scales
(the context pages are dequantized inside the kernel; the chunks' own packed
K/V stay full precision).  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.varlen_prefill`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref

launches = 0


def varlen_prefill(
    q: torch.Tensor,            # (T, h, d) packed queries
    k: torch.Tensor,            # (T, kvh, d) packed chunk K
    v: torch.Tensor,            # (T, kvh, d)
    k_pages: torch.Tensor,      # (num_pages, page_size, kvh, d) global pool
    v_pages: torch.Tensor,
    cu_seqlens: torch.Tensor,   # (C+1,) int32 packed chunk boundaries
    chunk_lens: torch.Tensor,   # (C,) int32 real tokens per chunk
    chunk_pos0: torch.Tensor,   # (C,) int32 absolute chunk starts (page-aligned)
    page_tables: torch.Tensor,  # (C, max_pages) int32
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kvh) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of every packed chunk over its request's committed pages
    plus its own causal prefix; pad rows come back exactly zero.  Chunk
    spans are page-aligned and the packed length a page multiple."""
    global launches
    if q.device.type == "cpu":
        return ref.varlen_prefill(
            q, k, v, k_pages, v_pages, cu_seqlens, chunk_lens, chunk_pos0,
            page_tables, softcap=softcap, window=window, scale=scale,
            pages_bound=pages_bound, k_scales=k_scales, v_scales=v_scales,
        )
    req = _build.require
    req(q.device.type == "cuda", f"varlen_prefill: unsupported device {q.device}")
    req(q.dim() == 3, f"varlen_prefill: q {tuple(q.shape)} != (T, h, d)")
    T, h, d = q.shape
    req(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
        "varlen_prefill: pools must be (num_pages, page_size, kvh, d) and alike")
    _, ps, kvh, dk = k_pages.shape
    req(k.shape == (T, kvh, d) and v.shape == (T, kvh, d),
        f"varlen_prefill: packed K/V must be ({T}, {kvh}, {d})")
    req(dk == d and h % kvh == 0, f"varlen_prefill: heads {h}/{kvh} or head dim {dk} != {d}")
    req(T % ps == 0, f"varlen_prefill: packed length {T} not a multiple of page {ps}")
    req(page_tables.dim() == 2, "varlen_prefill: page_tables must be (C, max_pages)")
    C, max_pages = page_tables.shape
    req(cu_seqlens.shape == (C + 1,) and chunk_lens.shape == (C,) and chunk_pos0.shape == (C,),
        "varlen_prefill: cu_seqlens (C+1,), chunk_lens and chunk_pos0 (C,)")
    ints = (cu_seqlens, chunk_lens, chunk_pos0, page_tables)
    req(all(t.dtype == torch.int32 for t in ints), "varlen_prefill: metadata must be int32")
    req(k.dtype == q.dtype and v.dtype == q.dtype,
        "varlen_prefill: q and the packed k, v must share a dtype")
    for t in (q, k, v, k_pages, v_pages, *ints):
        req(t.device == q.device, "varlen_prefill: inputs on different devices")
        req(t.is_contiguous(), "varlen_prefill: inputs must be contiguous")
    code = _build.dtype_code(q, "varlen_prefill")
    store = _build.kv_store_code("varlen_prefill", q, k_pages, v_pages, k_scales, v_scales)
    _build.check_tile("varlen_prefill", ps, ps, d)
    scale = d ** -0.5 if scale is None else float(scale)
    ctx_bound = max_pages if pages_bound is None else min(int(pages_bound), max_pages)
    w = 0 if window is None else int(window)
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.rt_varlen_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), _build.ptr(k_scales), _build.ptr(v_scales),
        cu_seqlens.data_ptr(), chunk_lens.data_ptr(),
        chunk_pos0.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
        T, C, h, kvh, d, ps, max_pages, ctx_bound, w, scale, float(softcap),
        code, store, _build.stream_of(q),
    )
    launches += 1
    _build.check_launch(err, "varlen_prefill")
    return out
