"""Speculative-decoding verification attention: wrapper of the CUDA kernels.

Replaces the TPU kernel ``repro/kernels/spec_verify.py:spec_verify``, for a
pool of q's dtype or an int8/fp8 pool with float32 per-row scales
(dequantized inside the kernel).  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.spec_verify`); a CUDA tensor launches a
kernel or raises.  ``launches`` counts calls that launched.

The kernel is chosen by dtype (:func:`.decode_split.plan`), a dispatch and
not a fallback: bfloat16 runs the W-token instance of the split-KV
tensor-core routine ``csrc/decode_split.cuh`` (two CUDA launches a call),
float32 the exact CUDA-core tile of ``csrc/spec_verify.cu`` with the
``rep * W`` rows of a kv head in chunks that fit a block.  Either way row
``w`` computes what a one-token ``paged_attention`` at ``len + w + 1``
does, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, decode_split, ref

launches = 0


def spec_verify(
    q: torch.Tensor,            # (b, W, h, d) one in-flight window per slot
    k_pages: torch.Tensor,      # (num_pages, page_size, kvh, d) global pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (b, max_pages) int32 page ids per request
    lengths: torch.Tensor,      # (b,) int32 committed tokens before the window
    window_lens: torch.Tensor,  # (b,) int32 real window tokens per row (0..W)
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kvh) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scores each slot's window against its committed pages plus the
    window's own causal prefix (the window's K/V are already in the pages);
    rows past ``window_lens`` come back exactly zero.  ``pages_bound`` caps
    the committed-plus-in-flight pages visited per slot (the kernel
    otherwise walks exactly ``ceil((len + window_len) / page_size)``)."""
    global launches
    width = page_table.shape[-1]
    bound = width if pages_bound is None else max(min(int(pages_bound), width), 1)
    if q.device.type == "cpu":
        return ref.spec_verify(
            q, k_pages, v_pages, page_table[:, :bound], lengths, window_lens,
            softcap=softcap, window=window, scale=scale,
            k_scales=k_scales, v_scales=v_scales,
        )
    req = _build.require
    req(q.device.type == "cuda", f"spec_verify: unsupported device {q.device}")
    req(q.dim() == 4, f"spec_verify: q {tuple(q.shape)} != (b, W, h, d)")
    b, W, h, d = q.shape
    req(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
        "spec_verify: pools must be (num_pages, page_size, kvh, d) and alike")
    _, ps, kvh, dk = k_pages.shape
    req(dk == d and h % kvh == 0, f"spec_verify: heads {h}/{kvh} or head dim {dk} != {d}")
    req(page_table.dim() == 2 and page_table.shape[0] == b, "spec_verify: table must be (b, max_pages)")
    req(lengths.shape == (b,) and window_lens.shape == (b,),
        "spec_verify: lengths and window_lens must be (b,)")
    ints = (page_table, lengths, window_lens)
    req(all(t.dtype == torch.int32 for t in ints),
        "spec_verify: table, lengths and window_lens must be int32")
    for t in (q, k_pages, v_pages, *ints):
        req(t.device == q.device, "spec_verify: inputs on different devices")
        req(t.is_contiguous(), "spec_verify: inputs must be contiguous")
    store = _build.kv_store_code("spec_verify", q, k_pages, v_pages, k_scales, v_scales)
    p = decode_split.plan(q.dtype, d, h // kvh, W, ps, quantized=store != 0)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    if p.kernel == "mma":
        out = decode_split.launch(
            "spec_verify", p, q, k_pages, v_pages, page_table, lengths, window_lens,
            max_pages=bound, key_cap=None, window=w, scale=scale, softcap=float(softcap),
            store=store, k_scales=k_scales, v_scales=v_scales)
    else:
        out = torch.empty_like(q)
        err = _build.library().rt_spec_verify_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _build.ptr(k_scales), _build.ptr(v_scales),
            page_table.data_ptr(), lengths.data_ptr(), window_lens.data_ptr(), out.data_ptr(),
            b, W, h, kvh, d, ps, width, bound, w, scale, float(softcap), p.rows, store,
            _build.stream_of(q),
        )
        _build.check_launch(err, "spec_verify")
    launches += 1
    return out
