"""Dense-cache decode attention: wrapper of the CUDA kernels.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:decode_attention``.
A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.decode_attention`); a CUDA tensor launches
a kernel or raises.  ``launches`` counts calls that launched (this
module's own, whichever kernel ran).

Dispatch by dtype: bfloat16 views the cache ``(b, S, kvh, d)`` as a pool
``(b * S / 16, 16, kvh, d)`` with the identity page table (row ``i`` holds
pages ``i * S / 16 + j``; the kernel computes it, no table is made),
``pages_bound = ceil(kv_bound / 16)`` and a key cap at ``kv_bound``, and
launches the one-token instance of the split-KV
routine that ``paged_attention`` launches (``csrc/decode_split.cuh``):
a dense row and the same keys in pages give the same bits.  ``S`` must be
a multiple of 16 there.  float32 runs ``csrc/decode_attention.cu``, the
exact CUDA-core tile stepping through 16 keys at a time as
``paged_attention``'s float32 tile does.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, decode_split, ref

launches = 0

# keys per page of the bf16 pool view, and per online-softmax step of the
# float32 tile: the serving page size, so that a dense row and the same
# keys in pages take paged_attention's arithmetic
BLOCK_K = 16

def pool_view(k_cache: torch.Tensor, v_cache: torch.Tensor, kv_bound: int):
    """A dense cache ``(b, S, kvh, d)`` (``S`` a multiple of ``BLOCK_K``) as
    the split routine's pool, read through the identity table (slot ``i``
    owns pages ``i * S / 16 + j``, see :func:`identity_table`):
    ``(k_pool, v_pool, pages_bound, key_cap)``, the pools ``(b * S / 16,
    16, kvh, d)`` views (no copy), ``ceil(kv_bound / 16)`` pages and the cap
    ``kv_bound`` on the keys read."""
    b, S, kvh, d = k_cache.shape
    view = lambda c: c.view(b * S // BLOCK_K, BLOCK_K, kvh, d)
    return view(k_cache), view(v_cache), -(-kv_bound // BLOCK_K), kv_bound


def identity_table(b: int, pages: int, device=None) -> torch.Tensor:
    """``(b, pages)`` int32 with row ``i`` = ``i * pages + j``: the page
    table the kernel reads when it is given none (the plain versions and the
    bit-identity checks take it explicitly)."""
    return torch.arange(b * pages, dtype=torch.int32, device=device).view(b, pages)


def decode_attention(
    q: torch.Tensor,            # (b, 1, h, d) one new token per row
    k_cache: torch.Tensor,      # (b, S, kvh, d) dense cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,      # (b,) int32 live tokens (incl. the new one)
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """One-token attention over each row's live keys ``[0, len)`` (or
    ``[len - window, len)``).  ``kv_bound`` is a host-known bound on the
    lengths: no key at or past it is visited, so short contexts do not
    stream the padded cache.  A row of length 0 comes back exactly zero."""
    global launches
    S = k_cache.shape[1]
    bound = S if kv_bound is None else max(min(int(kv_bound), S), 1)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths, softcap=softcap,
                                    window=window, scale=scale, kv_bound=bound)
    req = _build.require
    req(q.device.type == "cuda", f"decode_attention: unsupported device {q.device}")
    req(q.dim() == 4 and q.shape[1] == 1, f"decode_attention: q {tuple(q.shape)} != (b, 1, h, d)")
    b, _, h, d = q.shape
    req(k_cache.dim() == 4 and k_cache.shape == v_cache.shape,
        "decode_attention: caches must be (b, S, kvh, d) and alike")
    _, _, kvh, dk = k_cache.shape
    req(k_cache.shape[0] == b and dk == d and h % kvh == 0,
        f"decode_attention: q {tuple(q.shape)} does not pair with the cache {tuple(k_cache.shape)}")
    req(lengths.shape == (b,) and lengths.dtype == torch.int32,
        "decode_attention: lengths must be (b,) int32")
    req(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
        "decode_attention: q and the caches must share a dtype")
    for t in (k_cache, v_cache, lengths):
        req(t.device == q.device, "decode_attention: inputs on different devices")
    for t in (q, k_cache, v_cache, lengths):
        req(t.is_contiguous(), "decode_attention: inputs must be contiguous")
    p = decode_split.plan(q.dtype, d, h // kvh, 1, BLOCK_K)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    if p.kernel == "mma":
        req(S % BLOCK_K == 0,
            f"decode_attention: bf16 cache length {S} must be a multiple of {BLOCK_K}")
        k_pool, v_pool, pages, cap = pool_view(k_cache, v_cache, bound)
        out = decode_split.launch(
            "decode_attention", p, q, k_pool, v_pool, None, lengths, None, max_pages=pages,
            key_cap=cap, window=w, scale=scale, softcap=float(softcap), store=0,
            k_scales=None, v_scales=None)
    else:
        _build.check_tile("decode_attention", h // kvh, BLOCK_K, d)
        out = torch.empty_like(q)
        err = _build.library().rt_decode_attention_f32(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, S, h, kvh, d, BLOCK_K, bound, w, scale, float(softcap),
            _build.stream_of(q),
        )
        _build.check_launch(err, "decode_attention")
    launches += 1
    return out
