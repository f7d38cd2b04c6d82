"""Dense-cache decode attention: wrapper of the CUDA kernel
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:decode_attention``.
A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.decode_attention`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref

launches = 0

# keys per online-softmax step: the serving page size, so that a dense row
# and the same keys in pages take paged_attention's arithmetic
BLOCK_K = 16


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
    code = _build.dtype_code(q, "decode_attention")
    _build.check_tile("decode_attention", h // kvh, BLOCK_K, d)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.rt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, S, h, kvh, d, BLOCK_K, bound, w, scale, float(softcap),
        code, _build.stream_of(q),
    )
    launches += 1
    _build.check_launch(err, "decode_attention")
    return out
