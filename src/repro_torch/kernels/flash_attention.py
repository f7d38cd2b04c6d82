"""Forward flash attention: wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(the forward pass; the training backward is not ported yet).  A CPU tensor
runs the plain version (:func:`repro_torch.kernels.ref.attention`); a CUDA
tensor launches the kernel or raises, also when the GQA group's tile does
not fit in shared memory (:class:`~repro_torch.kernels._build.SharedMemoryError`).
``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref

launches = 0

TILE_ROWS = 64    # query rows per block: bq positions x the GQA group
BLOCK_K = 32      # keys per online-softmax step


def flash_attention(
    q: torch.Tensor,            # (b, sq, h, d)
    k: torch.Tensor,            # (b, sk, kvh, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of query row ``i`` (position ``q_offset + i``) over the
    keys ``j < sk`` with (causal) ``q_pos >= j`` and (window, a runtime int,
    0 or None for none) ``q_pos - j < window``; rows with no live key come
    back exactly zero."""
    global launches
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                             q_offset=q_offset, scale=scale)
    req = _build.require
    req(q.device.type == "cuda", f"flash_attention: unsupported device {q.device}")
    req(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
        "flash_attention: q must be (b, sq, h, d), k and v (b, sk, kvh, d) and alike")
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    req(k.shape[0] == b and dk == d and h % kvh == 0,
        f"flash_attention: q {tuple(q.shape)} does not pair with k {tuple(k.shape)}")
    req(sq > 0 and sk > 0, "flash_attention: empty query or key sequence")
    req(int(q_offset) >= 0, "flash_attention: q_offset must be >= 0")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "flash_attention: q, k and v must share a dtype")
    for t in (k, v):
        req(t.device == q.device, "flash_attention: inputs on different devices")
    for t in (q, k, v):
        req(t.is_contiguous(), "flash_attention: inputs must be contiguous")
    code = _build.dtype_code(q, "flash_attention")
    rep = h // kvh
    bq = max(1, TILE_ROWS // rep)
    _build.check_tile("flash_attention", bq * rep, BLOCK_K, d)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kvh, d, bq, BLOCK_K, int(bool(causal)), w, int(q_offset),
        scale, float(softcap), code, _build.stream_of(q),
    )
    launches += 1
    _build.check_launch(err, "flash_attention")
    return out
