"""Flash-attention backward: wrapper of the CUDA kernels
``csrc/flash_attention_bwd.cu``.

Replaces the backward of the TPU flash path, ``repro/kernels/ops.py``
``_flash_vjp``/``_flash_bwd_core`` (the custom VJP around
``repro/kernels/flash_attention.py:flash_attention``).  A CPU tensor runs
the plain version (:func:`repro_torch.kernels.ref.flash_attention_bwd`); a
CUDA tensor launches the kernels or raises.  ``launches`` counts calls that
launch (three CUDA launches each: ``D = rowsum(dO * O)``, dK/dV, dQ).

bfloat16 and float32 both run on the CUDA cores with float32 sums (the
tensor-core redesign is later work); every head dim whose tile fits a
block's shared memory is taken (:func:`plan`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref

launches = 0

# (query rows, keys) per tile, tried in turn: the first whose dK/dV and dQ
# blocks both fit half an SM's shared memory (two blocks an SM), else the
# first that fits one block
TILES = ((64, 32), (32, 32), (16, 16))


def dkdv_smem_bytes(rows: int, bk: int, d: int) -> int:
    """Shared memory of a dK/dV block (csrc ``dkdv_floats``): K, V, Q and
    dO tiles in rows of d + 1 floats, P and dS in rows of bk + 1, lse and D,
    and the two float32 accumulators."""
    return 4 * (2 * bk * (d + 1) + 2 * rows * (d + 1) + 2 * rows * (bk + 1) + 2 * rows
                + 2 * bk * d)


def dq_smem_bytes(rows: int, bk: int, d: int) -> int:
    """Shared memory of a dQ block (csrc ``dq_floats``)."""
    return 4 * (2 * rows * (d + 1) + 2 * bk * (d + 1) + rows * (bk + 1) + 2 * rows + rows * d)


def plan(d: int) -> Tuple[int, int]:
    """(query rows, keys) per tile at head dim ``d``; raises
    :class:`~repro_torch.kernels._build.SharedMemoryError` where no tile
    fits a block."""
    for limit in (_build.SMEM_LIMIT // 2, _build.SMEM_LIMIT):
        for rows, bk in TILES:
            if max(dkdv_smem_bytes(rows, bk, d), dq_smem_bytes(rows, bk, d)) <= limit:
                return rows, bk
    raise _build.SharedMemoryError(
        f"flash_attention_bwd: no tile at head dim {d} fits {_build.SMEM_LIMIT} bytes of "
        f"shared memory")


def flash_attention_bwd(
    q: torch.Tensor,            # (b, sq, h, d)
    k: torch.Tensor,            # (b, sk, kvh, d)
    v: torch.Tensor,
    o: torch.Tensor,            # (b, sq, h, d) the forward's output
    lse: torch.Tensor,          # (b, h, sq) float32, the forward's log-sum-exp
    do: torch.Tensor,           # (b, sq, h, d) the output's cotangent
    *,
    causal: bool = True,
    window=None,
    softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype, with the forward's options (see
    :func:`~.ref.flash_attention_bwd`)."""
    global launches
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                       softcap=softcap, q_offset=q_offset, scale=scale)
    req = _build.require
    req(q.device.type == "cuda", f"flash_attention_bwd: unsupported device {q.device}")
    req(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
        "flash_attention_bwd: q must be (b, sq, h, d), k and v (b, sk, kvh, d) and alike")
    b, sq, h, d = q.shape
    _, sk, kvh, dk_ = k.shape
    req(k.shape[0] == b and dk_ == d and h % kvh == 0,
        f"flash_attention_bwd: q {tuple(q.shape)} does not pair with k {tuple(k.shape)}")
    req(o.shape == q.shape and do.shape == q.shape,
        "flash_attention_bwd: o and do must have q's shape")
    req(tuple(lse.shape) == (b, h, sq) and lse.dtype == torch.float32,
        f"flash_attention_bwd: lse must be float32 ({b}, {h}, {sq})")
    req(int(q_offset) >= 0, "flash_attention_bwd: q_offset must be >= 0")
    req(all(t.dtype == q.dtype for t in (k, v, o, do)),
        "flash_attention_bwd: q, k, v, o and do must share a dtype")
    for t in (k, v, o, lse, do):
        req(t.device == q.device, "flash_attention_bwd: inputs on different devices")
    for t in (q, k, v, o, lse, do):
        req(t.is_contiguous(), "flash_attention_bwd: inputs must be contiguous")
    code = _build.dtype_code(q, "flash_attention_bwd")
    rows, bk = plan(d)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    err = lib.rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kvh, d,
        rows, bk, int(bool(causal)), w, int(q_offset), scale, float(softcap), code,
        _build.stream_of(q),
    )
    launches += 1
    _build.check_launch(err, "flash_attention_bwd")
    return dq, dk, dv
