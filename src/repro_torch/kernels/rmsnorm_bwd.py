"""RMSNorm backward: wrapper of the CUDA kernels ``csrc/rmsnorm_bwd.cu``.

Replaces the backward of the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``
(the JAX package takes it by autodiff).  A CPU tensor runs the plain
version (:func:`repro_torch.kernels.ref.rmsnorm_bwd`); a CUDA tensor
launches the kernels or raises.  ``launches`` counts calls that launch (two
CUDA launches each: dx with per-block float32 partials of dw, then their
sum in a fixed order, so dw is the same on every run).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref

launches = 0

# blocks of the dx launch at most: each sums its rows' part of dw into one
# float32 partial row
MAX_BLOCKS = 512


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, eps: float,
                dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm(x, weight, eps)`` for the output cotangent
    ``dy``: dx in x's dtype, dw in w's (see :func:`~.ref.rmsnorm_bwd`)."""
    global launches
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd(x, weight, eps, dy)
    req = _build.require
    req(x.device.type == "cuda", f"rmsnorm_bwd: unsupported device {x.device}")
    D = x.shape[-1]
    req(weight.shape == (D,), f"rmsnorm_bwd: weight {tuple(weight.shape)} != ({D},)")
    req(dy.shape == x.shape, f"rmsnorm_bwd: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    req(weight.dtype == x.dtype and dy.dtype == x.dtype,
        "rmsnorm_bwd: x, weight and dy must share a dtype")
    req(weight.device == x.device and dy.device == x.device,
        "rmsnorm_bwd: inputs on different devices")
    req(x.is_contiguous() and weight.is_contiguous() and dy.is_contiguous(),
        "rmsnorm_bwd: inputs must be contiguous")
    code = _build.dtype_code(x, "rmsnorm_bwd")
    dx, dw = torch.empty_like(x), torch.empty_like(weight)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, dw.zero_()
    blocks = min(rows, MAX_BLOCKS)
    partial = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.rt_rmsnorm_bwd(
        x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        partial.data_ptr(), rows, D, float(eps), blocks, code, _build.stream_of(x),
    )
    launches += 1
    _build.check_launch(err, "rmsnorm_bwd")
    return dx, dw
