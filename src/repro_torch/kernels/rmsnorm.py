"""RMSNorm: wrapper of the CUDA kernel ``csrc/rmsnorm.cu``.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``.  A CPU tensor
runs the plain version (:func:`repro_torch.kernels.ref.rmsnorm`); a CUDA
tensor launches the kernel or raises.  A meta tensor (the dry run) passes
the same checks and gets the output the launcher allocates, and nothing
runs.  ``launches`` counts kernel launches.
:class:`RMSNormFn` is the differentiable op: this forward, then
:func:`.rmsnorm_bwd.rmsnorm_bwd`.
"""
from __future__ import annotations

import torch

from ..roofline import work
from ..roofline.count import kernel_scope
from . import _build, ref
from .rmsnorm_bwd import rmsnorm_bwd

launches = 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last axis, with
    float32 statistics; the output has the dtype of ``x``."""
    global launches
    if x.device.type == "cpu":
        return ref.rmsnorm(x, weight, eps)
    req = _build.require
    req(x.device.type in ("cuda", "meta"), f"rmsnorm: unsupported device {x.device}")
    D = x.shape[-1]
    req(weight.shape == (D,), f"rmsnorm: weight {tuple(weight.shape)} != ({D},)")
    req(weight.device == x.device, "rmsnorm: weight on another device")
    req(weight.dtype == x.dtype, f"rmsnorm: weight {weight.dtype} != x {x.dtype}")
    req(x.is_contiguous() and weight.is_contiguous(), "rmsnorm: inputs must be contiguous")
    code = _build.dtype_code(x, "rmsnorm")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0 or x.device.type == "meta":
        return out
    lib = _build.library()
    err = lib.rt_rmsnorm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, D, float(eps),
        code, _build.stream_of(x),
    )
    launches += 1
    _build.check_launch(err, "rmsnorm")
    return out


class RMSNormFn(torch.autograd.Function):
    """Differentiable :func:`rmsnorm`: the forward keeps x and the weight,
    the backward is :func:`~.rmsnorm_bwd.rmsnorm_bwd` (the kernels on a CUDA
    tensor, :func:`~.ref.rmsnorm_bwd` on the CPU), which recomputes the
    row statistics."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        with kernel_scope("rmsnorm_bwd", lambda: work.rmsnorm_bwd_call(x, weight, ctx.eps, dy)):
            dx, dw = rmsnorm_bwd(x, weight, ctx.eps, dy.contiguous())
        return dx, dw, None
