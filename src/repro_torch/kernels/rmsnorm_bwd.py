"""RMSNorm backward: wrapper of the CUDA kernels ``csrc/rmsnorm_bwd.cu``.

Replaces the backward of the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``
(the JAX package takes it by autodiff).  A CPU tensor runs the plain
version (:func:`repro_torch.kernels.ref.rmsnorm_bwd`); a CUDA tensor
launches the kernels or raises.  ``launches`` counts calls that launch (two
CUDA launches each: dx with one float32 partial row of dw a block, then
their sum in a fixed order, so dw is the same on every run).  :func:`plan`
picks the path: 16-byte vectors (``tpr`` threads a row, ``slots`` rows a
block at a time) where D and the pointers allow, else the scalar kernel;
``ref.rmsnorm_bwd_partials`` and ``ref.rmsnorm_bwd_dw_sum`` are its order
of work in plain torch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from . import _build, ref

launches = 0

THREADS = 256       # a block (csrc common.cuh kThreads)
MAX_VECS = 4        # 16-byte vectors of a row a thread holds, at most (csrc kMaxVecs)
SUM_WARPS = 8       # warps of the dw sum, each a strided share of the partial rows
SMS = 132           # H100 streaming multiprocessors; the dx grid covers them twice


@dataclass(frozen=True)
class Plan:
    """``path`` ``"vec"`` or ``"scalar"``; ``tpr`` threads a row (0 on the
    scalar path, one block a row); ``vecs`` the kernel's vectors a thread
    (its ``NV`` instance, 0 scalar); ``slots`` rows a block holds at once;
    ``blocks`` of the dx launch, each one float32 partial row of dw."""

    path: str
    tpr: int
    vecs: int
    slots: int
    blocks: int


def plan(D: int, rows: int, itemsize: int, aligned: bool = True, sms: int = SMS) -> Plan:
    """The launch of ``rows`` rows of ``D`` elements of ``itemsize`` bytes:
    the vector path where D is a multiple of a 16-byte vector, the pointers
    16-byte ``aligned`` and a thread holds at most :data:`MAX_VECS` vectors;
    ``tpr`` the least power of two at which a thread holds at most two (at
    most 256), as the forward; ``min(rows / slots, 2 * sms)`` blocks."""
    vec = 16 // itemsize
    n = D // vec
    if D % vec == 0 and aligned and n <= THREADS * MAX_VECS:
        tpr = 1
        while tpr < THREADS and tpr * 2 < n:
            tpr *= 2
        need = -(-n // tpr)
        vecs = 1 if need <= 1 else 2 if need <= 2 else 4
        path, slots = "vec", THREADS // tpr
    else:
        path, tpr, vecs, slots = "scalar", 0, 0, 1
    return Plan(path, tpr, vecs, slots, max(1, min(-(-rows // slots), 2 * sms)))


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
    ptrs = (x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr())
    p = plan(D, rows, x.element_size(), all(a % 16 == 0 for a in ptrs),
             torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty((p.blocks, D), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.rt_rmsnorm_bwd(
        *ptrs, dw.data_ptr(), partial.data_ptr(), rows, D, float(eps), p.blocks, p.tpr, code,
        _build.stream_of(x),
    )
    launches += 1
    _build.check_launch(err, "rmsnorm_bwd")
    return dx, dw
