"""Mamba-2 SSD backward: wrapper of the CUDA kernels ``csrc/ssd_bwd.cu``.

Replaces no Pallas kernel: the JAX package takes the scan's gradient by
autodiff of ``repro/kernels/ops.py:ssd_chunked_jnp``, and the TPU kernel
``repro/kernels/ssd_scan.py:ssd`` has no backward.  A CPU tensor runs the
plain version (:func:`repro_torch.kernels.ref.ssd_bwd`, the sequential
reverse recurrence); a CUDA tensor launches the kernels or raises.
``launches`` counts calls that launch (five CUDA launches each: chunk
states, state pass, chunk gradients, and the two fixed-order sums over
heads and over (row, chunk)).

bfloat16 and float32 both run on the CUDA cores with float32 sums, tiles
staged in float32 (the tensor-core redesign is later work).  A chunk whose
blocks need more shared memory than the card has raises
:class:`~repro_torch.kernels._build.SharedMemoryError` (:func:`plan`);
nothing falls back.  The backward rebuilds the forward's chunk states from
its inputs, so the forward keeps nothing but them (:class:`~.ssd.SSDFn`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref

launches = 0

# per-timestep vectors of the chunk-gradient launch and warps a block
# (kGradVecs, kWarps of csrc/ssd_bwd.cu)
GRAD_VECS = 8
WARPS = 8


def smem_bytes(p: int, n: int, chunk: int) -> Tuple[int, int]:
    """Shared memory of the two chunk launches of ``csrc/ssd_bwd.cu``
    (``states_floats``, ``grads_floats``), float32 rows padded by one: the
    chunk states stage x, dy (chunk x (p+1)), B, C (chunk x (n+1)) and three
    vectors; the chunk gradients also a chunk x (p+1) scratch, the p x
    (n+1) carried state (W_c, then S_c), three chunk x (chunk+1) matrices,
    GRAD_VECS vectors and a partial sum a warp."""
    q = chunk
    states = 2 * q * (p + 1) + 2 * q * (n + 1) + 3 * q
    grads = (3 * q * (p + 1) + 2 * q * (n + 1) + p * (n + 1) + 3 * q * (q + 1)
             + GRAD_VECS * q + WARPS)
    return 4 * states, 4 * grads


def plan(dtype: torch.dtype, p: int, n: int, chunk: int) -> Tuple[int, int]:
    """The shared memory of each chunk launch for x of ``dtype`` with head
    dim ``p``, state ``n`` and ``chunk`` timesteps a chunk.  Raises
    ``TypeError`` for a dtype the kernels do not take and
    :class:`~repro_torch.kernels._build.SharedMemoryError` where a block
    does not fit the card."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssd_bwd: dtype {dtype} not supported by the CUDA kernels "
                        f"(expected one of {list(_build.DTYPE_CODES)})")
    sm = smem_bytes(p, n, chunk)
    if max(sm) > _build.SMEM_LIMIT:
        raise _build.SharedMemoryError(
            f"ssd_bwd: a chunk of {chunk} timesteps at p {p}, n {n} needs {max(sm)} bytes of "
            f"shared memory, above the card's {_build.SMEM_LIMIT}")
    return sm


def workspace_bytes(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """float32 workspaces of one call: cum (b, s, h), the chunk states and
    the carried cotangents (b, nc, h, p, n) each, the per-head dB and dC
    (b, s, h, n) each and dA's parts (b, nc, h)."""
    nc = -(-s // chunk)
    return 4 * (b * s * h + 2 * b * nc * h * p * n + 2 * b * s * h * n + b * nc * h)


def ssd_bwd(
    x: torch.Tensor,        # (b, s, h, p); (h, p) contiguous per timestep
    dt: torch.Tensor,       # (b, s, h) float32
    A: torch.Tensor,        # (h,) float32
    B: torch.Tensor,        # (b, s, n), x's dtype
    C: torch.Tensor,        # (b, s, n), x's dtype
    dy: torch.Tensor,       # (b, s, h, p) the cotangent of y, x's dtype
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,   # (b, h, p, n) float32
    d_final: Optional[torch.Tensor] = None,         # (b, h, p, n) float32
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC, d_initial) of ``ssd(x, dt, A, B, C, chunk=chunk,
    initial_state=initial_state)`` for the cotangents ``dy`` and ``d_final``
    (zeros when None): dx in x's dtype, ddt and dA float32, dB and dC in B's
    dtype (summed over heads), d_initial float32 (see :func:`~.ref.ssd_bwd`).
    x, B and C may be the forward's strided views."""
    global launches
    if x.device.type == "cpu":
        return ref.ssd_bwd(x, dt, A, B, C, dy, initial_state=initial_state, d_final=d_final)
    req = _build.require
    req(x.device.type == "cuda", f"ssd_bwd: unsupported device {x.device}")
    req(x.dim() == 4, f"ssd_bwd: x {tuple(x.shape)} != (b, s, h, p)")
    b, s, h, p = x.shape
    req(B.dim() == 3 and B.shape == C.shape and B.shape[:2] == (b, s),
        f"ssd_bwd: B {tuple(B.shape)} and C {tuple(C.shape)} must be ({b}, {s}, n)")
    n = B.shape[2]
    req(s >= 1 and chunk >= 1, f"ssd_bwd: needs s >= 1 and chunk >= 1 (s {s}, chunk {chunk})")
    req(dt.shape == (b, s, h) and dt.dtype == torch.float32,
        f"ssd_bwd: dt must be float32 ({b}, {s}, {h})")
    req(A.shape == (h,) and A.dtype == torch.float32, f"ssd_bwd: A must be float32 ({h},)")
    req(B.dtype == x.dtype and C.dtype == x.dtype and dy.dtype == x.dtype,
        "ssd_bwd: x, B, C and dy must share a dtype")
    req(dy.shape == x.shape and dy.is_contiguous(), "ssd_bwd: dy must be contiguous, x's shape")
    req(x.stride(3) == 1 and x.stride(2) == p,
        "ssd_bwd: x's (h, p) axes must be contiguous within a timestep")
    req(B.stride(2) == 1 and C.stride(2) == 1, "ssd_bwd: B's and C's last axis must be contiguous")
    req(dt.is_contiguous() and A.is_contiguous(), "ssd_bwd: dt and A must be contiguous")
    for name, t in (("initial_state", initial_state), ("d_final", d_final)):
        if t is not None:
            req(t.shape == (b, h, p, n) and t.dtype == torch.float32 and t.is_contiguous(),
                f"ssd_bwd: {name} must be contiguous float32 ({b}, {h}, {p}, {n})")
    for t in (dt, A, B, C, dy, initial_state, d_final):
        req(t is None or t.device == x.device, "ssd_bwd: inputs on different devices")
    code = _build.dtype_code(x, "ssd_bwd")
    plan(x.dtype, p, n, min(chunk, s))
    nc = -(-s // chunk)                  # chunks of min(chunk, s) timesteps
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, s, n), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, s, n), dtype=B.dtype, device=x.device)
    d_initial = torch.empty((b, h, p, n), **f32)
    cum = torch.empty((b, s, h), **f32)
    states = torch.empty((b, nc, h, p, n), **f32)
    grads = torch.empty((b, nc, h, p, n), **f32)
    dB_part = torch.empty((b, s, h, n), **f32)
    dC_part = torch.empty((b, s, h, n), **f32)
    dA_part = torch.empty((b, nc, h), **f32)
    lib = _build.library()
    err = lib.rt_ssd_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        _build.ptr(initial_state), dy.data_ptr(), _build.ptr(d_final), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), d_initial.data_ptr(),
        cum.data_ptr(), states.data_ptr(), grads.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), dA_part.data_ptr(), b, s, h, p, n, chunk,
        x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1), code,
        _build.stream_of(x),
    )
    launches += 1
    _build.check_launch(err, "ssd_bwd")
    return dx, ddt, dA, dB, dC, d_initial
