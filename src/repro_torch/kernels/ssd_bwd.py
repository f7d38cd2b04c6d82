"""Mamba-2 SSD backward: wrapper of the CUDA kernels ``csrc/ssd_bwd_tc.cu``
(bf16, tensor cores) and ``csrc/ssd_bwd.cu`` (CUDA cores).

Replaces no Pallas kernel: the JAX package takes the scan's gradient by
autodiff of ``repro/kernels/ops.py:ssd_chunked_jnp``, and the TPU kernel
``repro/kernels/ssd_scan.py:ssd`` has no backward.  A CPU tensor runs the
plain version (:func:`repro_torch.kernels.ref.ssd_bwd`, the sequential
reverse recurrence); a CUDA tensor launches the kernels or raises.
``launches`` counts calls that launch (five CUDA launches each: chunk
states, state pass, chunk gradients, and the two fixed-order sums).

The route is chosen by dtype, p, n and chunk (:func:`plan`), a dispatch and
not a fallback, and is the forward's (:func:`~.ssd.plan`): bfloat16 with
``p % 16 == 0``, ``n % 16 == 0`` and a chunk in ``ssd.TC_CHUNKS`` runs every
product on ``mma.sync``, float32 operands as two bf16 terms, and reads the
forward's entry states and cum where :class:`~.ssd.SSDFn` kept them
(``states``, ``cum``); float32, and bfloat16 at other widths or chunks, run
the CUDA cores with float32 tiles and rebuild the forward's chunk states
from its inputs.  A block that needs more shared memory than the card has
raises :class:`~repro_torch.kernels._build.SharedMemoryError`; nothing
falls back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build, ref, ssd

launches = 0

# the CUDA-core route: per-timestep vectors of the chunk-gradient launch and
# warps a block (kGradVecs, kWarps of csrc/ssd_bwd.cu)
GRAD_VECS = 8
WARPS = 8
# the tensor-core route: heads a block of its chunk launches (kHeadGroup of
# csrc/ssd_bwd_tc.cu); its chunks and state-pass vectors are the forward's
# (ssd.TC_CHUNKS, ssd.PASS_VEC)
HEAD_GROUP = 2


@dataclass(frozen=True)
class Plan:
    """The kernels a call takes: ``route`` ``"mma"`` (``csrc/ssd_bwd_tc.cu``)
    or ``"f32"`` (``csrc/ssd_bwd.cu``), ``head_group`` heads a block of the
    chunk launches (1 for f32) and the dynamic shared memory of the chunk
    launches (chunk states, chunk gradients)."""

    route: str
    head_group: int
    smem_bytes: Tuple[int, int]


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


def tc_smem_bytes(p: int, n: int, chunk: int) -> Tuple[int, int]:
    """Shared memory of the two chunk launches of ``csrc/ssd_bwd_tc.cu``
    (``state_smem``, ``grads_smem``), bf16 tiles with rows padded by 8.
    Chunk states: C_c, B_c and the two terms of dy o exp(cum) (then x o w),
    exp(cum) and w per head of the group.  Chunk gradients: B_c, C_c, one
    head's x_c and dy_c, the two terms of W_c (then S_c, p x (n+8)) and of
    R^T (chunk x (chunk+8)); float32 cum and dt per head of the group, three
    chunk vectors (ew, exp(cum), the column sums), a row-sum vector per
    16-row tile, two per column part of the warps and a partial sum a
    warp."""
    q, pn, pp, pq = chunk, n + 8, p + 8, chunk + 8
    tiles, parts = q // 16, WARPS // (q // 16)
    state = 2 * (2 * q * pn + 2 * q * pp) + 4 * 2 * HEAD_GROUP * q
    grads = (2 * (2 * q * pn + 2 * q * pp + 2 * p * pn + 2 * q * pq)
             + 4 * (2 * HEAD_GROUP * q + 3 * q + tiles * q + 2 * parts * q + WARPS))
    return state, grads


def plan(dtype: torch.dtype, p: int, n: int, chunk: int, s: Optional[int] = None) -> Plan:
    """The route for x of ``dtype`` with head dim ``p``, state ``n`` and
    ``chunk`` timesteps a chunk (the CUDA-core route's blocks take
    ``min(chunk, s)`` of them where ``s`` is given).  Raises ``TypeError``
    for a dtype the kernels do not take and
    :class:`~repro_torch.kernels._build.SharedMemoryError` where a block
    does not fit the card."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssd_bwd: dtype {dtype} not supported by the CUDA kernels "
                        f"(expected one of {list(_build.DTYPE_CODES)})")
    if ssd.plan(dtype, p, n, chunk).kernel == "mma":
        pl, q = Plan("mma", HEAD_GROUP, tc_smem_bytes(p, n, chunk)), chunk
    else:
        q = chunk if s is None else min(chunk, s)
        pl = Plan("f32", 1, smem_bytes(p, n, q))
    if max(pl.smem_bytes) > _build.SMEM_LIMIT:
        raise _build.SharedMemoryError(
            f"ssd_bwd: a chunk of {q} timesteps at p {p}, n {n} needs {max(pl.smem_bytes)} bytes "
            f"of shared memory on the {pl.route} route, above the card's {_build.SMEM_LIMIT}")
    return pl


def workspace_bytes(pl: Plan, b: int, s: int, h: int, p: int, n: int, chunk: int,
                    kept: bool = False) -> int:
    """float32 workspaces of one call.  f32: cum (b, s, h), the chunk states
    and the carried cotangents (b, nc, h, p, n) each, the per-head dB and dC
    (b, s, h, n) each and dA's parts (b, nc, h).  mma: the carried
    cotangents, dB and dC per head group (b, s, groups, n) each, dA's parts
    and, unless the forward's are ``kept``, cum and the chunk states."""
    nc = -(-s // chunk)
    states = b * nc * h * p * n
    if pl.route == "f32":
        return 4 * (b * s * h + 2 * states + 2 * b * s * h * n + b * nc * h)
    groups = -(-h // pl.head_group)
    own = 0 if kept else b * s * h + states
    return 4 * (own + states + 2 * b * s * groups * n + b * nc * h)


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
    states: Optional[torch.Tensor] = None,          # (b, nc, h, p, n) float32, the forward's
    cum: Optional[torch.Tensor] = None,             # (b, s, h) float32, the forward's
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC, d_initial) of ``ssd(x, dt, A, B, C, chunk=chunk,
    initial_state=initial_state)`` for the cotangents ``dy`` and ``d_final``
    (zeros when None): dx in x's dtype, ddt and dA float32, dB and dC in B's
    dtype (summed over heads), d_initial float32 (see :func:`~.ref.ssd_bwd`).
    x, B and C may be the forward's strided views.  ``states`` and ``cum``,
    given together and on the tensor-core route only, are the forward's
    entry states S_in[c] and cum (what :class:`~.ssd.SSDFn` keeps): the backward then
    reads them instead of rebuilding them."""
    global launches
    req = _build.require
    req((states is None) == (cum is None), "ssd_bwd: the forward's states and cum come together")
    if x.device.type == "cpu":
        req(states is None, "ssd_bwd: kept states are the tensor-core route's, not the CPU's")
        return ref.ssd_bwd(x, dt, A, B, C, dy, initial_state=initial_state, d_final=d_final)
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
    nc = -(-s // chunk)                  # chunks of min(chunk, s) timesteps
    for name, t, shape in (("initial_state", initial_state, (b, h, p, n)),
                           ("d_final", d_final, (b, h, p, n)),
                           ("states", states, (b, nc, h, p, n)), ("cum", cum, (b, s, h))):
        if t is not None:
            req(t.shape == shape and t.dtype == torch.float32 and t.is_contiguous(),
                f"ssd_bwd: {name} must be contiguous float32 {shape}")
    for t in (dt, A, B, C, dy, initial_state, d_final, states, cum):
        req(t is None or t.device == x.device, "ssd_bwd: inputs on different devices")
    pl = plan(x.dtype, p, n, chunk, s)
    kept = states is not None
    req(not kept or pl.route == "mma",
        f"ssd_bwd: kept states are the tensor-core route's, not the {pl.route} route's")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, s, n), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, s, n), dtype=B.dtype, device=x.device)
    d_initial = torch.empty((b, h, p, n), **f32)
    if not kept:
        cum = torch.empty((b, s, h), **f32)
        states = torch.empty((b, nc, h, p, n), **f32)
    grads = torch.empty((b, nc, h, p, n), **f32)
    parts = h if pl.route == "f32" else -(-h // pl.head_group)   # dB, dC partials a timestep
    dB_part = torch.empty((b, s, parts, n), **f32)
    dC_part = torch.empty((b, s, parts, n), **f32)
    dA_part = torch.empty((b, nc, h), **f32)
    lib = _build.library()
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            _build.ptr(initial_state), dy.data_ptr(), _build.ptr(d_final), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), d_initial.data_ptr(),
            cum.data_ptr(), states.data_ptr(), grads.data_ptr(), dB_part.data_ptr(),
            dC_part.data_ptr(), dA_part.data_ptr())
    strides = (x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    if pl.route == "mma":
        err = lib.rt_ssd_bwd_tc(*ptrs, int(kept), b, s, h, p, n, chunk, *strides,
                                _build.stream_of(x))
    else:
        err = lib.rt_ssd_bwd(*ptrs, b, s, h, p, n, chunk, *strides,
                             _build.dtype_code(x, "ssd_bwd"), _build.stream_of(x))
    launches += 1
    _build.check_launch(err, "ssd_bwd")
    return dx, ddt, dA, dB, dC, d_initial
