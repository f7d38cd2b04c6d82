"""Mamba-2 SSD chunked scan: wrapper of the CUDA kernels ``csrc/ssd_tc.cu``
(bf16, tensor cores) and ``csrc/ssd.cu`` (CUDA cores).

Replaces the TPU kernel ``repro/kernels/ssd_scan.py:ssd``.  A CPU tensor
runs the plain version (:func:`repro_torch.kernels.ref.ssd`, the sequential
recurrence); a CUDA tensor launches the kernel or raises.  ``launches``
counts wrapper calls that launch.

The kernel is chosen by dtype, p, n and chunk (:func:`plan`), a dispatch and
not a fallback: bfloat16 with ``p % 16 == 0``, ``n % 16 == 0`` and a chunk
in :data:`TC_CHUNKS` runs the chunk-parallel SSD on the tensor cores, three
CUDA launches on the current stream (chunk states, state passing, output)
through two float32 workspaces the wrapper allocates; float32, and bfloat16
at other widths or chunks, run ``csrc/ssd.cu``, one block per (head, row)
sequential over the chunks.  Neither depends on ``s``, the batch or the
alignment of the views.  A block that needs more shared memory than the
card has raises :class:`~repro_torch.kernels._build.SharedMemoryError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build, ref

launches = 0

# the tensor-core route: chunks instantiated in csrc/ssd_tc.cu (RT_SSD_TC),
# heads per block of its chunk launches (kHeadGroup), state elements a thread
# of the state pass carries (kPassVec) and threads per block
TC_CHUNKS = (16, 32, 64)
HEAD_GROUP = 2
PASS_VEC = 4
THREADS = 256


@dataclass(frozen=True)
class Plan:
    """The kernel a call takes: ``kernel`` ``"mma"`` (``csrc/ssd_tc.cu``)
    or ``"f32"`` (``csrc/ssd.cu``), ``head_group`` heads per block of the
    chunk launches (1 for f32: a block per (head, row)) and the dynamic
    shared memory of each launch (mma: chunk states, state pass, output;
    f32: its one launch at a full chunk)."""

    kernel: str
    head_group: int
    smem_bytes: Tuple[int, ...]


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of one block of ``csrc/ssd.cu`` (``ssd_smem_floats``):
    the float32 state slice p x (n+1), a chunk's x (chunk x p), B and C
    (chunk x (n+1) each), the chunk x chunk intra-chunk matrix and four
    per-timestep vectors."""
    return 4 * (p * (n + 1) + chunk * p + 2 * chunk * (n + 1) + chunk * chunk + 4 * chunk)


def tc_smem_bytes(p: int, n: int, chunk: int) -> Tuple[int, int, int]:
    """Shared memory of the three launches of ``csrc/ssd_tc.cu``
    (``state_smem``, 0, ``out_smem``): bf16 tiles with rows padded by 8
    elements.  Chunk states: B_c and the two terms of x o w, and w per head
    of the group (f32).  Output: C_c, B_c, one head's x_c, its S_in
    (p x (n+8), f32), and cum and dt per head of the group (f32)."""
    q, pn, pp = chunk, n + 8, p + 8
    state = 2 * (q * pn + 2 * q * pp) + 4 * HEAD_GROUP * q
    out = 2 * (2 * q * pn + q * pp + 2 * p * pn) + 4 * 2 * HEAD_GROUP * q
    return state, 0, out


def plan(dtype: torch.dtype, p: int, n: int, chunk: int) -> Plan:
    """The kernel for x of ``dtype`` with head dim ``p``, state ``n`` and
    ``chunk`` timesteps a chunk.  Raises ``TypeError`` for another dtype
    and :class:`~repro_torch.kernels._build.SharedMemoryError` where the
    tensor-core route's blocks do not fit the card."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssd: dtype {dtype} not supported by the CUDA kernels "
                        f"(expected one of {list(_build.DTYPE_CODES)})")
    if dtype == torch.bfloat16 and p % 16 == 0 and n % 16 == 0 and chunk in TC_CHUNKS:
        sm = tc_smem_bytes(p, n, chunk)
        if max(sm) > _build.SMEM_LIMIT:
            raise _build.SharedMemoryError(
                f"ssd: a chunk of {chunk} timesteps at p {p}, n {n} needs {max(sm)} bytes of "
                f"shared memory on the tensor-core route, above the card's {_build.SMEM_LIMIT}")
        return Plan("mma", HEAD_GROUP, sm)
    return Plan("f32", 1, (smem_bytes(p, n, chunk),))


def chunks(s: int, chunk: int) -> int:
    return -(-s // chunk)


def blocks(pl: Plan, b: int, s: int, h: int, p: int, n: int, chunk: int) -> Tuple[int, ...]:
    """Blocks of each launch: mma (row, chunk, head group) for the chunk
    launches and (slice of p n, head, row) for the state pass; f32 one per
    (head, row)."""
    if pl.kernel == "f32":
        return (h * b,)
    per_chunk = b * chunks(s, chunk) * -(-h // pl.head_group)
    slices = -(-(p * n // PASS_VEC) // THREADS)
    return per_chunk, slices * h * b, per_chunk


def workspace_bytes(pl: Plan, b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """float32 workspaces of the tensor-core route: cum (b, s, h) and the
    chunk states (b, nc, h, p, n); none for f32."""
    if pl.kernel == "f32":
        return 0
    return 4 * (b * s * h + b * chunks(s, chunk) * h * p * n)


def ssd(
    x: torch.Tensor,        # (b, s, h, p) activations; (h, p) contiguous per timestep
    dt: torch.Tensor,       # (b, s, h) float32, softplus'd time deltas
    A: torch.Tensor,        # (h,) float32, negative decay rates
    B: torch.Tensor,        # (b, s, n) input projection, x's dtype
    C: torch.Tensor,        # (b, s, n) output projection, x's dtype
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,   # (b, h, p, n) float32
    return_state: bool = False,
):
    """The SSD scan over chunks of ``min(chunk, s)`` timesteps with float32
    accumulation, from ``initial_state`` (zeros when None).  Returns y
    ``(b, s, h, p)`` in x's dtype and, with ``return_state``, the final
    state ``(b, h, p, n)`` in x's dtype, as the JAX kernel returns it.
    x, B and C may be strided views (the slices of ``in_proj``'s output):
    only their innermost axes must be contiguous."""
    global launches
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, B, C, initial_state=initial_state, return_state=return_state)
    req = _build.require
    req(x.device.type == "cuda", f"ssd: unsupported device {x.device}")
    req(x.dim() == 4, f"ssd: x {tuple(x.shape)} != (b, s, h, p)")
    b, s, h, p = x.shape
    req(B.dim() == 3 and B.shape == C.shape and B.shape[:2] == (b, s),
        f"ssd: B {tuple(B.shape)} and C {tuple(C.shape)} must be ({b}, {s}, n)")
    n = B.shape[2]
    req(s >= 1 and chunk >= 1, f"ssd: needs s >= 1 and chunk >= 1 (s {s}, chunk {chunk})")
    req(dt.shape == (b, s, h) and dt.dtype == torch.float32,
        f"ssd: dt must be float32 ({b}, {s}, {h})")
    req(A.shape == (h,) and A.dtype == torch.float32, f"ssd: A must be float32 ({h},)")
    req(B.dtype == x.dtype and C.dtype == x.dtype, "ssd: x, B and C must share a dtype")
    req(x.stride(3) == 1 and x.stride(2) == p,
        "ssd: x's (h, p) axes must be contiguous within a timestep")
    req(B.stride(2) == 1 and C.stride(2) == 1, "ssd: B's and C's last axis must be contiguous")
    req(dt.is_contiguous() and A.is_contiguous(), "ssd: dt and A must be contiguous")
    if initial_state is not None:
        req(initial_state.shape == (b, h, p, n) and initial_state.dtype == torch.float32
            and initial_state.is_contiguous(),
            f"ssd: initial_state must be contiguous float32 ({b}, {h}, {p}, {n})")
    for t in (dt, A, B, C, initial_state):
        req(t is None or t.device == x.device, "ssd: inputs on different devices")
    code = _build.dtype_code(x, "ssd")
    pl = plan(x.dtype, p, n, chunk)
    if pl.kernel == "f32":
        q = min(chunk, s)
        if smem_bytes(p, n, q) > _build.SMEM_LIMIT:
            raise _build.SharedMemoryError(
                f"ssd: a chunk of {q} timesteps at p {p}, n {n} needs {smem_bytes(p, n, q)} "
                f"bytes of shared memory, above the card's {_build.SMEM_LIMIT}"
            )
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device) if return_state else None
    lib = _build.library()
    strides = (x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    if pl.kernel == "mma":
        cum = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
        states = torch.empty((b, chunks(s, chunk), h, p, n), dtype=torch.float32,
                             device=x.device)
        err = lib.rt_ssd_tc(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            _build.ptr(initial_state), y.data_ptr(), _build.ptr(final), cum.data_ptr(),
            states.data_ptr(), b, s, h, p, n, chunk, *strides, _build.stream_of(x),
        )
    else:
        err = lib.rt_ssd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            _build.ptr(initial_state), y.data_ptr(), _build.ptr(final), b, s, h, p, n, chunk,
            *strides, code, _build.stream_of(x),
        )
    launches += 1
    _build.check_launch(err, "ssd")
    return (y, final) if return_state else y
