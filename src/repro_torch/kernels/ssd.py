"""Mamba-2 SSD chunked scan: wrapper of the CUDA kernel ``csrc/ssd.cu``.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py:ssd``.  A CPU tensor
runs the plain version (:func:`repro_torch.kernels.ref.ssd`, the sequential
recurrence); a CUDA tensor launches the kernel or raises.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref

launches = 0


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of one block of ``csrc/ssd.cu`` (``ssd_smem_floats``):
    the float32 state slice p x (n+1), a chunk's x (chunk x p), B and C
    (chunk x (n+1) each), the chunk x chunk intra-chunk matrix and four
    per-timestep vectors."""
    return 4 * (p * (n + 1) + chunk * p + 2 * chunk * (n + 1) + chunk * chunk + 4 * chunk)


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
    q = min(chunk, s)
    if smem_bytes(p, n, q) > _build.SMEM_LIMIT:
        raise _build.SharedMemoryError(
            f"ssd: a chunk of {q} timesteps at p {p}, n {n} needs {smem_bytes(p, n, q)} "
            f"bytes of shared memory, above the card's {_build.SMEM_LIMIT}"
        )
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device) if return_state else None
    lib = _build.library()
    err = lib.rt_ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        _build.ptr(initial_state), y.data_ptr(), _build.ptr(final), b, s, h, p, n, chunk,
        x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        code, _build.stream_of(x),
    )
    launches += 1
    _build.check_launch(err, "ssd")
    return (y, final) if return_state else y
