"""Flash-attention backward: wrapper of the CUDA kernels
``csrc/flash_attention_bwd.cu``.

Replaces the backward of the TPU flash path, ``repro/kernels/ops.py``
``_flash_vjp``/``_flash_bwd_core`` (the custom VJP around
``repro/kernels/flash_attention.py:flash_attention``).  A CPU tensor runs
the plain version (:func:`repro_torch.kernels.ref.flash_attention_bwd`); a
CUDA tensor launches the kernels or raises.  ``launches`` counts calls that
launch, one each whatever the route.

Routes (:func:`route`, from dtype and head dim; a dispatch, never a
fallback):

- ``"tc"``: bfloat16 at d 16, 64, 80 and 128 (:data:`TC_TILES`; 128 and 80
  are the head dims phase 4c trains), ``mma.sync`` on the tensor cores:
  D and the rows' and keys' norms (:func:`tc_stats_floats` float32 of
  scratch), dK/dV by blocks of 64 keys, their split sum where ``splits >
  1``, dQ by blocks of 64 query rows (three CUDA launches, four with
  splits).  A GQA group too wide for the grid to fill the card is split
  over ``splits`` blocks (:func:`tc_splits`), each writing float32 partial
  dK and dV into a scratch of ``2 x (b, kvh, splits, sk, d)`` float32 that
  this wrapper allocates (:func:`tc_scratch_bytes`: 33.6 MB at glm4-9b's
  phase-4c microbatch (2, 1024) with 8 splits, 33.6 MB at (4, 1024) with
  4; none at zamba2's d 80, rep 1), summed in split order.  P and dS are
  rounded to bf16 from the plain version's float32 values: a pair within
  :data:`TIE` times its rows' norms of a bf16 rounding midpoint is
  recomputed with its score and dP summed in column order, and the
  difference of the roundings is added to the sums.
- ``"cuda_cores"``: float32, and bfloat16 at every other head dim (d 256:
  16 keys' dK and dV accumulators of 256 columns would need 256 registers a
  thread), unchanged from the first port: float32 tiles in shared memory,
  one dot product per thread (three CUDA launches).  A head dim whose tile
  fits no block raises :class:`~repro_torch.kernels._build.SharedMemoryError`
  (:func:`plan`).

No route uses an atomic: the same inputs give the same bits on every run.
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


# bf16 head dims on the tensor cores: d -> (query rows a dK/dV step, stages
# of its ring of row tiles, keys a dQ step, dQ blocks an SM the compiler
# must fit (its registers), tile layout): csrc/flash_attention_bwd.cu
# RT_FLASH_BWD_TC.  A dK/dV block holds 64 keys (16 a warp) and a dQ block
# 64 query rows.
TC_TILES = {
    16: (64, 2, 64, 2, "swizzle"),
    64: (32, 3, 64, 2, "swizzle"),
    80: (32, 3, 32, 2, "padded"),
    128: (16, 4, 32, 3, "swizzle"),
}
TC_KEYS = 64
TC_ROWS = 64
# bound on the distance of a tensor-core dot product (score q.k, dP = dO.v)
# from the plain version's column-order float32 sum, per unit of |a| |b|: a
# P or dS within the propagated bound of a bf16 rounding midpoint is
# recomputed in column order (csrc tc_pair, exact_pair).  On an H100 at
# glm4-9b's and zamba2's training shapes, d 64 and a softcap of 2, 2**-24
# found every one of the 41,977 roundings that an unbounded recompute found
# to differ, 2**-25 all but two and 2**-26 99.5% of them
TIE = 2.0 ** -24
# streaming multiprocessors of an H100; the dK/dV grid should cover them
# at least twice
SMS = 132


def route(dtype: torch.dtype, d: int) -> str:
    """``"tc"`` (bf16 at a head dim of :data:`TC_TILES`, the tensor cores)
    or ``"cuda_cores"`` (every other case)."""
    return "tc" if dtype == torch.bfloat16 and d in TC_TILES else "cuda_cores"


def _stride(d: int) -> int:
    # elements a tile row takes (mma.cuh kStride): d + 8 in a Padded tile
    return d + 8 if TC_TILES[d][4] == "padded" else d


def tc_smem_bytes(d: int) -> Tuple[int, int]:
    """Shared memory of the dK/dV and the dQ block at head dim ``d``
    (csrc ``dkdv_tc_bytes``, ``dq_tc_bytes``): K and V tiles and two
    a ring of Q, dO tiles and their rows' lse, D, |q|, |dO|; Q and dO tiles
    and two buffers of K and V tiles and their keys' |k|, |v|; tiles bf16,
    statistics float32."""
    rows, stages, keys, _, _ = TC_TILES[d]
    stride = _stride(d)
    return (2 * (2 * TC_KEYS + 2 * stages * rows) * stride + 4 * 4 * stages * rows,
            2 * (2 * TC_ROWS + 4 * keys) * stride + 4 * 4 * keys)


def tc_splits(b: int, sk: int, kvh: int, rep: int, sms: int = SMS) -> int:
    """Blocks that share one kv head's GQA group in the dK/dV launch: the
    least divisor of ``rep`` whose grid covers ``sms`` at least twice, else
    ``rep`` (one head a block)."""
    tiles = -(-sk // TC_KEYS) * b * kvh
    for s in range(1, rep + 1):
        if rep % s == 0 and tiles * s >= 2 * sms:
            return s
    return rep


def tc_stats_floats(b: int, sq: int, sk: int, h: int, kvh: int) -> int:
    """Floats of the tensor-core route's statistics: D, |q| and |dO| of
    each query row, |k| and |v| of each key (csrc ``Stats``)."""
    return 3 * b * h * sq + 2 * b * kvh * sk


def tc_scratch_bytes(b: int, sk: int, kvh: int, d: int, splits: int) -> int:
    """Bytes of the float32 partial dK and dV (0 with one split)."""
    return 0 if splits == 1 else 2 * 4 * b * kvh * splits * sk * d


def plan(d: int) -> Tuple[int, int]:
    """(query rows, keys) per tile of the CUDA-core route at head dim ``d``; raises
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
    path = route(q.dtype, d)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # D (the tensor-core route: and the rows' and keys' norms)
    dsum = torch.empty(tc_stats_floats(b, sq, sk, h, kvh) if path == "tc" else b * h * sq,
                       dtype=torch.float32, device=q.device)
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    opts = (int(bool(causal)), w, int(q_offset), scale, float(softcap))
    if path == "tc":
        # 16-byte copies: every row starts on a 16-byte boundary
        req(all(x % 16 == 0 for x in ptrs[:5]),
            "flash_attention_bwd: bf16 inputs must be 16-byte aligned")
        splits = tc_splits(b, sk, kvh, h // kvh,
                           torch.cuda.get_device_properties(q.device).multi_processor_count)
        nbytes = tc_scratch_bytes(b, sk, kvh, d, splits)
        partial = (torch.empty(nbytes // 4, dtype=torch.float32, device=q.device) if nbytes
                   else None)
        err = lib.rt_flash_attention_bwd_tc(
            *ptrs, _build.ptr(partial), b, sq, sk, h, kvh, d, splits, *opts, TIE,
            _build.stream_of(q),
        )
    else:
        rows, bk = plan(d)
        err = lib.rt_flash_attention_bwd(
            *ptrs, b, sq, sk, h, kvh, d, rows, bk, *opts, code, _build.stream_of(q),
        )
    launches += 1
    _build.check_launch(err, "flash_attention_bwd")
    return dq, dk, dv
