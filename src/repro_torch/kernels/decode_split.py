"""The plan and the launch of the bf16 decode family's split-KV routine
``csrc/decode_split.cuh``, shared by the wrappers of ``paged_attention``
(its one-token instance), ``spec_verify`` (its W-token instance) and
``decode_attention`` (the one-token instance over a dense cache viewed as
a pool).  Each wrapper counts its own launches.

:func:`plan` picks the kernel by dtype, a dispatch and not a fallback:
bfloat16 runs the tensor-core routine (``"mma"``) at every head dim that
is a multiple of 16 from 16 to 256 and every page size that is a multiple
of 8, and raises ``ValueError`` elsewhere; float32 runs the exact CUDA-core
tile of ``csrc/common.cuh`` (``"f32"``), with the query rows of a kv head
cut into chunks that fit a block.  The split, ``split_keys`` keys anchored
at key 0, depends on the page size and head dim alone, never on the batch,
the lengths or ``pages_bound``: what keeps a verify row and a one-token
call over the same keys bit for bit equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

# bf16 routine: the fewest keys a split holds (it holds a whole number of
# pages and of key chunks): at 8 slots of ~420 live keys, 64-key splits
# give ~100 working blocks on the card's 132 SMs
SPLIT_KEYS_MIN = 64
MAX_WARPS = 8                 # m16 row tiles per block
STAGES = 2                    # K/V chunks in the cp.async ring
BF16_HEAD_DIMS = tuple(range(16, 257, 16))
# the (d, keys per chunk, stages) instantiated in csrc/decode_split.cuh (RT_SPLIT)
BF16_TILES = {d: (32 if d <= 128 else 16, STAGES) for d in BF16_HEAD_DIMS}


@dataclass(frozen=True)
class Plan:
    """The kernel a call takes and its tiling: ``kernel`` ``"mma"`` (bf16,
    tensor cores) or ``"f32"`` (CUDA cores); ``split_keys`` keys per split
    (0 for f32, which walks a row's keys in one block), ``block_k`` keys per
    K/V chunk (f32: the page), ``rows`` query rows per block,
    ``row_chunks`` blocks that share a kv head's ``rep * W`` rows,
    ``stages`` chunks in the ring (1 for f32) and the block's
    ``smem_bytes``."""

    kernel: str
    split_keys: int
    block_k: int
    rows: int
    row_chunks: int
    stages: int
    smem_bytes: int


def split_keys(page_size: int, d: int) -> int:
    """Keys per split: the least whole number of pages and of key chunks
    holding at least ``SPLIT_KEYS_MIN`` keys."""
    unit = math.lcm(page_size, BF16_TILES[d][0])
    return unit * -(-SPLIT_KEYS_MIN // unit)


def bf16_smem_bytes(d: int, block_k: int, rows: int, stages: int, quantized: bool) -> int:
    """Shared memory of a bf16 block (csrc/decode_split.cuh ``smem_bytes``):
    the Q tile in rows of d + 8, then a K and a V tile per ring stage; with
    an int8/fp8 pool one bf16 K/V tile pair plus, per stage, the codes and
    their f32 scales."""
    q = 2 * rows * (d + 8)
    if quantized:
        return q + 2 * 2 * block_k * (d + 8) + stages * 2 * block_k * (d + 4)
    return q + 2 * stages * 2 * block_k * (d + 8)


def f32_rows(page_size: int, d: int) -> int:
    """The most query rows the float32 tile of ``page_size`` keys at head
    dim ``d`` holds within one block's shared memory (``tile_floats`` is
    linear in the rows)."""
    fixed = _build.tile_floats(0, page_size, d)
    per_row = _build.tile_floats(1, page_size, d) - fixed
    return (_build.SMEM_LIMIT // 4 - fixed) // per_row


def plan(dtype: torch.dtype, d: int, rep: int, W: int, page_size: int, *,
         quantized: bool = False) -> Plan:
    """The kernel and tiling for ``W`` query positions of ``rep`` heads per
    kv head at head dim ``d`` over pages of ``page_size`` keys (``quantized``:
    an int8/fp8 pool).  Raises ``ValueError`` for a bf16 head dim or page
    size the routine does not take, ``TypeError`` for another dtype, and
    :class:`~repro_torch.kernels._build.SharedMemoryError` when not one
    float32 row fits a block."""
    R = W * rep
    if dtype == torch.bfloat16:
        _build.require(d in BF16_TILES,
                       f"decode attention: bf16 head dim {d} not supported (the kernel takes "
                       f"multiples of 16 from 16 to 256)")
        _build.require(page_size > 0 and page_size % 8 == 0,
                       f"decode attention: bf16 page size {page_size} not supported (the "
                       f"kernel takes multiples of 8)")
        bk, stages = BF16_TILES[d]
        tiles = -(-R // 16)
        chunks = -(-tiles // MAX_WARPS)
        rows = 16 * -(-tiles // chunks)
        return Plan("mma", split_keys(page_size, d), bk, rows, chunks, stages,
                    bf16_smem_bytes(d, bk, rows, stages, quantized))
    if dtype != torch.float32:
        raise TypeError(f"decode attention: dtype {dtype} not supported by the CUDA kernels "
                        f"(expected one of {list(_build.DTYPE_CODES)})")
    fit = f32_rows(page_size, d)
    if fit < 1:
        raise _build.SharedMemoryError(
            f"decode attention: one float32 row of {page_size} keys at head dim {d} needs "
            f"{4 * _build.tile_floats(1, page_size, d)} bytes of shared memory, above the "
            f"card's {_build.SMEM_LIMIT}")
    chunks = -(-R // fit)
    rows = -(-R // chunks)
    return Plan("f32", 0, page_size, rows, chunks, 1,
                4 * _build.tile_floats(rows, page_size, d))


def n_splits(p: Plan, max_pages: int, page_size: int, key_cap: Optional[int]) -> int:
    """Splits of a launch: those that cover the keys it may read."""
    keys = max_pages * page_size if key_cap is None else min(max_pages * page_size, key_cap)
    return -(-keys // p.split_keys)


def launch(name: str, p: Plan, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           table: Optional[torch.Tensor], lengths: torch.Tensor,
           window_lens: Optional[torch.Tensor], *,
           max_pages: int, key_cap: Optional[int], window: int, scale: float, softcap: float,
           store: int, k_scales: Optional[torch.Tensor],
           v_scales: Optional[torch.Tensor]) -> torch.Tensor:
    """One call of the bf16 routine (two CUDA launches: the splits, then
    their combine) for q ``(b, W, h, d)``; ``window_lens`` None is the
    one-token instance, ``table`` None the identity table (slot ``i`` owns
    pool pages ``[i * w, (i + 1) * w)``, ``w = num_pages // b``: a dense
    cache viewed as a pool).  The wrapper has checked shapes and devices;
    the split scratch is allocated here."""
    b, W, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    R = W * (h // kvh)
    ns = n_splits(p, max_pages, ps, key_cap)
    # 16-byte copies: every row starts on a 16-byte boundary
    _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
                   f"{name}: q and the pools must be 16-byte aligned")
    n = b * kvh * ns * R
    stats = torch.empty(2 * n, dtype=torch.float32, device=q.device)     # m, l
    acc = torch.empty(n * d, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    kind = "bf16" if store == 0 else "quant"
    width = k_pages.shape[0] // b if table is None else table.shape[1]
    err = getattr(_build.library(), f"rt_decode_split_{kind}")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), _build.ptr(k_scales),
        _build.ptr(v_scales), _build.ptr(table), lengths.data_ptr(), _build.ptr(window_lens),
        stats.data_ptr(), stats[n:].data_ptr(), acc.data_ptr(), out.data_ptr(),
        b, W, h, kvh, d, ps, width, max_pages,
        2**31 - 1 if key_cap is None else int(key_cap), window, p.split_keys, p.block_k,
        p.rows, p.stages, store, scale, softcap, _build.stream_of(q),
    )
    _build.check_launch(err, name)
    return out
