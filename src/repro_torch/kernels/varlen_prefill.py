"""Packed varlen prefill attention: wrapper of the CUDA kernels
``csrc/varlen_prefill_tc.cuh`` (bf16, tensor cores) and
``csrc/varlen_prefill.cu`` (CUDA cores).

Replaces the TPU kernel ``repro/kernels/varlen_prefill.py:varlen_prefill``,
for a pool of q's dtype or an int8/fp8 pool with float32 per-row scales
(the context pages are dequantized inside the kernel; the chunks' own packed
K/V stay full precision).  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.varlen_prefill`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts wrapper calls that launch.

The kernel is chosen by dtype, head dim, rep and page size (:func:`plan`), a
dispatch and not a fallback: bfloat16 at a head dim that is a multiple of
16 up to 256 runs the tensor-core routine (``wgmma`` at d 128, the models',
``mma.sync`` at the others; a block order launch, then the attention);
float32, and bfloat16 at any other head dim, run the fp32 CUDA-core tile of
``csrc/common.cuh``, one block per (page, query head).  A float32 tile that
needs more shared memory than one block of the card has raises
:class:`~repro_torch.kernels._build.SharedMemoryError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build, ref

launches = 0

# bf16 tensor-core routine: keys per K/V tile (tiles sit at multiples of it
# from key 0), d 128's rows per block (two warpgroups of 64) and the most
# warps (16 rows each) of an mma.sync block
BLOCK_K = 32
WGMMA_ROWS = 128
MMA_MAX_WARPS = 4
BF16_HEAD_DIMS = tuple(range(16, 257, 16))
# per head dim: the kernel, keys per tile and tiles in the cp.async ring (the
# tuples instantiated in csrc/varlen_prefill_tc.cuh, RT_VARLEN and d 128)
BF16_TILES = {d: ("wgmma" if d == 128 else "mma", BLOCK_K, 3 if d <= 128 else 2)
              for d in BF16_HEAD_DIMS}


@dataclass(frozen=True)
class Plan:
    """The kernel a call takes and its tiling: ``kernel`` ``"wgmma"`` or
    ``"mma"`` (bf16, tensor cores) or ``"f32"`` (CUDA cores); ``rows`` query
    rows per block, ``block_k`` keys per K/V tile (f32: the page),
    ``stages`` tiles in the ring (1 for f32), ``rows_per_page`` the rows of
    one kv head in a packed page (``page_size * rep``), ``blocks_per_page``
    the blocks that share them and the block's ``smem_bytes``."""

    kernel: str
    rows: int
    block_k: int
    stages: int
    rows_per_page: int
    blocks_per_page: int
    smem_bytes: int


def bf16_smem_bytes(kernel: str, d: int, rows: int, stages: int, quantized: bool) -> int:
    """Shared memory of a bf16 block (csrc/varlen_prefill_tc.cuh
    ``smem_bytes``): the Q tile, then per ring stage a K and a V tile (rows
    of d for wgmma's swizzle, d + 8 for mma.sync), with an int8/fp8 pool
    also a K and V code tile and their f32 scales; wgmma's swizzle blocks
    take 1 KB more to align on 1024 bytes."""
    wgmma = kernel == "wgmma"
    row = d if wgmma else d + 8
    return (2 * (rows * row + stages * 2 * BLOCK_K * row)
            + (stages * 2 * BLOCK_K * (d + 4) if quantized else 0) + (1024 if wgmma else 0))


def plan(dtype: torch.dtype, d: int, rep: int, page_size: int, *,
         quantized: bool = False) -> Plan:
    """The kernel and tiling for q of ``dtype`` at head dim ``d`` with ``rep``
    query heads per kv head over pages of ``page_size`` keys
    (``quantized``: an int8/fp8 pool).  Raises ``TypeError`` for another
    dtype and :class:`~repro_torch.kernels._build.SharedMemoryError` for a
    float32 tile that does not fit a block."""
    per_page = page_size * rep
    if dtype == torch.bfloat16 and d in BF16_TILES:
        kernel, bk, stages = BF16_TILES[d]
        rows = WGMMA_ROWS if kernel == "wgmma" else 16 * min(MMA_MAX_WARPS, -(-per_page // 16))
        return Plan(kernel, rows, bk, stages, per_page, -(-per_page // rows),
                    bf16_smem_bytes(kernel, d, rows, stages, quantized))
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"varlen_prefill: dtype {dtype} not supported by the CUDA kernels "
                        f"(expected one of {list(_build.DTYPE_CODES)})")
    _build.check_tile("varlen_prefill", page_size, page_size, d)
    return Plan("f32", page_size, page_size, 1, per_page, rep,
                4 * _build.tile_floats(page_size, page_size, d))


def varlen_prefill(
    q: torch.Tensor,            # (T, h, d) packed queries
    k: torch.Tensor,            # (T, kvh, d) packed chunk K
    v: torch.Tensor,            # (T, kvh, d)
    k_pages: torch.Tensor,      # (num_pages, page_size, kvh, d) global pool
    v_pages: torch.Tensor,
    cu_seqlens: torch.Tensor,   # (C+1,) int32 packed chunk boundaries
    chunk_lens: torch.Tensor,   # (C,) int32 real tokens per chunk
    chunk_pos0: torch.Tensor,   # (C,) int32 absolute chunk starts (page-aligned)
    page_tables: torch.Tensor,  # (C, max_pages) int32
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kvh) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of every packed chunk over its request's committed pages
    plus its own causal prefix; pad rows come back exactly zero.  Chunk
    spans are page-aligned and the packed length a page multiple."""
    global launches
    if q.device.type == "cpu":
        return ref.varlen_prefill(
            q, k, v, k_pages, v_pages, cu_seqlens, chunk_lens, chunk_pos0,
            page_tables, softcap=softcap, window=window, scale=scale,
            pages_bound=pages_bound, k_scales=k_scales, v_scales=v_scales,
        )
    req = _build.require
    req(q.device.type == "cuda", f"varlen_prefill: unsupported device {q.device}")
    req(q.dim() == 3, f"varlen_prefill: q {tuple(q.shape)} != (T, h, d)")
    T, h, d = q.shape
    req(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
        "varlen_prefill: pools must be (num_pages, page_size, kvh, d) and alike")
    _, ps, kvh, dk = k_pages.shape
    req(k.shape == (T, kvh, d) and v.shape == (T, kvh, d),
        f"varlen_prefill: packed K/V must be ({T}, {kvh}, {d})")
    req(dk == d and h % kvh == 0, f"varlen_prefill: heads {h}/{kvh} or head dim {dk} != {d}")
    req(T % ps == 0, f"varlen_prefill: packed length {T} not a multiple of page {ps}")
    req(page_tables.dim() == 2, "varlen_prefill: page_tables must be (C, max_pages)")
    C, max_pages = page_tables.shape
    req(cu_seqlens.shape == (C + 1,) and chunk_lens.shape == (C,) and chunk_pos0.shape == (C,),
        "varlen_prefill: cu_seqlens (C+1,), chunk_lens and chunk_pos0 (C,)")
    ints = (cu_seqlens, chunk_lens, chunk_pos0, page_tables)
    req(all(t.dtype == torch.int32 for t in ints), "varlen_prefill: metadata must be int32")
    req(k.dtype == q.dtype and v.dtype == q.dtype,
        "varlen_prefill: q and the packed k, v must share a dtype")
    for t in (q, k, v, k_pages, v_pages, *ints):
        req(t.device == q.device, "varlen_prefill: inputs on different devices")
        req(t.is_contiguous(), "varlen_prefill: inputs must be contiguous")
    store = _build.kv_store_code("varlen_prefill", q, k_pages, v_pages, k_scales, v_scales)
    p = plan(q.dtype, d, h // kvh, ps, quantized=store != 0)
    scale = d ** -0.5 if scale is None else float(scale)
    ctx_bound = max_pages if pages_bound is None else max(0, min(int(pages_bound), max_pages))
    w = 0 if window is None else int(window)
    out = torch.empty_like(q)
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _build.ptr(k_scales), _build.ptr(v_scales), cu_seqlens.data_ptr(),
            chunk_lens.data_ptr(), chunk_pos0.data_ptr(), page_tables.data_ptr())
    if p.kernel == "f32":
        err = lib.rt_varlen_prefill(
            *ptrs, out.data_ptr(), T, C, h, kvh, d, ps, max_pages, ctx_bound, w, scale,
            float(softcap), _build.dtype_code(q, "varlen_prefill"), store, _build.stream_of(q),
        )
    else:
        # 16-byte copies: every row starts on a 16-byte boundary
        req(all(x % 16 == 0 for x in ptrs[:5]),
            "varlen_prefill: bf16 inputs and pools must be 16-byte aligned")
        # per packed page: key tiles its rows visit, then the pages by them
        scratch = torch.empty(2 * (T // ps), dtype=torch.int32, device=q.device)
        kind = "bf16" if store == 0 else "quant"
        err = getattr(lib, f"rt_varlen_prefill_{kind}")(
            *ptrs, scratch.data_ptr(), out.data_ptr(), T, C, h, kvh, d, ps, max_pages,
            ctx_bound, w, p.block_k, p.rows, p.stages, store, scale, float(softcap),
            _build.stream_of(q),
        )
    launches += 1
    _build.check_launch(err, "varlen_prefill")
    return out
