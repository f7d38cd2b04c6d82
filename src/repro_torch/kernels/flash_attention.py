"""Forward flash attention: wrapper of the CUDA kernels
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(the forward pass; the training backward is not ported yet).  A CPU tensor
runs the plain version (:func:`repro_torch.kernels.ref.attention`); a CUDA
tensor launches a kernel or raises.  ``launches`` counts kernel launches.

The kernel is chosen by dtype and head dim (:func:`plan`), a dispatch and
not a fallback.  bfloat16 runs on the tensor cores with float32
accumulation: ``wgmma`` at head dim 128 (the models'), ``mma.sync`` at 16,
64 and 256; any other head dim raises ``ValueError``
(:data:`BF16_HEAD_DIMS`).  float32 runs the fp32 CUDA-core tile of
``csrc/common.cuh``, since the tensor cores have no full-precision float32
product and the float32 checks hold the card's tokens equal to the CPU's.
A tile that needs more shared memory than one block of the card has raises
:class:`~repro_torch.kernels._build.SharedMemoryError`; nothing falls back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build, ref

launches = 0

# float32 tile: query rows per block (bq positions x the GQA group) and keys
# per online-softmax step
TILE_ROWS = 64
BLOCK_K = 32
# bf16 tensor-core kernels, per head dim they are built for: the kernel,
# keys per K/V tile, query rows per block and K/V tiles in the ring (the
# tuples instantiated in csrc/flash_attention.cu)
BF16_TILES = {
    16: ("mma", 64, 64, 3),
    64: ("mma", 32, 64, 3),
    128: ("wgmma", 32, 128, 3),
    256: ("mma", 32, 64, 2),
}
BF16_HEAD_DIMS = tuple(sorted(BF16_TILES))


@dataclass(frozen=True)
class Plan:
    """The kernel a call takes and its tile: ``kernel`` is ``"wgmma"`` or
    ``"mma"`` (bf16, tensor cores) or ``"f32"`` (CUDA cores); ``rows`` query
    rows per block, ``block_k`` keys per K/V step, ``positions`` query
    positions per block of the f32 tile (0 for bf16, whose tiles cut the
    rows of a kv head at multiples of ``rows``), ``stages`` K/V tiles in the
    bf16 ring (1 for f32), and the block's ``smem_bytes``."""

    kernel: str
    rows: int
    block_k: int
    positions: int
    stages: int
    smem_bytes: int


def bf16_smem_bytes(kernel: str, d: int, block_k: int, rows: int, stages: int) -> int:
    """Shared memory of a bf16 kernel (csrc/flash_attention.cu
    ``bf16_smem_bytes``): the Q tile, then K and V tiles per ring stage;
    wgmma's swizzle blocks take 1 KB more to align on 1024 bytes."""
    return 2 * (rows * d + stages * 2 * block_k * d) + (1024 if kernel == "wgmma" else 0)


def plan(dtype: torch.dtype, d: int, rep: int) -> Plan:
    """The kernel and tile for q of ``dtype`` at head dim ``d`` with ``rep``
    query heads per kv head.  Raises ``ValueError`` for a bf16 head dim the
    kernel is not built for, ``TypeError`` for another dtype, and
    :class:`~repro_torch.kernels._build.SharedMemoryError` for a tile that
    does not fit a block."""
    if dtype == torch.bfloat16:
        _build.require(d in BF16_TILES,
                       f"flash_attention: bf16 head dim {d} not supported (the kernel is "
                       f"built for head dims {BF16_HEAD_DIMS})")
        kernel, bk, rows, stages = BF16_TILES[d]
        p = Plan(kernel, rows, bk, 0, stages, bf16_smem_bytes(kernel, d, bk, rows, stages))
        if p.smem_bytes > _build.SMEM_LIMIT:
            raise _build.SharedMemoryError(
                f"flash_attention: the bf16 tile at head dim {d} needs {p.smem_bytes} bytes "
                f"of shared memory, above the card's {_build.SMEM_LIMIT}")
        return p
    if dtype != torch.float32:
        raise TypeError(f"flash_attention: dtype {dtype} not supported by the CUDA kernels "
                        f"(expected one of {list(_build.DTYPE_CODES)})")
    bq = max(1, TILE_ROWS // rep)
    rows = bq * rep
    _build.check_tile("flash_attention", rows, BLOCK_K, d)
    return Plan("f32", rows, BLOCK_K, bq, 1, 4 * _build.tile_floats(rows, BLOCK_K, d))


def flash_attention(
    q: torch.Tensor,            # (b, sq, h, d)
    k: torch.Tensor,            # (b, sk, kvh, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of query row ``i`` (position ``q_offset + i``) over the
    keys ``j < sk`` with (causal) ``q_pos >= j`` and (window, a runtime int,
    0 or None for none) ``q_pos - j < window``; rows with no live key come
    back exactly zero."""
    global launches
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                             q_offset=q_offset, scale=scale)
    req = _build.require
    req(q.device.type == "cuda", f"flash_attention: unsupported device {q.device}")
    req(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
        "flash_attention: q must be (b, sq, h, d), k and v (b, sk, kvh, d) and alike")
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    req(k.shape[0] == b and dk == d and h % kvh == 0,
        f"flash_attention: q {tuple(q.shape)} does not pair with k {tuple(k.shape)}")
    req(sq > 0 and sk > 0, "flash_attention: empty query or key sequence")
    req(int(q_offset) >= 0, "flash_attention: q_offset must be >= 0")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "flash_attention: q, k and v must share a dtype")
    for t in (k, v):
        req(t.device == q.device, "flash_attention: inputs on different devices")
    for t in (q, k, v):
        req(t.is_contiguous(), "flash_attention: inputs must be contiguous")
    p = plan(q.dtype, d, h // kvh)
    scale = d ** -0.5 if scale is None else float(scale)
    w = 0 if window is None else int(window)
    out = torch.empty_like(q)
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if p.kernel != "f32":
        # 16-byte copies: every row starts on a 16-byte boundary
        req(all(x % 16 == 0 for x in ptrs[:3]),
            "flash_attention: bf16 inputs must be 16-byte aligned")
        err = lib.rt_flash_attention_bf16(
            *ptrs, b, sq, sk, h, kvh, d, p.block_k, p.rows, p.stages, int(bool(causal)), w,
            int(q_offset), scale, float(softcap), _build.stream_of(q),
        )
    else:
        err = lib.rt_flash_attention_f32(
            *ptrs, b, sq, sk, h, kvh, d, p.positions, p.block_k, int(bool(causal)), w,
            int(q_offset), scale, float(softcap), _build.stream_of(q),
        )
    launches += 1
    _build.check_launch(err, "flash_attention")
    return out
