"""Forward flash attention: wrapper of the CUDA kernels
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(the forward pass; with ``return_lse`` it also gives each row's
log-sum-exp, which the backward :mod:`.flash_attention_bwd` recomputes P
from).  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.attention`, :func:`~.ref.attention_lse`); a
CUDA tensor launches a kernel or raises; a meta tensor (the dry run)
passes the same checks and gets the outputs the launcher allocates, and
nothing runs.  ``launches`` counts kernel launches.
:class:`FlashAttentionFn` is the differentiable op: this forward
with the log-sum-exp, then :func:`.flash_attention_bwd.flash_attention_bwd`.

The kernel is chosen by dtype and head dim (:func:`plan`), a dispatch and
not a fallback.  bfloat16 runs on the tensor cores with float32
accumulation: ``wgmma`` at head dim 128 (the models'), ``mma.sync`` at 16,
64, 80 (zamba2's shared attention; its tiles padded to rows of 88, see
:data:`BF16_TILES`) and 256; any other head dim raises ``ValueError``
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

from ..roofline import work
from ..roofline.count import kernel_scope
from . import _build, ref
from .flash_attention_bwd import flash_attention_bwd

launches = 0

# float32 tile: query rows per block (bq positions x the GQA group) and keys
# per online-softmax step
TILE_ROWS = 64
BLOCK_K = 32
# bf16 tensor-core kernels, per head dim they are built for: the kernel,
# keys per K/V tile, query rows per block, K/V tiles in the ring and the
# shared-memory tile layout (the tuples instantiated in
# csrc/flash_attention.cu).  "swizzle": rows of d, 16-byte chunks XOR-placed
# (wgmma's 128-byte blocks; mma.cuh Swizzle<d>, whose XOR needs d/8 a power
# of two); "padded": mma.cuh Padded<d>, rows of d + 8 (d 80's ten chunks)
BF16_TILES = {
    16: ("mma", 64, 64, 3, "swizzle"),
    64: ("mma", 32, 64, 3, "swizzle"),
    80: ("mma", 32, 64, 3, "padded"),
    128: ("wgmma", 32, 128, 3, "swizzle"),
    256: ("mma", 32, 64, 2, "swizzle"),
}
BF16_HEAD_DIMS = tuple(sorted(BF16_TILES))


@dataclass(frozen=True)
class Plan:
    """The kernel a call takes and its tile: ``kernel`` is ``"wgmma"`` or
    ``"mma"`` (bf16, tensor cores) or ``"f32"`` (CUDA cores); ``rows`` query
    rows per block, ``block_k`` keys per K/V step, ``positions`` query
    positions per block of the f32 tile (0 for bf16, whose tiles cut the
    rows of a kv head at multiples of ``rows``), ``stages`` K/V tiles in the
    bf16 ring (1 for f32), the block's ``smem_bytes`` and the bf16 tile
    ``layout`` (:data:`BF16_TILES`; ``"rows"`` for f32)."""

    kernel: str
    rows: int
    block_k: int
    positions: int
    stages: int
    smem_bytes: int
    layout: str


def row_stride(layout: str, d: int) -> int:
    """Elements a tile row of ``layout`` takes in shared memory (mma.cuh
    ``kStride``): ``d + 8`` padded, else ``d``."""
    return d + 8 if layout == "padded" else d


def bf16_smem_bytes(kernel: str, layout: str, d: int, block_k: int, rows: int,
                    stages: int) -> int:
    """Shared memory of a bf16 kernel (csrc/flash_attention.cu
    ``bf16_smem_bytes``): the Q tile, then K and V tiles per ring stage, rows
    of :func:`row_stride`; wgmma's swizzle blocks take 1 KB more to align on
    1024 bytes."""
    stride = row_stride(layout, d)
    return 2 * (rows * stride + stages * 2 * block_k * stride) + (1024 if kernel == "wgmma"
                                                                 else 0)


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
        kernel, bk, rows, stages, layout = BF16_TILES[d]
        p = Plan(kernel, rows, bk, 0, stages,
                 bf16_smem_bytes(kernel, layout, d, bk, rows, stages), layout)
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
    return Plan("f32", rows, BLOCK_K, bq, 1, 4 * _build.tile_floats(rows, BLOCK_K, d), "rows")


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
    return_lse: bool = False,
):
    """Attention of query row ``i`` (position ``q_offset + i``) over the
    keys ``j < sk`` with (causal) ``q_pos >= j`` and (window, a runtime int,
    0 or None for none) ``q_pos - j < window``; rows with no live key come
    back exactly zero.  With ``return_lse``, ``(out, lse)``: ``lse`` (b, h,
    sq) float32 is each row's log-sum-exp of its live scores
    (:func:`~.ref.attention_lse`), and ``out`` has the same bits as
    without."""
    global launches
    if q.device.type == "cpu":
        fn = ref.attention_lse if return_lse else ref.attention
        return fn(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                  scale=scale)
    req = _build.require
    req(q.device.type in ("cuda", "meta"), f"flash_attention: unsupported device {q.device}")
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
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse
           else None)
    if q.device.type == "meta":
        # the dry run: the launcher's outputs, no launch
        return (out, lse) if return_lse else out
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse))
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
    return (out, lse) if return_lse else out


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable :func:`flash_attention`: the forward keeps q, k, v,
    the output and its log-sum-exp; the backward is
    :func:`~.flash_attention_bwd.flash_attention_bwd` (the kernels on a CUDA
    tensor, :func:`~.ref.flash_attention_bwd` on the CPU), as the JAX
    package's ``_flash_vjp`` keeps (q, k, v, out, m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, scale):
        opts = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                    scale=scale)
        out, lse = flash_attention(q, k, v, return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with kernel_scope("flash_attention_bwd", lambda: work.attention_bwd_call(q, k, v,
                                                                                 **ctx.opts)):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None, None
