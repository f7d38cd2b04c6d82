"""Quantized KV page storage: per-row scale quantization for the paged pool.

A copy of ``repro.kernels.kvquant`` in PyTorch.  The paged KV pool may
store K/V as ``int8`` or ``fp8`` (``torch.float8_e4m3fn``) codes with a
parallel float32 scale pool of shape ``(num_pages, page_size, kvh)``: one
scale per page row per kv head, the granularity at which the serving
writes land, so an append never requantizes earlier rows.  The attention
kernels dequantize at load (``code * scale`` in float32).  Quantize-on-
append is plain torch on the card too, as the JAX package does it in
``jnp`` outside its Pallas kernels.  ``quantize`` gives the JAX codes and
scales bit for bit: the same float32 operations, and ``torch.round``
rounds half to even like ``jnp.round``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "KV_DTYPES",
    "dequantize",
    "is_quantized",
    "kv_bytes_per_token",
    "pool_dtype",
    "quant_max",
    "quantize",
]

# kv_dtype name -> (pool dtype, largest representable magnitude)
KV_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
_FULL = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16, "f32": torch.float32, "bf16": torch.bfloat16}


def is_quantized(kv_dtype: Optional[str]) -> bool:
    """True when ``kv_dtype`` names a quantized pool (None and the
    full-precision dtype names are not); raises on an unknown name."""
    if kv_dtype is None:
        return False
    if kv_dtype in KV_DTYPES:
        return True
    if kv_dtype in _FULL:
        return False
    raise ValueError(
        f"unknown kv_dtype {kv_dtype!r}; expected one of "
        f"{sorted(KV_DTYPES)} or a full-precision dtype"
    )


def pool_dtype(kv_dtype: str) -> torch.dtype:
    """Storage dtype of the K/V page pools under ``kv_dtype``."""
    return KV_DTYPES[kv_dtype][0]


def quant_max(dtype: torch.dtype) -> float:
    """Largest representable magnitude of a quantized pool dtype."""
    for pool, qmax in KV_DTYPES.values():
        if dtype == pool:
            return qmax
    raise ValueError(f"{dtype} is not a quantized KV pool dtype")


def quantize(x: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize K/V rows ``x`` (..., kvh, d) to ``dtype`` with one float32
    scale per (row, head): ``scale = amax / qmax``; int8 codes are
    ``clip(round(x / scale))``, fp8 codes a plain cast.  All-zero rows get
    scale 0 and dequantize to exact zeros.  Returns ``(codes, scales)``."""
    qmax = quant_max(dtype)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)                            # (..., kvh)
    scales = amax / qmax
    inv = torch.where(scales > 0, 1.0 / scales.clamp_min(1e-37), torch.zeros_like(scales))
    scaled = xf * inv[..., None]
    if dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(dtype)
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize`: (..., kvh, d) x (..., kvh) -> float32."""
    return q.float() * scales.float()[..., None]


def kv_bytes_per_token(num_layers: int, num_kv_heads: int, head_dim: int,
                       kv_dtype: str) -> int:
    """KV-pool bytes one token costs across all layers (K + V + scales)."""
    if is_quantized(kv_dtype):
        per_head = head_dim * pool_dtype(kv_dtype).itemsize + 4   # codes + f32 scale
    else:
        per_head = head_dim * _FULL[kv_dtype].itemsize
    return 2 * num_layers * num_kv_heads * per_head
