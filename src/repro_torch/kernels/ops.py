"""Kernel dispatch layer (the port's counterpart of ``repro.kernels.ops``).

Models call these ops; each dispatches on the device of its tensors.  A CPU
tensor runs the plain version in :mod:`.ref`.  A CUDA tensor runs the
hand-written kernel, or the call raises: there is no fallback, and unlike
the JAX package there is no backend switch that would route the card's
path around the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .paged_attention import paged_attention as _paged_attention
from .rmsnorm import rmsnorm as _rmsnorm
from .spec_verify import spec_verify as _spec_verify
from .ssd import ssd as _ssd
from .varlen_prefill import varlen_prefill as _varlen_prefill

NEG_INF = ref.NEG_INF


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-sequence GQA attention (prefill, ``forward``): q ``(b, sq, h,
    d)`` at positions ``q_offset + i`` over k/v ``(b, sk, kvh, d)``."""
    return _flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                            q_offset=q_offset, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode attention over a dense ``(b, S, kvh, d)`` cache.
    ``kv_bound`` is a host-known bound on ``lengths`` (the engines bucket it
    to a power of two): keys past it are never read."""
    return _decode_attention(q, k_cache, v_cache, lengths, softcap=softcap,
                             window=window, scale=scale, kv_bound=kv_bound)


def varlen_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    cu_seqlens: torch.Tensor,
    chunk_lens: torch.Tensor,
    chunk_pos0: torch.Tensor,
    page_tables: torch.Tensor,
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed ragged-prefill attention: chunks from many requests share one
    token-packed buffer; each chunk attends its request's committed pages
    plus the causal prefix of its own tokens.  ``pages_bound`` bounds
    context pages per chunk (host-known, bucketed); ``k_scales``/
    ``v_scales`` come with an int8/fp8 pool."""
    return _varlen_prefill(
        q, k, v, k_pages, v_pages, cu_seqlens, chunk_lens, chunk_pos0,
        page_tables, softcap=softcap, window=window, scale=scale,
        pages_bound=pages_bound, k_scales=k_scales, v_scales=v_scales,
    )


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over a paged KV cache (global page pool + per-request
    page table).  ``pages_bound`` bounds the live pages per request."""
    return _paged_attention(
        q, k_pages, v_pages, page_table, lengths, softcap=softcap,
        window=window, scale=scale, pages_bound=pages_bound,
        k_scales=k_scales, v_scales=v_scales,
    )


def spec_verify(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    window_lens: torch.Tensor,
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Speculative multi-token verification over a paged KV cache: one
    ``(b, W)`` launch scores each slot's ``[next_token, draft_1..]`` window
    against its committed pages plus the window's own causal prefix.
    ``pages_bound`` bounds committed-plus-in-flight pages per slot."""
    return _spec_verify(
        q, k_pages, v_pages, page_table, lengths, window_lens, softcap=softcap,
        window=window, scale=scale, pages_bound=pages_bound,
        k_scales=k_scales, v_scales=v_scales,
    )


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _rmsnorm(x, weight, eps)


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Mamba-2 SSD scan of a whole sequence (prefill, ``forward``): x ``(b,
    s, h, p)``, dt ``(b, s, h)`` float32, A ``(h,)`` float32, B/C ``(b, s,
    n)``; y and, with ``return_state``, the final state in x's dtype."""
    return _ssd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state,
                return_state=return_state)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, state: torch.Tensor):
    """One decode step of the SSD recurrence: the plain version on every
    device, as the JAX package shares one implementation (no Pallas
    kernel); promoted to a kernel only if a profile shows it matters."""
    return ref.ssd_step(x, dt, A, B, C, state)
