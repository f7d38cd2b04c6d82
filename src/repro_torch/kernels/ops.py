"""Kernel dispatch layer (the port's counterpart of ``repro.kernels.ops``).

Models call these ops; each dispatches on the device of its tensors.  A CPU
tensor runs the plain version in :mod:`.ref`.  A CUDA tensor runs the
hand-written kernel, or the call raises: there is no fallback, and unlike
the JAX package there is no backend switch that would route the card's
path around the kernels.  :func:`copy_pages`, :func:`export_pages` and
:func:`import_pages` are plain torch indexing on every device, as the JAX
package writes them in plain ``jnp``.

Gradients: with grad mode on and an input that requires grad,
:func:`attention`, :func:`rmsnorm` and :func:`ssd` run their
``autograd.Function`` (the forward kernel, then the backward kernel; the
plain versions on the CPU), and otherwise make exactly the serving call.
The serving-only ops (:func:`decode_attention`, :func:`paged_attention`,
:func:`varlen_prefill`, :func:`spec_verify`) have no backward and raise
``NotImplementedError`` when asked for a gradient, on any device.  No op
hands back a tensor cut off from its inputs' graph.

Under the roofline's counter (:func:`repro_torch.roofline.count_costs`)
each op that stands for a TPU kernel counts its work once, from
:mod:`repro_torch.roofline.work`, and nothing of what it runs inside; so do
the backwards of the three autograd functions.  Without a counter
the check is one module global.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ..roofline import work
from ..roofline.count import counted
from . import ref
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import FlashAttentionFn
from .flash_attention import flash_attention as _flash_attention
from .paged_attention import paged_attention as _paged_attention
from .rmsnorm import RMSNormFn
from .rmsnorm import rmsnorm as _rmsnorm
from .spec_verify import spec_verify as _spec_verify
from .ssd import SSDFn
from .ssd import ssd as _ssd
from .varlen_prefill import varlen_prefill as _varlen_prefill

NEG_INF = ref.NEG_INF


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records this call: grad mode on and an input that
    requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Refuse a gradient through a serving-only kernel op."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward: it is a serving kernel (decode and prefill over "
            f"caches); training attends through ops.attention")


def _attention_work(q, k, v, **kw):
    return work.attention_call(q, k, v, lse=wants_grad(q, k, v), **kw)


@counted("flash_attention", _attention_work)
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
    d)`` at positions ``q_offset + i`` over k/v ``(b, sk, kvh, d)``;
    differentiable (:class:`~.flash_attention.FlashAttentionFn`)."""
    if wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap, q_offset, scale)
    return _flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                            q_offset=q_offset, scale=scale)


@counted("decode_attention", work.decode_attention_call)
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
    _no_backward("decode_attention", q, k_cache, v_cache)
    return _decode_attention(q, k_cache, v_cache, lengths, softcap=softcap,
                             window=window, scale=scale, kv_bound=kv_bound)


@counted("varlen_prefill", work.varlen_prefill_call)
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
    _no_backward("varlen_prefill", q, k, v, k_pages, v_pages)
    return _varlen_prefill(
        q, k, v, k_pages, v_pages, cu_seqlens, chunk_lens, chunk_pos0,
        page_tables, softcap=softcap, window=window, scale=scale,
        pages_bound=pages_bound, k_scales=k_scales, v_scales=v_scales,
    )


@counted("paged_attention", work.paged_attention_call)
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
    _no_backward("paged_attention", q, k_pages, v_pages)
    return _paged_attention(
        q, k_pages, v_pages, page_table, lengths, softcap=softcap,
        window=window, scale=scale, pages_bound=pages_bound,
        k_scales=k_scales, v_scales=v_scales,
    )


@counted("spec_verify", work.spec_verify_call)
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
    _no_backward("spec_verify", q, k_pages, v_pages)
    return _spec_verify(
        q, k_pages, v_pages, page_table, lengths, window_lens, softcap=softcap,
        window=window, scale=scale, pages_bound=pages_bound,
        k_scales=k_scales, v_scales=v_scales,
    )


@counted("rmsnorm", work.rmsnorm_call)
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis times ``(1 + weight)``; differentiable
    (:class:`~.rmsnorm.RMSNormFn`)."""
    if wants_grad(x, weight):
        return RMSNormFn.apply(x, weight, eps)
    return _rmsnorm(x, weight, eps)


@counted("ssd", work.ssd_call)
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
    n)``; y and, with ``return_state``, the final state in x's dtype;
    differentiable (:class:`~.ssd.SSDFn`)."""
    if wants_grad(x, dt, A, B, C, initial_state):
        return SSDFn.apply(x, dt, A, B, C, initial_state, chunk, return_state)
    return _ssd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state,
                return_state=return_state)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, state: torch.Tensor):
    """One decode step of the SSD recurrence: the plain version on every
    device, as the JAX package shares one implementation (no Pallas
    kernel); promoted to a kernel only if a profile shows it matters."""
    return ref.ssd_step(x, dt, A, B, C, state)


def copy_pages(
    k_pages: torch.Tensor,      # (L, num_pages, page_size, kvh, d)
    v_pages: torch.Tensor,
    src: Union[Sequence[int], torch.Tensor],   # (n,) physical source pages
    dst: Union[Sequence[int], torch.Tensor],   # (n,) physical destination pages
    k_scales: Optional[torch.Tensor] = None,   # (L, num_pages, page_size, kvh)
    v_scales: Optional[torch.Tensor] = None,
) -> None:
    """Copy physical pages ``src`` onto ``dst`` in every layer of the paged
    pools, in place (the copy-on-write step of the prefix cache: a request
    about to append into a page that others still reference first takes a
    private copy).  The scale rows of an int8/fp8 pool move with their
    pages.  The pools are written where they lie, never reallocated: the
    model writes the same tensors in place.  The JAX ``copy_pages`` returns
    updated pools instead."""
    dev = k_pages.device
    src = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    pools = [k_pages, v_pages] + ([k_scales, v_scales] if k_scales is not None else [])
    for pool in pools:
        pool[:, dst] = pool[:, src]


def export_pages(
    k_pages: torch.Tensor,      # (L, num_pages, page_size, kvh, d)
    v_pages: torch.Tensor,
    idx: Union[Sequence[int], torch.Tensor],   # (n,) physical pages to export
    k_scales: Optional[torch.Tensor] = None,   # (L, num_pages, page_size, kvh)
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Gather pages ``idx`` of every layer out of the pools into contiguous
    tensors ``(L, n, page_size, kvh, d)`` on the pools' device (live KV
    migration's export): ``(k, v)``, or ``(k, v, k_scales, v_scales)`` for
    an int8/fp8 pool, whose scale rows travel with their pages, so the
    snapshot is the exact stored bytes.  The pools are only read.  The JAX
    ``export_pages`` is handed an index padded to a power of two (one jit
    variant per bucket) and its caller slices the padding off; here the
    index holds exactly the pages, so the shapes come out the same."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=k_pages.device)
    pools = [k_pages, v_pages] + ([k_scales, v_scales] if k_scales is not None else [])
    return tuple(pool[:, idx] for pool in pools)


def import_pages(
    k_pages: torch.Tensor,      # (L, num_pages, page_size, kvh, d)
    v_pages: torch.Tensor,
    dst: Union[Sequence[int], torch.Tensor],   # (n,) freshly allocated pages
    k_snap: torch.Tensor,       # (L, n, page_size, kvh, d) exported pages
    v_snap: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    k_scale_snap: Optional[torch.Tensor] = None,  # (L, n, page_size, kvh)
    v_scale_snap: Optional[torch.Tensor] = None,
) -> None:
    """Scatter an :func:`export_pages` snapshot (on any device) into pages
    ``dst`` of every layer of the destination pools, in place, as
    :func:`copy_pages` writes (the JAX ``import_pages`` returns updated
    pools instead).  A quantized pool takes the scale rows too."""
    dev = k_pages.device
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    pairs = [(k_pages, k_snap), (v_pages, v_snap)]
    if k_scales is not None:
        pairs += [(k_scales, k_scale_snap), (v_scales, v_scale_snap)]
    for pool, snap in pairs:
        pool[:, dst] = snap.to(dev)
