"""Block-level model components (the port's ``repro.models.modules``).

``*_defs(cfg)`` describe parameters as :class:`~repro_torch.models.params.P`
trees; the apply functions run a whole sequence (prefill, ``forward``), one
token per row against a dense cache, one token per slot (paged decode) or a
token-packed buffer of prompt chunks (packed prefill).  Attention and
normalisation go through :mod:`repro_torch.kernels.ops`, which sends CUDA
tensors to the hand-written kernels.  The projections, MLP and LM head are
plain matrix products, as the JAX package leaves them to XLA.  Public
functions keep the JAX layouts: activations ``(b, s, D)``, heads
``(b, s, h, d)``, dense caches ``(b, S, kvh, d)``, pools
``(num_pages, page_size, kvh, d)``.  An int8/fp8
pool comes with float32 scale pools ``(num_pages, page_size, kvh)``: every
write quantizes its rows (:func:`~repro_torch.kernels.kvquant.quantize`)
and writes their scales at the same indices, and the kernels dequantize.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import kvquant, ops
from .config import ArchConfig
from .params import P


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in float32.  x: (b, s, h, d); positions: (s,) or (b, s)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (
        -torch.arange(half, device=x.device, dtype=torch.float32) / half
    )
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                      # (b, s, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def norm_defs(cfg: ArchConfig) -> P:
    return P((cfg.d_model,), "zeros")


def mlp_defs(cfg: ArchConfig) -> Dict[str, P]:
    D, Fd = cfg.d_model, cfg.d_ff
    std_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    return {
        "w_up": P((D, Fd)),
        "w_down": P((Fd, D), std=std_out),
        "w_gate": P((D, Fd)),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP: ``(silu(x W_gate) * x W_up) W_down``."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def attn_defs(cfg: ArchConfig) -> Dict[str, P]:
    D, H, KV, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    std_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    return {
        "wq": P((D, H, dh)),
        "wk": P((D, KV, dh)),
        "wv": P((D, KV, dh)),
        "wo": P((H, dh, D), std=std_out),
    }


def _heads_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, s, D) @ (D, h, d) -> (b, s, h, d) as one matrix product."""
    D, h, d = w.shape
    return (x @ w.reshape(D, h * d)).reshape(*x.shape[:-1], h, d)


def _heads_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) @ (h, d, D) -> (b, s, D) as one matrix product."""
    h, d, D = w.shape
    return o.reshape(*o.shape[:-2], h * d) @ w.reshape(h * d, D)


def _project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor):
    """Project q, k, v from x and apply RoPE to q and k."""
    q = rope(_heads_in(x, p["wq"]), positions, cfg.rope_theta)
    k = rope(_heads_in(x, p["wk"]), positions, cfg.rope_theta)
    v = _heads_in(x, p["wv"])
    return q, k, v


def attn_full(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                      # (b, s, D)
    cfg: ArchConfig,
    *,
    causal: bool = True,
    window=None,
    q_offset: int = 0,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill, ``forward``): positions ``q_offset
    + i``, RoPE on q and k, then one flash-attention launch.  Returns y
    ``(b, s, D)``, and ``(k, v)`` ``(b, s, kvh, d)`` with ``return_kv`` (the
    prefill writes them into the dense cache)."""
    s = x.shape[1]
    positions = q_offset + torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
                        q_offset=q_offset)
    y = _heads_out(out, p["wo"])
    return (y, (k, v)) if return_kv else y


def attn_decode(
    p: Dict[str, torch.Tensor],
    x1: torch.Tensor,                     # (b, 1, D) one new token per row
    k_cache: torch.Tensor,                # (b, S, kv, dh) dense cache
    v_cache: torch.Tensor,
    pos: torch.Tensor,                    # (b,) int32 position of the new token
    cfg: ArchConfig,
    *,
    window=None,
    ring: bool = False,
    uniform_pos: bool = True,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention against a dense KV cache.

    The new token's K/V are written at ``pos`` in place (the JAX module
    returns updated caches): with ``uniform_pos`` every row shares ``pos[0]``
    (one slice write, the start clamped into the cache as
    ``dynamic_update_slice`` clamps it); otherwise each row writes its own
    position, and a row whose position lies past the cache (an idle slot
    of the continuous engine keeps counting) writes nothing.  Then
    attention covers ``pos + 1`` keys per row, at most ``kv_bound``.
    ``ring`` (the hybrid family's windowed ring cache) is not ported yet.
    Returns y (b, 1, D)."""
    if ring:
        raise NotImplementedError("ring-buffer caches come with the hybrid family")
    b, S = k_cache.shape[:2]
    q, k, v = _project_qkv(p, x1, cfg, pos[:, None])
    if uniform_pos:
        at = pos[:1].long().clamp(max=S - 1)
        k_cache.index_copy_(1, at, k)
        v_cache.index_copy_(1, at, v)
    else:
        rows = torch.arange(b, device=pos.device)
        at = pos.long().clamp(max=S - 1)
        inside = (pos < S)[:, None, None]
        k_cache.index_put_((rows, at), torch.where(inside, k[:, 0], k_cache[rows, at]))
        v_cache.index_put_((rows, at), torch.where(inside, v[:, 0], v_cache[rows, at]))
    out = ops.decode_attention(q, k_cache, v_cache, pos + 1, softcap=cfg.attn_softcap,
                               window=window, kv_bound=kv_bound)
    return _heads_out(out, p["wo"])


SCRATCH_PAGE = 0   # never allocated: writes no request may read land here


def _write_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
              k_scales: Optional[torch.Tensor], v_scales: Optional[torch.Tensor],
              idx, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write K/V rows ``k``/``v`` (..., kvh, d) into the pools at ``idx``
    (page ids, offsets) in place; into an int8/fp8 pool as codes, with
    their scales at the same indices."""
    if k_scales is None:
        k_pages.index_put_(idx, k)
        v_pages.index_put_(idx, v)
        return
    kq, ks = kvquant.quantize(k, k_pages.dtype)
    vq, vs = kvquant.quantize(v, v_pages.dtype)
    k_pages.index_put_(idx, kq)
    v_pages.index_put_(idx, vq)
    k_scales.index_put_(idx, ks)
    v_scales.index_put_(idx, vs)


def attn_decode_paged(
    p: Dict[str, torch.Tensor],
    x1: torch.Tensor,                     # (b, 1, D) one new token per slot
    k_pages: torch.Tensor,                # (num_pages, page_size, kv, dh)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,             # (b, max_pages) int32
    pos: torch.Tensor,                    # (b,) int32 position of the new token
    cfg: ArchConfig,
    *,
    window=None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kv) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention against a paged KV pool.

    The new token's K/V land in the page holding logical position ``pos``
    (a per-row write through the page table), then attention runs over the
    request's live pages.  The pool is written in place (``index_put_``),
    where the JAX package returns an updated pool from a functional
    ``.at[].set``.  Returns y (b, 1, D)."""
    b = x1.shape[0]
    page_size = k_pages.shape[1]
    q, k, v = _project_qkv(p, x1, cfg, pos[:, None])
    pos_l = pos.long()
    rows = torch.arange(b, device=pos.device)
    page_ids = page_table[rows, pos_l // page_size].long()
    offsets = pos_l % page_size
    _write_kv(k_pages, v_pages, k_scales, v_scales, (page_ids, offsets), k[:, 0], v[:, 0])
    out = ops.paged_attention(
        q, k_pages, v_pages, page_table, pos + 1,
        softcap=cfg.attn_softcap, window=window, pages_bound=pages_bound,
        k_scales=k_scales, v_scales=v_scales,
    )
    return _heads_out(out, p["wo"])


def attn_decode_spec(
    p: Dict[str, torch.Tensor],
    xw: torch.Tensor,                     # (b, W, D) one in-flight window per slot
    k_pages: torch.Tensor,                # (num_pages, page_size, kv, dh)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,             # (b, max_pages) int32
    lengths: torch.Tensor,                # (b,) int32 committed tokens before the window
    window_lens: torch.Tensor,            # (b,) int32 real window tokens (0..W)
    cfg: ArchConfig,
    *,
    window=None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kv) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Speculative-verification attention: each slot's ``[next_token,
    draft_1..]`` window is scored against the paged pool in one launch.

    The window's K/V are written first, at positions ``lengths[b] + w``
    through the page table, then every query attends its absolute-position
    causal prefix, so the window's own tokens are seen as by a run of
    one-token decode steps.  Pad rows (``w >= window_lens[b]``: window pad
    and idle slots) write into the scratch page, never into a live one.
    (The JAX module scatters them through the table with the page index
    clamped to the last column, which overwrites a committed row of a
    request whose pad positions run past the table.)  A rejected suffix
    rolls back by rewinding ``lengths``.  Returns y (b, W, D)."""
    b, W, _ = xw.shape
    page_size = k_pages.shape[1]
    max_pages = page_table.shape[1]
    w_idx = torch.arange(W, device=xw.device, dtype=torch.int32)
    tok_pos = lengths[:, None].to(torch.int32) + w_idx[None, :]     # (b, W)
    q, k, v = _project_qkv(p, xw, cfg, tok_pos)
    tok_l = tok_pos.long()
    pidx = (tok_l // page_size).clamp_max(max_pages - 1)
    real = w_idx[None, :] < window_lens[:, None]
    page_ids = torch.where(real, page_table.long().gather(1, pidx),
                           torch.full_like(pidx, SCRATCH_PAGE))
    _write_kv(k_pages, v_pages, k_scales, v_scales, (page_ids, tok_l % page_size), k, v)
    out = ops.spec_verify(
        q, k_pages, v_pages, page_table, lengths, window_lens,
        softcap=cfg.attn_softcap, window=window, pages_bound=pages_bound,
        k_scales=k_scales, v_scales=v_scales,
    )
    return _heads_out(out, p["wo"])


def attn_prefill_packed(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                      # (1, T, D) token-packed chunks
    k_pages: torch.Tensor,                # (num_pages, page_size, kv, dh)
    v_pages: torch.Tensor,
    meta: Dict[str, torch.Tensor],        # packing metadata (see below)
    cfg: ArchConfig,
    *,
    window=None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kv) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One packed varlen-prefill step: chunks of many requests share the
    packed buffer; each attends its request's committed pages plus the
    causal prefix of its own tokens.  Attention runs first, reading the
    chunks' own K/V from the packed buffer; only then are the packed K/V
    written into the pool (in place, where JAX returns a new pool).
    ``meta`` carries the layout:

    * ``tok_pos``     (T,)   absolute position per packed token
    * ``dst_page``/``dst_off`` (T,) physical K/V destination per token
      (buffer-tail pads point at the scratch page)
    * ``cu_seqlens``  (C+1,) packed chunk boundaries (page-aligned spans)
    * ``chunk_lens``  (C,)   real tokens per chunk
    * ``chunk_pos0``  (C,)   absolute chunk starts (page-aligned)
    * ``page_tables`` (C, max_pages) the owning requests' pages

    Returns y (1, T, D)."""
    q, k, v = _project_qkv(p, x, cfg, meta["tok_pos"][None, :])
    out = ops.varlen_prefill(
        q[0], k[0], v[0], k_pages, v_pages,
        meta["cu_seqlens"], meta["chunk_lens"], meta["chunk_pos0"],
        meta["page_tables"],
        softcap=cfg.attn_softcap, window=window, pages_bound=pages_bound,
        k_scales=k_scales, v_scales=v_scales,
    )
    y = _heads_out(out[None], p["wo"])
    dst = (meta["dst_page"].long(), meta["dst_off"].long())
    _write_kv(k_pages, v_pages, k_scales, v_scales, dst, k[0], v[0])
    return y
