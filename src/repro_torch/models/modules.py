"""Block-level model components (the port's ``repro.models.modules``).

``*_defs(cfg)`` describe parameters as :class:`~repro_torch.models.params.P`
trees; the apply functions run a whole sequence (prefill, ``forward``), one
token per row against a dense cache, one token per slot (paged decode), one
prompt chunk against its request's pages (chunked prefill) or a
token-packed buffer of prompt chunks (packed prefill); for the enc-dec
family also without RoPE (:func:`sinusoidal` positions are added to the
activations instead), cross-attention over an encoder output
(``attn_full(kv_from=...)``) or over its cached K/V
(:func:`cross_attn_decode`), and the non-gated GELU MLP.  Attention and
normalisation go through :mod:`repro_torch.kernels.ops`, which sends CUDA
tensors to the hand-written kernels.  The projections, MLP and LM head are
plain matrix products, as the JAX package leaves them to XLA.  Public
functions keep the JAX layouts: activations ``(b, s, D)``, heads
``(b, s, h, d)``, dense caches ``(b, S, kvh, d)``, pools
``(num_pages, page_size, kvh, d)``.  An int8/fp8
pool comes with float32 scale pools ``(num_pages, page_size, kvh)``: every
write quantizes its rows (:func:`~repro_torch.kernels.kvquant.quantize`)
and writes their scales at the same indices, and the kernels dequantize.  The Mamba-2 block (:func:`mamba_forward`,
:func:`mamba_step`) runs its sequence scan through ``ops.ssd`` and its
gated norm through ``ops.rmsnorm``; its depthwise causal convolution and
its one-token decode recurrence stay plain torch, as in the JAX package.
The mixture of experts (:func:`moe_apply`: capacity-based top-k routing,
dispatch by index writes, the three expert products as batched matrix
products over all experts) is plain torch too: the JAX package computes
it with ``jnp`` outside any Pallas kernel.
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


def sinusoidal(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embedding in float32: positions
    ``(...)`` -> ``(..., d_model)``, ``[sin, cos]`` of the positions times
    ``exp(-ln(10000) i / max(half - 1, 1))``, ``i < half = d_model // 2``.
    Callers cast it to the activation dtype."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, device=positions.device, dtype=torch.float32)
                      / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def norm_defs(cfg: ArchConfig) -> P:
    return P((cfg.d_model,), "zeros")


def mlp_defs(cfg: ArchConfig, d_ff: int = 0, gated: bool = True) -> Dict[str, P]:
    """The MLP, ``d_ff`` wide (default ``cfg.d_ff``; an interleaved MoE
    config's dense layers take ``cfg.dense_d_ff``): gated, or with
    ``gated=False`` (the enc-dec family's) ``w_up`` and ``w_down`` only."""
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    std_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    defs = {
        "w_up": P((D, Fd)),
        "w_down": P((Fd, D), std=std_out),
    }
    if gated:
        defs["w_gate"] = P((D, Fd))
    return defs


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP ``(silu(x W_gate) * x W_up) W_down``, or without
    ``w_gate`` ``gelu(x W_up) W_down`` with the tanh approximation of GELU
    (``jax.nn.gelu``'s default, where ``F.gelu``'s is the exact erf)."""
    up = x @ p["w_up"]
    if "w_gate" in p:
        return (F.silu(x @ p["w_gate"]) * up) @ p["w_down"]
    return F.gelu(up, approximate="tanh") @ p["w_down"]


def attn_defs(cfg: ArchConfig, cross: bool = False) -> Dict[str, P]:
    """q/k/v/o projections, plus the QK-norm weights where the config has
    QK-norm, except on a cross-attention block (``cross``)."""
    D, H, KV, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    std_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    defs = {
        "wq": P((D, H, dh)),
        "wk": P((D, KV, dh)),
        "wv": P((D, KV, dh)),
        "wo": P((H, dh, D), std=std_out),
    }
    if cfg.qk_norm and not cross:
        defs["q_norm"] = P((dh,), "zeros")
        defs["k_norm"] = P((dh,), "zeros")
    return defs


def _heads_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, s, D) @ (D, h, d) -> (b, s, h, d) as one matrix product."""
    D, h, d = w.shape
    return (x @ w.reshape(D, h * d)).reshape(*x.shape[:-1], h, d)


def _heads_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) @ (h, d, D) -> (b, s, D) as one matrix product."""
    h, d, D = w.shape
    return o.reshape(*o.shape[:-2], h * d) @ w.reshape(h * d, D)


def _project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                 positions: Optional[torch.Tensor],
                 kv_from: Optional[torch.Tensor] = None):
    """Project q from x and k, v from ``kv_from`` (cross-attention) or x;
    with QK-norm (``q_norm`` in ``p``) normalise q and k over the head dim,
    then, unless ``positions`` is None, apply RoPE to q at ``positions`` and
    to k at its own (the source's ``arange`` under ``kv_from``).  The
    projections are contiguous, so ``ops.rmsnorm`` takes them as they are:
    rows of ``head_dim``, one per (token, head)."""
    src = x if kv_from is None else kv_from
    q, k = _heads_in(x, p["wq"]), _heads_in(src, p["wk"])
    if "q_norm" in p:
        q = ops.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = ops.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        kv_positions = (positions if kv_from is None
                        else torch.arange(src.shape[1], device=src.device))
        k = rope(k, kv_positions, cfg.rope_theta)
    v = _heads_in(src, p["wv"])
    return q, k, v


def attn_full(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                      # (b, s, D)
    cfg: ArchConfig,
    *,
    causal: bool = True,
    window=None,
    use_rope: bool = True,
    kv_from: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill, ``forward``): positions ``q_offset
    + i``, RoPE on q and k unless ``use_rope`` is False, then one
    flash-attention launch.  With ``kv_from`` (b, sk, D) (cross-attention)
    k and v are projected from it and the mask is not causal.  Returns y
    ``(b, s, D)``, and ``(k, v)`` ``(b, sk, kvh, d)`` with ``return_kv``
    (the prefill writes them into its cache)."""
    s = x.shape[1]
    positions = q_offset + torch.arange(s, device=x.device) if use_rope else None
    q, k, v = _project_qkv(p, x, cfg, positions, kv_from)
    out = ops.attention(q, k, v, causal=causal and kv_from is None, window=window,
                        softcap=cfg.attn_softcap, q_offset=q_offset)
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
    use_rope: bool = True,
    ring: bool = False,
    uniform_pos: bool = True,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention against a dense KV cache (RoPE at ``pos``
    unless ``use_rope`` is False).

    The new token's K/V are written at its slot in place (the JAX module
    returns updated caches): with ``uniform_pos`` every row shares
    ``pos[0]`` (one slice write, the start clamped into the cache as
    ``dynamic_update_slice`` clamps it); otherwise each row writes its own
    slot, and a row whose position lies past the cache (an idle slot of the
    continuous engine keeps counting) writes nothing.  Then attention
    covers ``pos + 1`` keys per row, at most ``kv_bound``.  With ``ring``
    (the hybrid family's cache of ``long_context_window`` slots past 64k
    tokens) the slot is ``pos % S``, so every row writes, idle slots too;
    attention covers ``min(pos + 1, S)`` keys, with no window and no
    ``kv_bound``: a wrapped ring's live keys fill the whole buffer, and the
    ring is the window.  Returns y (b, 1, D)."""
    b, S = k_cache.shape[:2]
    q, k, v = _project_qkv(p, x1, cfg, pos[:, None] if use_rope else None)
    slot = pos.long() % S if ring else pos.long().clamp(max=S - 1)
    if uniform_pos:
        at = slot[:1]
        k_cache.index_copy_(1, at, k)
        v_cache.index_copy_(1, at, v)
    elif ring:
        rows = torch.arange(b, device=pos.device)
        k_cache.index_put_((rows, slot), k[:, 0])
        v_cache.index_put_((rows, slot), v[:, 0])
    else:
        rows = torch.arange(b, device=pos.device)
        inside = (pos < S)[:, None, None]
        k_cache.index_put_((rows, slot), torch.where(inside, k[:, 0], k_cache[rows, slot]))
        v_cache.index_put_((rows, slot), torch.where(inside, v[:, 0], v_cache[rows, slot]))
    if ring:
        lengths, window, kv_bound = torch.clamp(pos + 1, max=S), None, None
    else:
        lengths = pos + 1
    out = ops.decode_attention(q, k_cache, v_cache, lengths, softcap=cfg.attn_softcap,
                               window=window, kv_bound=kv_bound)
    return _heads_out(out, p["wo"])


def cross_attn_decode(
    p: Dict[str, torch.Tensor],
    x1: torch.Tensor,                     # (b, 1, D) one new token per row
    k_cross: torch.Tensor,                # (b, S, kv, dh) the encoder's K, from the prefill
    v_cross: torch.Tensor,
    cfg: ArchConfig,
) -> torch.Tensor:
    """One token's cross-attention over the encoder's cached K/V: one
    decode-attention launch with every row's length ``cfg.encoder_seq``
    (no RoPE, no write).  The cache may hold more slots than that (the
    enc-dec model rounds them up to a multiple of 16, so the bf16 kernel
    views them as whole pages): the slots past ``encoder_seq`` are never
    read.  Returns y (b, 1, D)."""
    Se = cfg.encoder_seq
    q = _heads_in(x1, p["wq"])
    lengths = torch.full((x1.shape[0],), Se, dtype=torch.int32, device=x1.device)
    out = ops.decode_attention(q, k_cross, v_cross, lengths, kv_bound=Se)
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


def attn_prefill_paged(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                      # (1, c, D) one prompt chunk
    k_pages: torch.Tensor,                # (num_pages, page_size, kv, dh)
    v_pages: torch.Tensor,
    page_row: torch.Tensor,               # (max_pages,) int32 this request's pages
    pos0: int,                            # absolute position of x[0], page-aligned
    cfg: ArchConfig,
    *,
    window=None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kv) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One chunked-prefill step: the chunk attends the request's paged
    context plus its own causal prefix in one flash-attention launch at
    ``q_offset = pos0``, then its K/V are written into the request's pages
    in place.  ``pos0`` must be a multiple of the page size, so the context
    is exactly the first ``pos0 // page_size`` pages of ``page_row``; an
    int8/fp8 context is dequantized through its scale rows before the
    launch.  The chunk may be right-padded to a page multiple: causal
    attention hides pad rows from real ones, and pad K/V lands in the
    request's own pages past its length, where decode overwrites it.
    Returns y (1, c, D)."""
    c = x.shape[1]
    page_size = k_pages.shape[1]
    if pos0 % page_size:
        raise ValueError(f"chunk start {pos0} not page-aligned ({page_size})")
    tok_pos = pos0 + torch.arange(c, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, tok_pos)
    n_ctx = pos0 // page_size
    if n_ctx:
        ctx = page_row[:n_ctx].long()
        kctx = k_pages[ctx].reshape(1, pos0, *k_pages.shape[2:])
        vctx = v_pages[ctx].reshape(1, pos0, *v_pages.shape[2:])
        if k_scales is not None:
            kctx = kvquant.dequantize(kctx, k_scales[ctx].reshape(1, pos0, -1))
            vctx = kvquant.dequantize(vctx, v_scales[ctx].reshape(1, pos0, -1))
        k_all = torch.cat([kctx.to(k.dtype), k], dim=1)
        v_all = torch.cat([vctx.to(v.dtype), v], dim=1)
    else:
        k_all, v_all = k, v
    out = ops.attention(q, k_all, v_all, causal=True, window=window,
                        softcap=cfg.attn_softcap, q_offset=pos0)
    y = _heads_out(out, p["wo"])
    tok_l = tok_pos.long()
    dst = (page_row.long()[tok_l // page_size], tok_l % page_size)
    _write_kv(k_pages, v_pages, k_scales, v_scales, dst, k[0], v[0])
    return y


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


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
def moe_defs(cfg: ArchConfig) -> Dict[str, P]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    std_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    return {
        "router": P((D, E)),
        "w_gate": P((E, D, Fd)),
        "w_up": P((E, D, Fd)),
        "w_down": P((E, Fd, D), std=std_out),
    }


def moe_capacity(cfg: ArchConfig, s: int) -> int:
    """Slots per expert in a group (a batch row) of ``s`` tokens:
    ``cf * s * k / E``, at least 1 and at most ``s * k``.  ``s`` is the
    row's padded length, so the engines' bucketing moves it: a packed
    prefill buffer of ``t_pack`` tokens is one group, a decode step a
    group of 1 per slot (``C`` 1 at qwen3-moe's ``cf`` 1.25, top 8 of
    128)."""
    C = max(int(cfg.capacity_factor * s * cfg.experts_per_token / cfg.num_experts), 1)
    return min(C, s * cfg.experts_per_token)


def _positions_in_expert(eid: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each slot's rank within its expert's queue, row by row: eid (b, n)
    -> (b, n).  The rank follows slot order (a stable sort), so a row's
    trailing pad tokens queue behind its real ones."""
    b, n = eid.shape
    sorted_eid, order = torch.sort(eid, dim=-1, stable=True)
    ranks = torch.empty_like(eid).scatter_(
        -1, order, torch.arange(n, device=eid.device).expand(b, n))
    experts = torch.arange(num_experts, device=eid.device, dtype=eid.dtype).expand(b, -1)
    seg_starts = torch.searchsorted(sorted_eid, experts.contiguous())
    return ranks - seg_starts.gather(-1, eid)


def moe_route(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig):
    """The router's decision for x (b, s, D): probabilities (b, s, E)
    (logits in the model dtype, softmax in float32), and each token's top
    k experts (b, s, k) with their weights renormalised (sum clamped at
    1e-9).  Ties go to the lower expert index (a stable descending sort),
    as ``jax.lax.top_k`` breaks them; ``torch.topk`` promises no order."""
    probs = torch.softmax((x @ p["router"]).float(), dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    weights, idx = weights[..., :K], idx[..., :K]
    return probs, weights / weights.sum(-1, keepdim=True).clamp_min(1e-9), idx


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
              need_aux: bool = True):
    """Capacity-based top-k routing with index dispatch (the JAX module's
    default path; its ``moe_decode_gather`` decode path runs only under
    tensor-parallel sharding rules and is not ported).

    Each batch row is a group of ``s`` tokens with :func:`moe_capacity`
    slots per expert, routed by :func:`moe_route`.  A slot's rank within its expert
    follows slot order (:func:`_positions_in_expert`); slots ranked at or
    past the capacity are dropped on dispatch and contribute zero on
    combine.  The expert buffer is laid out expert-major, ``(E, b * C,
    D)``, so the three expert products are one ``bmm`` each over every
    expert.  The dispatch is a gather: each buffer row names the token its
    slot holds, or a zero row (an empty slot); the combine gathers each
    kept slot's output (a dropped one reads a zero row past the buffer)
    and weighs the k of a token by one matrix product with their weights
    cast to the activation dtype, accumulated in float32, as the
    reference's einsum accumulates.  Returns (out (b, s, D), aux): aux is
    the Switch load-balancing loss ``E * sum_e f_e * P_e`` in float32, or
    None without ``need_aux`` (the serving paths discard it)."""
    b, s, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, s)
    probs, weights, idx = moe_route(p, x, cfg)
    aux = None
    if need_aux:
        counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
            0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32, device=x.device))
        aux = E * (probs.mean(dim=(0, 1)) * (counts / (b * s * K))).sum()

    eid = idx.reshape(b, s * K)                                          # (b, n) slots
    pos = _positions_in_expert(eid, E)
    rows = torch.arange(b, device=x.device)[:, None]
    n_rows = E * b * C                                  # buffer rows; row n_rows is zero
    # each kept slot's expert-major buffer row; a dropped slot the zero row
    dst = torch.where(pos < C, (eid * b + rows) * C + pos, n_rows).reshape(-1)
    tokens = torch.arange(b * s, device=x.device).repeat_interleave(K)
    src = torch.full((n_rows + 1,), b * s, dtype=torch.long, device=x.device)
    src.index_copy_(0, dst, tokens)                     # dropped slots all land on row n_rows
    x_rows = torch.cat([x.reshape(b * s, D), x.new_zeros((1, D))])
    h = x_rows[src[:n_rows]].view(E, b * C, D)
    act = F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"])
    if ops.wants_grad(h, p["w_gate"], p["w_up"], p["w_down"]):
        # autograd takes no out= product: the same product, then the zero row
        out = torch.cat([torch.bmm(act, p["w_down"]).view(n_rows, D), x.new_zeros((1, D))])
    else:
        out = x.new_empty((n_rows + 1, D))
        out[n_rows].zero_()
        torch.bmm(act, p["w_down"], out=out[:n_rows].view(E, b * C, D))
    gathered = out[dst].view(b * s, K, D)
    combined = torch.matmul(weights.to(x.dtype).view(b * s, 1, K), gathered)
    return combined.view(b, s, D), aux


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------
def mamba_defs(cfg: ArchConfig) -> Dict[str, P]:
    D = cfg.d_model
    din, n, h, K = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    conv_dim = din + 2 * n
    std_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    f32 = torch.float32
    return {
        "in_proj": P((D, 2 * din + 2 * n + h)),
        "conv_w": P((K, conv_dim), std=0.2),
        "conv_b": P((conv_dim,), "zeros"),
        "A_log": P((h,), "ssm_a", dtype=f32),
        "D": P((h,), "ones", dtype=f32),
        "dt_bias": P((h,), "dt_bias", dtype=f32),
        "norm": P((din,), "zeros"),
        "out_proj": P((din, D), std=std_out),
    }


def _mamba_split(cfg: ArchConfig, zxbcdt: torch.Tensor):
    """``in_proj``'s output as (z, xBC, dt_raw): views, no copies."""
    din, n = cfg.ssm_inner, cfg.ssm_state
    conv_dim = din + 2 * n
    return zxbcdt[..., :din], zxbcdt[..., din:din + conv_dim], zxbcdt[..., din + conv_dim:]


def causal_conv1d(
    x: torch.Tensor,                       # (b, s, C)
    w: torch.Tensor,                       # (K, C) depthwise taps
    bias: torch.Tensor,                    # (C,)
    init: Optional[torch.Tensor] = None,   # (b, K-1, C) carried state
) -> torch.Tensor:
    """Depthwise causal convolution then SiLU, the taps summed in order as
    the JAX version sums them."""
    K = w.shape[0]
    b, s, C = x.shape
    if init is None:
        init = torch.zeros((b, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([init.to(x.dtype), x], dim=1)                   # (b, s+K-1, C)
    y = sum(xp[:, i:i + s] * w[i] for i in range(K))
    return F.silu(y + bias)


def _ssd_inputs(p: Dict[str, torch.Tensor], xBC: torch.Tensor, dt_raw: torch.Tensor,
                cfg: ArchConfig):
    """(x_in, B, C, dt, A) of the scan: x_in, B and C are views of the
    convolved projection; dt and A are float32."""
    din, n = cfg.ssm_inner, cfg.ssm_state
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xBC[..., :din], xBC[..., din:din + n], xBC[..., din + n:], dt, A


def _mamba_out(p: Dict[str, torch.Tensor], y: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Skip term, gated norm and output projection.  D is cast to y's dtype
    as in JAX (a bf16 y plus a float32 term would promote to float32)."""
    y = y + p["D"][:, None].to(y.dtype) * xh
    y = y.reshape(*z.shape)
    return ops.rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps) @ p["out_proj"]


def mamba_forward(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (b, s, D)
    cfg: ArchConfig,
    *,
    ssm_state: Optional[torch.Tensor] = None,
    conv_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """The Mamba-2 block over a whole sequence: in_proj, causal conv, one
    ``ops.ssd`` scan (from ``ssm_state``, with ``conv_state`` as the
    convolution's history), gated norm, out_proj.  With ``return_state``
    also returns the final SSD state (x's dtype) and the new conv state: the
    last ``K-1`` rows of ``[conv_state, xBC]`` before the convolution."""
    b, s, _ = x.shape
    h, ph = cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xBC_raw, dt_raw = _mamba_split(cfg, zxbcdt)
    xBC = causal_conv1d(xBC_raw, p["conv_w"], p["conv_b"], init=conv_state)
    x_in, B, C, dt, A = _ssd_inputs(p, xBC, dt_raw, cfg)
    xh = x_in.reshape(b, s, h, ph)
    result = ops.ssd(xh, dt, A, B, C, chunk=cfg.ssm_chunk, initial_state=ssm_state,
                     return_state=return_state)
    y, final_state = result if return_state else (result, None)
    out = _mamba_out(p, y, xh, z, cfg)
    if not return_state:
        return out
    km1 = cfg.conv_kernel - 1
    prev = (conv_state.to(xBC_raw.dtype) if conv_state is not None
            else torch.zeros((b, km1, xBC_raw.shape[-1]), dtype=xBC_raw.dtype, device=x.device))
    hist = torch.cat([prev, xBC_raw], dim=1)
    return out, final_state, hist[:, hist.shape[1] - km1:]


def mamba_step(
    p: Dict[str, torch.Tensor],
    x1: torch.Tensor,                      # (b, D) one token
    ssm_state: torch.Tensor,               # (b, h, ph, n)
    conv_state: torch.Tensor,              # (b, K-1, conv_dim)
    cfg: ArchConfig,
):
    """One decode token through the Mamba-2 block: the convolution over
    ``[conv_state, xBC]`` and one ``ops.ssd_step``.  Returns (y (b, D), the
    new SSD state, the new conv state in ``conv_state``'s dtype)."""
    h, ph = cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x1 @ p["in_proj"]
    z, xBC_raw, dt_raw = _mamba_split(cfg, zxbcdt)
    window = torch.cat([conv_state.to(xBC_raw.dtype), xBC_raw[:, None]], dim=1)
    y_conv = sum(window[:, i] * p["conv_w"][i] for i in range(cfg.conv_kernel))
    xBC = F.silu(y_conv + p["conv_b"])
    x_in, B, C, dt, A = _ssd_inputs(p, xBC, dt_raw, cfg)
    xh = x_in.reshape(-1, h, ph)
    y, new_ssm = ops.ssd_step(xh, dt, A, B, C, ssm_state)
    return _mamba_out(p, y, xh, z, cfg), new_ssm, window[:, 1:].to(conv_state.dtype)
