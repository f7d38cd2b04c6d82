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
and writes their scales at the same indices, and the kernels dequantize.  The Mamba-2 block (:func:`mamba_forward`,
:func:`mamba_step`) runs its sequence scan through ``ops.ssd`` and its
gated norm through ``ops.rmsnorm``; its depthwise causal convolution and
its one-token decode recurrence stay plain torch, as in the JAX package.
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
