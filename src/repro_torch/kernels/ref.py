"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written CUDA kernel computes, with the
signature and semantics of its TPU counterpart in ``repro.kernels``: masked
scores at ``NEG_INF`` (never ``-inf``), ``l`` clamped at ``1e-37``, fully
masked rows exactly zero, logical positions (page ``j`` covers
``[j*ps, (j+1)*ps)``) and query head ``h`` reading kv head ``h // (h/kvh)``.
On the CPU the kernel wrappers run these; on the card ``chip_smoke.py``
holds each kernel against them.  They are naive and memory-hungry, and no
yardstick of speed.  An int8/fp8 pool comes with float32 ``k_scales``/
``v_scales`` ``(num_pages, page_size, kvh)``; the gathered pool rows are
dequantized (``code * scale``) and everything is computed in float32.
The Mamba-2 scan :func:`ssd` is the sequential recurrence, one
:func:`ssd_step` per timestep, in float32; :func:`ssd_chunk_phases` is the
same scan in the three phases of the tensor-core kernel, for tests.  Its
backward :func:`ssd_bwd` is the sequential reverse recurrence, and
:func:`ssd_bwd_chunks` the same gradients in the chunks of the backward
kernel, for tests.
:func:`attention_lse`, :func:`flash_attention_bwd` and :func:`rmsnorm_bwd`
are the plain versions of the training path's kernels;
:func:`flash_attention_bwd_splits`, :func:`rmsnorm_bwd_partials` and
:func:`rmsnorm_bwd_dw_sum` the same in the order of work of their kernels,
for tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# the log-sum-exp of a row with no live key: exp(s - LSE_EMPTY) is an exact 0
# for any finite score, so the backward's P of such a row is 0
LSE_EMPTY = -NEG_INF


def _soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def _windowed(window) -> bool:
    # the kernels take the window as an int where 0 means "no window"
    return window is not None and int(window) > 0


def _gather(pages: torch.Tensor, scales: Optional[torch.Tensor],
            rows: torch.Tensor) -> torch.Tensor:
    """Pool pages ``rows`` (any shape of page ids) as ``(*rows.shape *
    page_size, kvh, d)`` rows: as stored for a full-precision pool,
    dequantized to float32 for an int8/fp8 pool."""
    out = pages[rows]
    if scales is not None:
        out = out.float() * scales[rows].float()[..., None]
    return out.reshape(*rows.shape[:-1], -1, *pages.shape[2:])


def _attend(q, k, v, valid, scale: float, softcap: float, with_lse: bool = False):
    """Grouped-query attention with an explicit mask and a safe softmax.

    q ``(B, n, h, d)``, k/v ``(B, m, kvh, d)``, valid ``(B, n, m)`` bool.
    Returns float32 ``(B, n, h, d)``; a row with no valid key is exactly 0.
    With ``with_lse`` also each row's log-sum-exp ``(B, h, n)`` float32
    (:data:`LSE_EMPTY` on a row with no valid key).
    """
    B, n, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(B, n, kvh, h // kvh, d)
    s = torch.einsum("bngrd,bmgd->bgrnm", qg, k.float()) * scale
    s = _soft_cap(s, softcap)
    mask = valid[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    p = p / l.clamp_min(1e-37)
    out = torch.einsum("bgrnm,bmgd->bngrd", p, v.float()).reshape(B, n, h, d)
    if not with_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, LSE_EMPTY))
    return out, lse.reshape(B, h, n)


def attention(
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
    """Full-sequence attention (training, prefill): query row ``i`` sits at
    position ``q_offset + i`` and attends key ``j`` when (causal) ``q_pos >=
    j`` and (window) ``q_pos - j < window``.  A row with no live key is
    exactly zero (the TPU kernel leaves a value there that depends on its
    block size; the reference ``repro.kernels.ref.attention`` the mean of
    V)."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    valid = _live(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    out = _attend(q, k, v, valid[None].expand(q.shape[0], -1, -1), scale, softcap)
    return out.to(q.dtype)


def _live(sq: int, sk: int, causal: bool, window, q_offset: int,
          device: torch.device) -> torch.Tensor:
    """(sq, sk) bool: query row ``i`` (position ``q_offset + i``) sees key
    ``j`` ((causal) ``q_pos >= j``, (window) ``q_pos - j < window``)."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid &= q_pos >= k_pos
    if _windowed(window):
        valid &= (q_pos - k_pos) < int(window)
    return valid


def attention_lse(
    q: torch.Tensor,            # (b, sq, h, d)
    k: torch.Tensor,            # (b, sk, kvh, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention` and each row's log-sum-exp of its (scaled, capped)
    live scores, float32 ``(b, h, sq)`` in natural-log units:
    ``log(sum_j exp(s_j))``, or :data:`LSE_EMPTY` on a row with no live
    key.  What the forward kernel saves for the backward."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    valid = _live(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    out, lse = _attend(q, k, v, valid[None].expand(q.shape[0], -1, -1), scale, softcap,
                       with_lse=True)
    return out.to(q.dtype), lse


def _flash_bwd_f32(q, k, v, o, lse, do, causal, window, softcap, q_offset, scale):
    """(dq, dk, dv) of :func:`flash_attention_bwd` in float32, before the
    final rounding."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    dt = q.dtype
    scale = d ** -0.5 if scale is None else scale
    mask = _live(sq, sk, causal, window, q_offset, q.device)[None, None, None]
    qg = q.float().reshape(b, sq, kvh, rep, d)
    dog = do.float().reshape(b, sq, kvh, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    sc = _soft_cap(s, softcap)
    p = torch.where(mask, torch.exp(sc - lse.reshape(b, kvh, rep, sq)[..., None]),
                    torch.zeros_like(sc))
    D = (do.float() * o.float()).sum(-1).reshape(b, sq, kvh, rep).permute(0, 2, 3, 1)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p.to(dt).float(), dog)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = p * (dp - D[..., None])
    if softcap > 0:
        ds = ds * (1.0 - torch.square(sc / softcap))
    ds = torch.where(mask, ds, torch.zeros_like(ds)) * scale
    dsl = ds.to(dt).float()
    dq = torch.einsum("bgrqk,bkgd->bqgrd", dsl, k.float()).reshape(b, sq, h, d)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", dsl, qg)
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,            # (b, sq, h, d)
    k: torch.Tensor,            # (b, sk, kvh, d)
    v: torch.Tensor,
    o: torch.Tensor,            # (b, sq, h, d) the forward's output
    lse: torch.Tensor,          # (b, h, sq) float32, from attention_lse
    do: torch.Tensor,           # (b, sq, h, d) the output's cotangent
    *,
    causal: bool = True,
    window=None,
    softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention`, in the inputs' dtype: the JAX
    package's ``_flash_bwd_core`` (``repro/kernels/ops.py``) step by step,
    with P recomputed from the saved log-sum-exp, ``D = rowsum(dO * O)``,
    ``dS = P (dP - D)`` times the softcap's ``1 - (sc/cap)^2``, masked,
    times the scale, P and dS rounded to the input dtype before their
    products (float32 accumulation), and dk, dv summed over the ``rep``
    query heads of each kv head.  A row with no live key gets dq 0 and
    gives dk, dv nothing."""
    grads = _flash_bwd_f32(q, k, v, o, lse, do, causal, window, softcap, q_offset, scale)
    return tuple(g.to(q.dtype) for g in grads)


def flash_attention_bwd_splits(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, *, splits: int, causal: bool = True, window=None, softcap: float = 0.0,
    q_offset: int = 0, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd` in the tensor-core kernel's order of
    work (``csrc/flash_attention_bwd.cu``): each kv head's GQA group cut
    into ``splits`` shares of ``rep / splits`` consecutive query heads,
    each share's float32 dK and dV (P and dS rounded to the input dtype
    before their products) summed over the shares in share order, then
    rounded once; dq of each query head from its own share."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    if splits <= 0 or rep % splits:
        raise ValueError(f"flash_attention_bwd_splits: {splits} splits of a group of {rep}")
    hs = rep // splits
    dq = torch.empty((b, sq, kvh, rep, d), dtype=torch.float32, device=q.device)
    dk = dv = None
    for i in range(splits):
        share = slice(i * hs, (i + 1) * hs)
        cut = lambda t: t.reshape(b, sq, kvh, rep, d)[:, :, :, share].reshape(b, sq, kvh * hs, d)
        lse_i = lse.reshape(b, kvh, rep, sq)[:, :, share].reshape(b, kvh * hs, sq)
        dq_i, dk_i, dv_i = _flash_bwd_f32(cut(q), k, v, cut(o), lse_i, cut(do), causal, window,
                                          softcap, q_offset, scale)
        dq[:, :, :, share] = dq_i.reshape(b, sq, kvh, hs, d)
        dk = dk_i if dk is None else dk + dk_i
        dv = dv_i if dv is None else dv + dv_i
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # (b, 1, h, d) one new token per row
    k_cache: torch.Tensor,      # (b, S, kvh, d) dense cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,      # (b,) int32 live tokens (incl. the new one)
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over a dense cache: row ``b`` attends positions
    ``[0, len)`` (or ``[len - window, len)``), only the first ``kv_bound``
    of them.  V rows at positions no row may read are zeroed before use, so
    a row of length 0 is exactly zero (the reference
    ``repro.kernels.ref.decode_attention`` gives the mean of V there)."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    S = k_cache.shape[1] if kv_bound is None else min(k_cache.shape[1], int(kv_bound))
    k, v = k_cache[:, :S], v_cache[:, :S]
    k_pos = torch.arange(S, device=q.device)[None, :]
    L = lengths.to(q.device).long()[:, None]
    valid = k_pos < L
    if _windowed(window):
        valid &= k_pos >= L - int(window)
    v = torch.where(valid[:, :, None, None], v, torch.zeros((), dtype=v.dtype, device=v.device))
    out = _attend(q, k, v, valid[:, None, :], scale, softcap)
    return out.to(q.dtype)


def paged_attention(
    q: torch.Tensor,            # (b, 1, h, d) one new token per request
    k_pages: torch.Tensor,      # (num_pages, page_size, kvh, d) global pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (b, max_pages) int32 page ids per request
    lengths: torch.Tensor,      # (b,) int32 live tokens (incl. the new one)
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kvh) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over a paged pool: gather each request's pages back
    into a contiguous cache and attend the live positions ``[0, len)`` (or
    ``[len - window, len)``).  Only the table's ``max_pages`` columns are
    visited, so a caller bounds the pages by slicing the table."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    tbl = page_table.long()
    k = _gather(k_pages, k_scales, tbl)                      # (b, S, kvh, d)
    v = _gather(v_pages, v_scales, tbl)
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    L = lengths.to(q.device).long()[:, None]
    valid = k_pos < L
    if _windowed(window):
        valid &= k_pos >= L - int(window)
    out = _attend(q, k, v, valid[:, None, :], scale, softcap)
    return out.to(q.dtype)


def varlen_prefill(
    q: torch.Tensor,            # (T, h, d) token-packed queries
    k: torch.Tensor,            # (T, kvh, d) packed K of the chunks' tokens
    v: torch.Tensor,            # (T, kvh, d)
    k_pages: torch.Tensor,      # (num_pages, page_size, kvh, d) global pool
    v_pages: torch.Tensor,
    cu_seqlens: torch.Tensor,   # (C+1,) chunk c owns rows [cu[c], cu[c+1])
    chunk_lens: torch.Tensor,   # (C,) real tokens per chunk
    chunk_pos0: torch.Tensor,   # (C,) absolute start of each chunk (page-aligned)
    page_tables: torch.Tensor,  # (C, max_pages) the owning request's pages
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kvh) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed ragged prefill: per chunk, attend the request's committed
    context pages ``[0, pos0)`` plus the causal prefix of the chunk itself.
    Rows outside any chunk's real tokens (chunk pad and buffer tail) come
    back exactly zero.  ``pages_bound`` caps the context pages read per
    chunk, as in the TPU kernel.  With a quantized pool only the context
    pages are dequantized; the chunk's own K/V are full precision.  A host
    loop over chunks."""
    T, h, d = q.shape
    page_size = k_pages.shape[1]
    C, max_pages = page_tables.shape
    scale = d ** -0.5 if scale is None else scale
    ctx_bound = max_pages if pages_bound is None else min(pages_bound, max_pages)
    cu = cu_seqlens.tolist()
    lens = chunk_lens.tolist()
    pos0s = chunk_pos0.tolist()
    tables = page_tables.long()
    out = torch.zeros_like(q)
    for c in range(C):
        n = int(lens[c])
        if n == 0:
            continue
        s0, pos0 = int(cu[c]), int(pos0s[c])
        n_ctx = min(-(-pos0 // page_size), ctx_bound)
        ctx = min(pos0, n_ctx * page_size)
        kc, vc = k[s0 : s0 + n], v[s0 : s0 + n]
        if ctx:
            rows = tables[c, :n_ctx]
            kctx = _gather(k_pages, k_scales, rows)[:ctx]
            vctx = _gather(v_pages, v_scales, rows)[:ctx]
            kc = torch.cat([kctx.float(), kc.float()])
            vc = torch.cat([vctx.float(), vc.float()])
        q_pos = pos0 + torch.arange(n, device=q.device)
        k_pos = torch.cat([torch.arange(ctx, device=q.device), q_pos])
        valid = q_pos[:, None] >= k_pos[None, :]
        if _windowed(window):
            valid &= (q_pos[:, None] - k_pos[None, :]) < int(window)
        o = _attend(q[None, s0 : s0 + n], kc[None], vc[None], valid[None],
                    scale, softcap)
        out[s0 : s0 + n] = o[0].to(q.dtype)
    return out


def spec_verify(
    q: torch.Tensor,            # (b, W, h, d) one in-flight window per slot
    k_pages: torch.Tensor,      # (num_pages, page_size, kvh, d) global pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (b, max_pages) int32 page ids per request
    lengths: torch.Tensor,      # (b,) int32 committed tokens BEFORE the window
    window_lens: torch.Tensor,  # (b,) int32 real window tokens per row (0..W)
    *,
    softcap: float = 0.0,
    window=None,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, kvh) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Speculative verification: row ``b`` holds ``window_lens[b]`` in-flight
    tokens whose K/V are already in the request's pages at positions
    ``[lengths[b], lengths[b] + window_lens[b])``.  Query ``w`` sits at
    absolute position ``lengths[b] + w`` and attends every position ``<=
    lengths[b] + w`` (inside the window, if any).  Rows ``w >=
    window_lens[b]`` come back exactly zero (explicit p mask).  Gathers the
    table's ``max_pages`` columns, so a caller bounds the pages by slicing
    the table."""
    W, d = q.shape[1], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    tbl = page_table.long()
    k = _gather(k_pages, k_scales, tbl)                      # (b, S, kvh, d)
    v = _gather(v_pages, v_scales, tbl)
    k_pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    w_idx = torch.arange(W, device=q.device)[None, :, None]
    q_pos = lengths.to(q.device).long()[:, None, None] + w_idx
    valid = (k_pos <= q_pos) & (w_idx < window_lens.to(q.device).long()[:, None, None])
    if _windowed(window):
        valid &= (q_pos - k_pos) < int(window)
    return _attend(q, k, v, valid, scale, softcap).to(q.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics and the ``(1 + w)`` weight
    convention: ``x * rsqrt(mean(x^2) + eps) * (1 + w)``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, eps: float,
                dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`rmsnorm` for the output cotangent ``dy``, in
    float32 statistics: with ``r = rsqrt(mean(x^2) + eps)`` and ``g = dy (1
    + w)``, ``dx = r g - x r^3 mean(g x)`` and ``dw = sum over rows of dy x
    r``; dx in x's dtype, dw in w's."""
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    dyf = dy.float().reshape(-1, D)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    g = dyf * (1.0 + weight.float())
    dx = r * g - xf * (r * r * r) * (g * xf).mean(dim=-1, keepdim=True)
    dw = (dyf * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype)


def rmsnorm_bwd_partials(x: torch.Tensor, weight: torch.Tensor, eps: float, dy: torch.Tensor,
                         blocks: int, slots: int = 1) -> torch.Tensor:
    """The float32 partial rows of dw that the backward kernel's dx launch
    writes, ``(blocks, D)``: row ``r`` goes to block ``(r // slots) %
    blocks``, slot ``r % slots``; each slot adds its rows' ``dy x r`` in row
    order, and a block's partial is its slots' sums in slot order
    (``csrc/rmsnorm_bwd.cu``; :func:`~.rmsnorm_bwd.plan` gives blocks and
    slots)."""
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    dyf = dy.float().reshape(-1, D)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    terms = dyf * xf * r
    n = terms.shape[0]
    per = blocks * slots
    pad = torch.zeros((-(-n // per) * per - n, D), dtype=terms.dtype, device=terms.device)
    steps = torch.cat([terms, pad]).reshape(-1, blocks, slots, D)
    acc = torch.zeros((blocks, slots, D), dtype=terms.dtype, device=terms.device)
    for step in steps:
        acc = acc + step
    out = acc[:, 0]
    for i in range(1, slots):
        out = out + acc[:, i]
    return out


def rmsnorm_bwd_dw_sum(partials: torch.Tensor, warps: int = 8) -> torch.Tensor:
    """dw from :func:`rmsnorm_bwd_partials` in the dw launch's order: warp
    ``i`` sums partial rows ``i, i + warps, ...`` in order, then the warps'
    sums in warp order (float32)."""
    lanes = []
    for i in range(warps):
        acc = torch.zeros(partials.shape[1:], dtype=partials.dtype, device=partials.device)
        for row in partials[i::warps]:
            acc = acc + row
        lanes.append(acc)
    out = lanes[0]
    for lane in lanes[1:]:
        out = out + lane
    return out


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain SSD's working dtype: float32, float64 for float64 inputs
    (``torch.autograd.gradcheck`` of the op)."""
    return torch.promote_types(t.dtype, torch.float32)


def ssd_step(
    x: torch.Tensor,        # (b, h, p)
    dt: torch.Tensor,       # (b, h) softplus'd time deltas (> 0)
    A: torch.Tensor,        # (h,) negative decay rates
    B: torch.Tensor,        # (b, n)
    C: torch.Tensor,        # (b, n)
    state: torch.Tensor,    # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the SSD recurrence in float32 (``repro.kernels.ref.
    ssd_step``): ``S' = exp(dt A) S + dt x B^T``, ``y = S' C``.  Returns
    (y in x's dtype, the new state in the state's dtype)."""
    f = _acc(x)
    xf, dtf = x.to(f), dt.to(f)
    dec = torch.exp(dtf * A.to(f)[None, :])                          # (b, h)
    dB = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, B.to(f))
    new_state = dec[..., None, None] * state.to(f) + dB
    y = torch.einsum("bhpn,bn->bhp", new_state, C.to(f))
    return y.to(x.dtype), new_state.to(state.dtype)


def ssd(
    x: torch.Tensor,        # (b, s, h, p) inner activations split into heads
    dt: torch.Tensor,       # (b, s, h) softplus'd time deltas (> 0)
    A: torch.Tensor,        # (h,) negative decay rates (A < 0)
    B: torch.Tensor,        # (b, s, n) input projection (one group)
    C: torch.Tensor,        # (b, s, n) output projection
    *,
    initial_state: Optional[torch.Tensor] = None,   # (b, h, p, n)
    return_state: bool = False,
):
    """Mamba-2 SSD as the sequential recurrence over time in float32
    (``repro.kernels.ref.ssd``): ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t
    B_t^T``, ``y_t = S_t C_t``, from ``initial_state`` (zeros when None).
    Returns y (b, s, h, p) in x's dtype and, with ``return_state``, the
    final state cast to x's dtype, as all three JAX versions return it."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = (initial_state.to(_acc(x)) if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=_acc(x), device=x.device))
    ys = []
    for t in range(s):
        y_t, state = ssd_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], state)
        ys.append(y_t)
    y = torch.stack(ys, dim=1)
    return (y, state.to(x.dtype)) if return_state else y


def ssd_chunk_phases(
    x: torch.Tensor,        # (b, s, h, p)
    dt: torch.Tensor,       # (b, s, h) softplus'd time deltas (> 0)
    A: torch.Tensor,        # (h,) negative decay rates (A < 0)
    B: torch.Tensor,        # (b, s, n)
    C: torch.Tensor,        # (b, s, n)
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,   # (b, h, p, n)
    return_state: bool = False,
):
    """The chunk-parallel SSD in the three phases of ``csrc/ssd_tc.cu``, in
    float32, for tests.  Per chunk of ``chunk`` timesteps (the trailing one
    holds its live rows only) with ``cum`` the inclusive cumsum of dt A and
    ``w_k = exp(cum_last - cum_k) dt_k``: (1) chunk states ``dS_c = (x_c o
    w)^T B_c``; (2) the state pass ``S_in[c] = S; S = exp(cum_last) S +
    dS_c`` from ``initial_state`` (zeros when None); (3) the output ``y =
    (C_c B_c^T o exp(cum_q - cum_k) dt_k)[k <= q] X_c + exp(cum_q) C_c
    S_in[c]^T``, exp taken only where k <= q.  Returns what :func:`ssd`
    returns."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    spans = [slice(t0, min(s, t0 + chunk)) for t0 in range(0, s, chunk)]
    cums, dS = [], []
    for sl in spans:                                              # 1. chunk states
        cum = torch.cumsum(dtf[:, sl] * Af, dim=1)                # (b, L, h)
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        dS.append(torch.einsum("bkh,bkhp,bkn->bhpn", w, xf[:, sl], Bf[:, sl]))
        cums.append(cum)
    S = (initial_state.float() if initial_state is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    s_in = []
    for cum, d in zip(cums, dS):                                  # 2. state pass
        s_in.append(S)
        S = torch.exp(cum[:, -1])[..., None, None] * S + d
    ys = []
    for sl, cum, Sc in zip(spans, cums, s_in):                    # 3. output
        L = cum.shape[1]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[None, :, :, None]
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (b, q, k, h)
        decay = torch.where(causal, torch.exp(seg.masked_fill(~causal, 0.0)), 0.0)
        cb = torch.einsum("bqn,bkn->bqk", Cf[:, sl], Bf[:, sl])
        G = cb[..., None] * decay * dtf[:, sl][:, None]
        ys.append(torch.einsum("bqkh,bkhp->bqhp", G, xf[:, sl])
                  + torch.exp(cum)[..., None] * torch.einsum("bqn,bhpn->bqhp", Cf[:, sl], Sc))
    y = torch.cat(ys, dim=1).to(x.dtype)
    return (y, S.to(x.dtype)) if return_state else y


# timesteps between the states the plain backward keeps: it recomputes the
# states of one segment at a time from the one entering it, so its memory
# holds s / SSD_BWD_SEGMENT + SSD_BWD_SEGMENT states, not s
SSD_BWD_SEGMENT = 64


def ssd_bwd(
    x: torch.Tensor,        # (b, s, h, p)
    dt: torch.Tensor,       # (b, s, h) softplus'd time deltas (> 0)
    A: torch.Tensor,        # (h,) negative decay rates (A < 0)
    B: torch.Tensor,        # (b, s, n)
    C: torch.Tensor,        # (b, s, n)
    dy: torch.Tensor,       # (b, s, h, p) the cotangent of y
    *,
    initial_state: Optional[torch.Tensor] = None,   # (b, h, p, n)
    d_final: Optional[torch.Tensor] = None,         # (b, h, p, n) the final state's cotangent
) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssd` by the sequential reverse recurrence
    over timesteps, in float32 and independent of any chunking.  With
    ``a_t = exp(dt_t A)`` and the forward's states ``S_t`` (``S_{-1}`` the
    initial state), the state's cotangent runs backwards as ``H_t = dy_t
    C_t^T + a_{t+1} H_{t+1}`` from ``H = d_final`` (zeros when None), and
    ``dx_t = dt_t H_t B_t``, ``dB_t = sum_h dt_t H_t^T x_t``, ``dC_t = sum_h
    S_t^T dy_t``, ``ddt_t = x_t^T H_t B_t + A a_t <H_t, S_{t-1}>``, ``dA =
    sum_{b,t} dt_t a_t <H_t, S_{t-1}>``, ``d_initial = a_0 H_0``.  Returns
    (dx in x's dtype, ddt and dA float32, dB and dC in B's dtype, d_initial
    float32; float64 for float64 inputs)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f = _acc(x)
    xf, dtf, Bf, Cf, dyf, Af = (t.to(f) for t in (x, dt, B, C, dy, A))
    a = torch.exp(dtf * Af)                                          # (b, s, h)
    new = lambda *shape: torch.empty(shape, dtype=f, device=x.device)

    def advance(S, t):
        return a[:, t, :, None, None] * S + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])

    S = initial_state.to(f) if initial_state is not None else new(b, h, p, n).zero_()
    entry = []                                 # the state entering each segment
    for t in range(s):
        if t % SSD_BWD_SEGMENT == 0:
            entry.append(S)
        S = advance(S, t)
    H = d_final.to(f) if d_final is not None else new(b, h, p, n).zero_()
    dx, ddt, dB, dC = new(b, s, h, p), new(b, s, h), new(b, s, n), new(b, s, n)
    dA = new(h).zero_()
    for seg in reversed(range(len(entry))):
        t0, t1 = seg * SSD_BWD_SEGMENT, min(s, (seg + 1) * SSD_BWD_SEGMENT)
        states = [entry[seg]]                  # S_{t0-1} .. S_{t1-1}
        for t in range(t0, t1):
            states.append(advance(states[-1], t))
        for t in reversed(range(t0, t1)):
            S_t, S_prev = states[t - t0 + 1], states[t - t0]
            H = H + torch.einsum("bhp,bn->bhpn", dyf[:, t], Cf[:, t])
            dC[:, t] = torch.einsum("bhpn,bhp->bn", S_t, dyf[:, t])
            HB = torch.einsum("bhpn,bn->bhp", H, Bf[:, t])
            dx[:, t] = dtf[:, t, :, None] * HB
            dB[:, t] = torch.einsum("bh,bhpn,bhp->bn", dtf[:, t], H, xf[:, t])
            hs = a[:, t] * torch.einsum("bhpn,bhpn->bh", H, S_prev)
            ddt[:, t] = (xf[:, t] * HB).sum(-1) + Af * hs
            dA += (dtf[:, t] * hs).sum(0)
            H = a[:, t, :, None, None] * H
    return dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), H


def _reverse_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``out_k = sum_{j >= k} t_j`` along ``dim``."""
    return t.flip(dim).cumsum(dim).flip(dim)


def _two_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the sum of its two bf16 terms ``hi = bf16(t)`` and ``lo =
    bf16(t - hi)``, in float32."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _ssd_carry_back(G, decays, d_final):
    """The backward kernel's reverse state pass: from ``W = d_final``, per
    chunk c from the last, ``W_c = W`` (the cotangent of the state leaving
    chunk c), then ``W = G_c + exp(cum_last_c) W``.  Returns ([W_c], the
    cotangent of the initial state)."""
    W, out = d_final, [None] * len(G)
    for c in reversed(range(len(G))):
        out[c] = W
        W = G[c] + decays[c][..., None, None] * W
    return out, W


def ssd_bwd_chunks(
    x: torch.Tensor,        # (b, s, h, p)
    dt: torch.Tensor,       # (b, s, h)
    A: torch.Tensor,        # (h,)
    B: torch.Tensor,        # (b, s, n)
    C: torch.Tensor,        # (b, s, n)
    dy: torch.Tensor,       # (b, s, h, p)
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,
    d_final: Optional[torch.Tensor] = None,
    split: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """What :func:`ssd_bwd` returns, in the chunks and launches of
    ``csrc/ssd_bwd.cu`` and ``csrc/ssd_bwd_tc.cu``, in float32, for tests.
    With ``split`` every float32 operand of a product (x o w, dy o
    exp(cum), P, R, W_c, S_c) passes through its two bf16 terms
    (:func:`_two_bf16`), as the tensor-core route takes it.  Per chunk of ``chunk``
    timesteps (the trailing one its live rows), ``cum`` the inclusive cumsum
    of dt A and ``L = cum_last``: (1) the forward's chunk states and ``G_c =
    sum_t exp(cum_t) dy_t C_t^T``; (2) the state pass: the entry states
    ``S_c`` forwards, and backwards ``W_c`` (:func:`_ssd_carry_back`);
    (3) per chunk, with ``E_tk = exp(cum_t - cum_k)`` for ``k <= t``,
    ``P = (C_t . B_k) E``, ``R = (dy_t . x_k) E dt_k`` and ``ew_k =
    exp(L - cum_k)``: ``dx_k = dt_k (sum_t P_tk dy_t + ew_k W B_k)``, ``dB_k
    = sum_t R_tk C_t + dt_k ew_k W^T x_k``, ``dC_t = sum_k R_tk B_k +
    exp(cum_t) S_c^T dy_t`` (summed over heads), the direct part of ddt
    ``sum_t P_tk (dy_t . x_k) + ew_k x_k^T W B_k``, and ``dcum``: ``+M_tk``
    to t and ``-M_tk`` to k for ``M = P (dy . x) dt_k``, ``exp(cum_t) <dy_t,
    S_c C_t>`` to t, ``-ew_k dt_k x_k^T W B_k`` to k and ``exp(L) <W, S_c> +
    sum_k ew_k dt_k x_k^T W B_k`` to the last row; then ``da =``
    :func:`_reverse_cumsum` of ``dcum``, ``ddt += A da``, ``dA = sum dt
    da``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, dyf, Af = (t.float() for t in (x, dt, B, C, dy, A))
    op = _two_bf16 if split else (lambda t: t)                    # a product's float32 operand
    zeros = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    spans = [slice(t0, min(s, t0 + chunk)) for t0 in range(0, s, chunk)]
    cums, dS, G = [], [], []
    for sl in spans:                                              # 1. chunk states
        cum = torch.cumsum(dtf[:, sl] * Af, dim=1)                # (b, L, h)
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        dS.append(torch.einsum("bkhp,bkn->bhpn", op(w[..., None] * xf[:, sl]), Bf[:, sl]))
        G.append(torch.einsum("bthp,btn->bhpn", op(torch.exp(cum)[..., None] * dyf[:, sl]),
                              Cf[:, sl]))
        cums.append(cum)
    S = initial_state.float() if initial_state is not None else zeros
    s_in = []
    for cum, d in zip(cums, dS):                                  # 2. state pass
        s_in.append(S)
        S = torch.exp(cum[:, -1])[..., None, None] * S + d
    Ws, d_initial = _ssd_carry_back(G, [torch.exp(cum[:, -1]) for cum in cums],
                                    d_final.float() if d_final is not None else zeros)
    dx, ddt, dB, dC = [], [], [], []
    dA = torch.zeros((h,), dtype=torch.float32, device=x.device)
    for sl, cum, Sc, W in zip(spans, cums, s_in, Ws):             # 3. chunk gradients
        xc, dyc, Bc, Cc, dtc = xf[:, sl], dyf[:, sl], Bf[:, sl], Cf[:, sl], dtf[:, sl]
        L = cum.shape[1]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[None, :, :, None]
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (b, t, k, h)
        E = torch.where(causal, torch.exp(seg.masked_fill(~causal, 0.0)), 0.0)
        DX = torch.einsum("bthp,bkhp->btkh", dyc, xc)
        P = torch.einsum("btn,bkn->btk", Cc, Bc)[..., None] * E
        R = DX * E * dtc[:, None]
        PD = P * DX
        last = cum[:, -1:]                                        # (b, 1, h)
        ew, ecum = torch.exp(last - cum), torch.exp(cum)          # (b, L, h)
        Wo, So = op(W), op(Sc)
        WB = torch.einsum("bhpn,bkn->bkhp", Wo, Bc)
        xwb = (xc * WB).sum(-1)                                   # (b, L, h)
        dx.append(dtc[..., None] * (torch.einsum("btkh,bthp->bkhp", op(P), dyc)
                                    + ew[..., None] * WB))
        dB.append(torch.einsum("btkh,btn->bkn", op(R), Cc)
                  + torch.einsum("bkh,bhpn,bkhp->bkn", dtc * ew, Wo, xc))
        dC.append(torch.einsum("btkh,bkn->btn", op(R), Bc)
                  + torch.einsum("bth,bhpn,bthp->btn", ecum, So, dyc))
        col = PD.sum(1)                                           # (b, k, h)
        dysc = (dyc * torch.einsum("bhpn,btn->bthp", So, Cc)).sum(-1)
        dcum = (torch.einsum("btkh,bkh->bth", PD, dtc) - dtc * col + ecum * dysc
                - ew * dtc * xwb)
        tail = torch.exp(last[:, 0]) * (W * Sc).sum((-2, -1)) + (ew * dtc * xwb).sum(1)
        dcum = torch.cat([dcum[:, :-1], dcum[:, -1:] + tail[:, None]], dim=1)
        da = _reverse_cumsum(dcum, 1)
        ddt.append(col + ew * xwb + Af * da)
        dA += (dtc * da).sum((0, 1))
    cat = lambda ts: torch.cat(ts, dim=1)
    return (cat(dx).to(x.dtype), cat(ddt), dA, cat(dB).to(B.dtype), cat(dC).to(C.dtype),
            d_initial)
