"""Plain PyTorch versions of the serving kernels.

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
same scan in the three phases of the tensor-core kernel, for tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


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


def _attend(q, k, v, valid, scale: float, softcap: float) -> torch.Tensor:
    """Grouped-query attention with an explicit mask and a safe softmax.

    q ``(B, n, h, d)``, k/v ``(B, m, kvh, d)``, valid ``(B, n, m)`` bool.
    Returns float32 ``(B, n, h, d)``; a row with no valid key is exactly 0.
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
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    out = torch.einsum("bgrnm,bmgd->bngrd", p, v.float())
    return out.reshape(B, n, h, d)


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
    sq, d = q.shape[1], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        valid &= q_pos >= k_pos
    if _windowed(window):
        valid &= (q_pos - k_pos) < int(window)
    out = _attend(q, k, v, valid[None].expand(q.shape[0], -1, -1), scale, softcap)
    return out.to(q.dtype)


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
    xf, dtf = x.float(), dt.float()
    dec = torch.exp(dtf * A.float()[None, :])                        # (b, h)
    dB = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, B.float())
    new_state = dec[..., None, None] * state.float() + dB
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
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
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
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
