"""Each hand-written kernel's work: its FLOPs and the bytes it must move.

One function per kernel, from its shapes, and one ``*_call`` adapter per
kernel-backed op of :mod:`repro_torch.kernels.ops` that reads those shapes
off the op's arguments (the counter, :mod:`.count`, calls them).  The
definitions are the bounds' (``PERF.md`` §6):

* bytes — each input read once and each output written once, where the
  data needs them: the keys a causal mask, a window or a length leaves
  live, a pool row's codes and scale where the pool is int8/fp8, the int32
  metadata (lengths, offsets, page-table entries) the kernel reads;
  workspaces the kernel makes for itself are not counted;
* FLOPs — 2 a multiply-add, over what the data needs: attention's QK^T and
  PV over live (query, key) pairs (4 · h · d a pair: causal attention
  halves the square, a window counts the pairs it leaves, the decode
  family the live keys), rmsnorm 4 a element, its backward 10; the flash
  backward 10 · b · h · sq · sk · d, halved for causal; the scan and its
  backward as :func:`ssd` and :func:`ssd_bwd` say.

:func:`bound_ms` is the least time the card could take: the larger of
bytes over the memory rate and FLOPs over the bf16 peak
(:data:`~.model.H100_SXM`).  The adapters of the decode family and of
``varlen_prefill`` read the lengths to the host: only a counted pass calls
them, never a timed one.  On meta tensors (the dry run), which hold no
lengths, ``decode_attention`` counts every row at its ``kv_bound`` (the
whole cache without one).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .model import H100_SXM, HardwareSpec

# a global layer's window (the models' GLOBAL_WINDOW) reaches the kernels as
# no window; any window at least this wide is none
_NO_WINDOW = 1 << 30


class Work(NamedTuple):
    flops: float
    bytes: float


def bound_ms(work: Work, hw: HardwareSpec = H100_SXM) -> Tuple[float, str]:
    """(the least ms the card could take for ``work``, what bounds it:
    ``"bytes"`` or ``"operations"``)."""
    t_bytes = work.bytes / hw.hbm_bw * 1e3
    t_ops = work.flops / hw.peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _window(window) -> Optional[int]:
    return None if window is None or window <= 0 or window >= _NO_WINDOW else int(window)


def live_pairs(sq: int, sk: int, causal: bool = True, window=None, q_offset: int = 0) -> int:
    """(query, key) pairs a pass leaves live: queries at positions
    ``q_offset .. q_offset + sq - 1`` over keys ``0 .. sk - 1``, a key at
    most the query's position when ``causal`` and less than ``window``
    behind it."""
    w = _window(window)
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(pos - w + 1, 0) if w else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def live_keys(sq: int, sk: int, causal: bool = True, window=None, q_offset: int = 0) -> int:
    """Keys live for at least one query of such a pass: the keys it reads."""
    if sq <= 0:
        return 0
    w = _window(window)
    lo = max(q_offset - w + 1, 0) if w else 0
    hi = min(q_offset + sq - 1, sk - 1) if causal else sk - 1
    return max(hi - lo + 1, 0)


def rmsnorm(rows: int, d: int, itemsize: int = 2, w_itemsize: Optional[int] = None) -> Work:
    """x in, the normalized rows out, the weight once."""
    w_itemsize = itemsize if w_itemsize is None else w_itemsize
    return Work(4.0 * rows * d, itemsize * 2 * rows * d + w_itemsize * d)


def rmsnorm_bwd(rows: int, d: int, itemsize: int = 2, w_itemsize: Optional[int] = None) -> Work:
    """x and dy in, dx out; the weight in and dw out."""
    w_itemsize = itemsize if w_itemsize is None else w_itemsize
    return Work(10.0 * rows * d, itemsize * 3 * rows * d + w_itemsize * 2 * d)


def flash_attention(b: int, sq: int, sk: int, h: int, kvh: int, d: int, *, causal: bool = True,
                    window=None, q_offset: int = 0, itemsize: int = 2,
                    lse: bool = False) -> Work:
    """q in and out; the K/V rows live for some query; with ``lse`` the
    float32 log-sum-exp out (the training forward's)."""
    pairs = live_pairs(sq, sk, causal, window, q_offset)
    keys = live_keys(sq, sk, causal, window, q_offset)
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * keys * kvh * d)
    return Work(4.0 * h * d * b * pairs, nbytes + (4 * b * h * sq if lse else 0))


def flash_attention_bwd(b: int, sq: int, sk: int, h: int, kvh: int, d: int, *,
                        causal: bool = True, window=None, q_offset: int = 0,
                        itemsize: int = 2) -> Work:
    """q, o, do in and dq out; k, v in and dk, dv out; the float32
    log-sum-exp in.  10 FLOPs a (row, key, column): the recomputed QK^T, dP
    and the three products of dQ, dK and dV; causal halves the square, a
    window counts its live pairs."""
    if _window(window):
        pairs = live_pairs(sq, sk, causal, window, q_offset)
    else:
        pairs = sq * sk / 2 if causal else sq * sk
    nbytes = itemsize * (4 * b * sq * h * d + 4 * b * sk * kvh * d) + 4 * b * h * sq
    return Work(10.0 * b * h * d * pairs, nbytes)


def _row_bytes(d: int, itemsize: int, quantized: bool) -> int:
    """Bytes of one pool row of one kv head: d values, or d codes and a
    float32 scale."""
    return d + 4 if quantized else itemsize * d


def decode_attention(b: int, h: int, kvh: int, d: int, live: int, *,
                     itemsize: int = 2) -> Work:
    """One query token a row over ``live`` live keys in all (a window's
    keys where one bites): q in and out, their K/V rows, the lengths."""
    return Work(4.0 * h * d * live,
                itemsize * 2 * b * h * d + 2 * live * kvh * itemsize * d + 4 * b)


def paged_attention(b: int, h: int, kvh: int, d: int, live: int, table_entries: int, *,
                    itemsize: int = 2, quantized: bool = False) -> Work:
    """:func:`decode_attention` over a paged pool: its rows (codes and
    scales on an int8/fp8 pool) and the page-table entries read."""
    return Work(4.0 * h * d * live,
                itemsize * 2 * b * h * d + 2 * live * kvh * _row_bytes(d, itemsize, quantized)
                + 4 * (b + table_entries))


def spec_verify(b: int, w: int, h: int, kvh: int, d: int, keys: int, pairs: int,
                table_entries: int, *, itemsize: int = 2, quantized: bool = False) -> Work:
    """A ``w``-row verify window a slot: q in and out, the ``keys`` K/V rows
    the windows read (committed and in flight), ``pairs`` live (row, key)
    pairs, the lengths, window lengths and table entries."""
    return Work(4.0 * h * d * pairs,
                itemsize * 2 * b * w * h * d + 2 * keys * kvh * _row_bytes(d, itemsize, quantized)
                + 4 * (2 * b + table_entries))


def varlen_prefill(t: int, h: int, kvh: int, d: int, chunks: Sequence[Tuple[int, int]],
                   table_entries: int, *, window=None, itemsize: int = 2,
                   quantized: bool = False) -> Work:
    """One packed buffer of ``t`` tokens holding ``chunks`` (length,
    first position): q in and out and the packed K/V in, all ``t`` rows;
    each chunk's context rows its queries see (a window's where one bites)
    from the pool; its pairs over that context and its own causal prefix;
    the offsets, lengths, positions and table entries."""
    ctx_rows = pairs = 0
    for n, pos0 in chunks:
        if n <= 0:
            continue
        w = _window(window)
        ctx_rows += pos0 - (max(pos0 - w + 1, 0) if w else 0)
        pairs += live_pairs(n, pos0 + n, True, window, pos0)
    c = len(chunks)
    nbytes = (itemsize * (2 * t * h * d + 2 * t * kvh * d)
              + 2 * ctx_rows * kvh * _row_bytes(d, itemsize, quantized)
              + 4 * (3 * c + 1 + table_entries))
    return Work(4.0 * h * d * pairs, nbytes)


def ssd(b: int, s: int, h: int, p: int, n: int, chunk: int, *, itemsize: int = 2,
        initial_state: bool = False, final_state: bool = True) -> Work:
    """The chunked scan.  FLOPs per chunk of L live timesteps: C.B^T over
    its causal pairs (shared by the heads) and, per head, the intra-chunk
    product over the causal pairs, the inter-chunk term and the state
    update.  Bytes: x in and y out, B and C in, float32 dt and A in, the
    float32 initial state in and the final state out (in x's dtype) where
    there are."""
    flops = 0
    for t0 in range(0, s, chunk):
        L = min(chunk, s - t0)
        pairs = L * (L + 1) // 2
        flops += 2 * pairs * n + h * (2 * pairs * p + 4 * L * p * n)
    state = b * h * p * n
    nbytes = (itemsize * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h + 4 * h
              + (4 * state if initial_state else 0) + (itemsize * state if final_state else 0))
    return Work(float(b * flops), nbytes)


def ssd_bwd(b: int, s: int, h: int, p: int, n: int, chunk: int, *, itemsize: int = 2,
            initial_state: bool = False, d_final: bool = False) -> Work:
    """The scan's backward, the least it needs (the forward's entry states
    given).  FLOPs per chunk of L live timesteps: C.B^T over its causal
    pairs (shared by the heads); per head dy.x^T, the intra-chunk products
    of dx, dB and dC over the causal pairs, and five L x p x n products
    (G_c, W B_k, W^T x_k, S_c^T dy_t, S_c C_t).  Bytes: x, dy in and dx out;
    B, C in and dB, dC out; float32 dt in and ddt out, A in and dA out; the
    float32 initial state's cotangent out, and the initial state and final
    state's cotangent in where there are."""
    flops = 0
    for t0 in range(0, s, chunk):
        L = min(chunk, s - t0)
        pairs = L * (L + 1) // 2
        flops += 2 * pairs * n + h * (4 * pairs * p + 4 * pairs * n + 10 * L * p * n)
    state = b * h * p * n
    nbytes = (itemsize * (3 * b * s * h * p + 4 * b * s * n) + 2 * 4 * b * s * h + 2 * 4 * h
              + 4 * state * (1 + int(initial_state) + int(d_final)))
    return Work(float(b * flops), nbytes)


# -- adapters: each kernel-backed op's work from its arguments ------------------

def _seen(lengths, window) -> list:
    """Each row's live keys: its length, or the window where it bites."""
    w = _window(window)
    return [min(n, w) if w else n for n in (int(x) for x in lengths.tolist())]


def rmsnorm_call(x, weight, eps=1e-6) -> Work:
    d = x.shape[-1]
    return rmsnorm(x.numel() // d, d, x.element_size(), weight.element_size())


def rmsnorm_bwd_call(x, weight, eps, dy) -> Work:
    d = x.shape[-1]
    return rmsnorm_bwd(x.numel() // d, d, x.element_size(), weight.element_size())


def attention_call(q, k, v, *, causal=True, window=None, softcap=0.0, q_offset=0, scale=None,
                   lse=False) -> Work:
    b, sq, h, d = q.shape
    return flash_attention(b, sq, k.shape[1], h, k.shape[2], d, causal=causal, window=window,
                           q_offset=q_offset, itemsize=q.element_size(), lse=lse)


def attention_bwd_call(q, k, v, *, causal=True, window=None, q_offset=0, **_) -> Work:
    b, sq, h, d = q.shape
    return flash_attention_bwd(b, sq, k.shape[1], h, k.shape[2], d, causal=causal,
                               window=window, q_offset=q_offset, itemsize=q.element_size())


def decode_attention_call(q, k_cache, v_cache, lengths, *, window=None, kv_bound=None,
                          **_) -> Work:
    h, d = q.shape[-2:]
    b = q.numel() // (h * d)
    if lengths.device.type == "meta":
        # no lengths to read (the dry run): every row at the host-known bound
        S = k_cache.shape[1]
        bound = S if kv_bound is None else max(min(int(kv_bound), S), 1)
        live = b * (min(bound, _window(window)) if _window(window) else bound)
    else:
        live = sum(_seen(lengths, window))
    return decode_attention(b, h, k_cache.shape[2], d, live, itemsize=q.element_size())


def paged_attention_call(q, k_pages, v_pages, page_table, lengths, *, window=None,
                         pages_bound=None, k_scales=None, **_) -> Work:
    h, d = q.shape[-2:]
    b = q.numel() // (h * d)
    width = page_table.shape[1] if pages_bound is None else min(pages_bound, page_table.shape[1])
    return paged_attention(b, h, k_pages.shape[2], d, sum(_seen(lengths, window)), b * width,
                           itemsize=q.element_size(), quantized=k_scales is not None)


def spec_verify_call(q, k_pages, v_pages, page_table, lengths, window_lens, *, window=None,
                     pages_bound=None, k_scales=None, **_) -> Work:
    b, w, h, d = q.shape
    width = page_table.shape[1] if pages_bound is None else min(pages_bound, page_table.shape[1])
    keys = pairs = 0
    for L, n in zip(lengths.tolist(), window_lens.tolist()):
        if n > 0:
            keys += live_keys(n, L + n, True, window, L)
            pairs += live_pairs(n, L + n, True, window, L)
    return spec_verify(b, w, h, k_pages.shape[2], d, keys, pairs, b * width,
                       itemsize=q.element_size(), quantized=k_scales is not None)


def varlen_prefill_call(q, k, v, k_pages, v_pages, cu_seqlens, chunk_lens, chunk_pos0,
                        page_tables, *, window=None, k_scales=None, **_) -> Work:
    t, h, d = q.shape
    chunks = list(zip(chunk_lens.tolist(), chunk_pos0.tolist()))
    return varlen_prefill(t, h, k.shape[1], d, chunks, page_tables.numel(), window=window,
                          itemsize=q.element_size(), quantized=k_scales is not None)


def ssd_call(x, dt, A, B, C, *, chunk=64, initial_state=None, return_state=False) -> Work:
    b, s, h, p = x.shape
    return ssd(b, s, h, p, B.shape[2], chunk, itemsize=x.element_size(),
               initial_state=initial_state is not None, final_state=return_state)


def ssd_bwd_call(x, dt, A, B, C, dy, *, chunk=64, initial_state=None, d_final=None,
                 **_) -> Work:
    b, s, h, p = x.shape
    return ssd_bwd(b, s, h, p, B.shape[2], chunk, itemsize=x.element_size(),
                   initial_state=initial_state is not None, d_final=d_final is not None)
