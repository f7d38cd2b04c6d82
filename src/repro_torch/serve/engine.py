"""Serving engines (the port's ``repro.serve.engine``): the static and
continuous engines on a dense KV cache, and the paged engine.

``ServingEngine.generate`` is the static engine: one batch of prompts,
right-padded to a power-of-two bucket, is prefilled in one pass into a
dense ``(L, b, max_seq, kvh, d)`` cache, then decoded in lockstep.
``ServingEngine.serve_continuous`` is slot-based continuous batching on the
same dense cache: each admission prefills its prompt at batch 1 and copies
that cache into a free slot; every decode step advances all slots, each at
its own position.  Both decode with a power-of-two bound on the live
lengths, so attention reads only that prefix of the cache.  The SSM family
(Mamba-2) runs the same two engines on its cache of per-layer states, with
the reference's exact-length shapes: every batch or admission is LEFT-padded
to the longest prompt of its set, with no bucket and no lengths (the pads
flow through the state, so the shapes must be the reference's for its
tokens), and decodes at one shared position with no bound.

``ServingEngine.serve_paged`` is paged-KV continuous batching: a global pool
of ``page_size``-token pages plus per-slot page tables; admission is keyed
on free pages and on the pool's worst-case commitment (every active
request's ``prompt + max_new_tokens``), so page growth never fails and
nothing is preempted.  At each boundary every prefilling slot's next span is
packed into ONE token-packed varlen-prefill launch of ``prefill_budget``
tokens (oldest request first, capped by the :class:`PrefillBudget` ledger),
then one fused decode step runs over the whole slot pool.

The decode state lives on the device: the page table, positions, next
tokens and the active mask are patched only for slots that changed
(admission, page growth, release), in one small upload.  The decode step
itself does argmax, the next-token update and the position bump on the
device, so a steady boundary costs one small int32 fetch.

``spec_k > 0`` adds self-speculative decoding: a prompt-lookup drafter
(:func:`ngram_propose`) proposes up to ``spec_k`` tokens per slot, one
verify step scores every slot's ``[next_token, drafts]`` window in one
launch per layer, and the greedy acceptance (a cumulative product of
matches), the position bump by ``accepted + 1`` and the next-token update
all run on the device.  A rejected suffix rolls back by rewinding the
length and handing any page it opened back to the pool.  ``kv_dtype``
``"int8"``/``"fp8"`` stores the pool as codes with float32 per-row scales.

What waits for later slices: encoder inputs (``extra_inputs``) and
sampling in ``generate``; chunked prefill and preemption (``overcommit >
1``), the prefix cache, tensor parallelism, tenants and deadlines,
checkpoints and the fault hook in ``serve_paged``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..core.analysis import percentile
from ..device import resolve_device
from ..kernels import kvquant
from ..models.lm import DecoderLM
from .page_table import PagePool, PageTable, pages_needed
from .scheduler import PagedSlotPool, PrefillBudget, SlotPool, SpecLedger


def bucket_pow2(n: int, floor: int = 1, cap: Optional[int] = None) -> int:
    """Smallest power-of-two multiple of ``floor`` that is >= ``n``, clipped
    to ``cap``.  Callers guarantee ``n <= cap``; the clip keeps the top
    bucket from overshooting the cache."""
    b = max(floor, 1)
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


def ngram_propose(context: np.ndarray, ngram: int, max_tokens: int) -> List[int]:
    """Prompt-lookup drafting (a copy of ``repro.serve.engine.ngram_propose``):
    match the last ``ngram`` tokens of ``context`` (prompt + everything
    committed so far, ending at the pending next token) against earlier
    context; the tokens that FOLLOWED the match become the draft.  Scanning
    from the most recent match backwards, the first one with a full
    ``max_tokens`` continuation wins (a short repetition period would
    otherwise cap every draft at the period); if none has a full
    continuation the most recent match is used.  Returns up to
    ``max_tokens`` draft ids, empty when nothing matches."""
    n = len(context)
    if max_tokens <= 0 or ngram < 1 or n < ngram + 1:
        return []
    pat = context[-ngram:]
    windows = np.lib.stride_tricks.sliding_window_view(context, ngram)
    hits = np.nonzero((windows == pat).all(axis=1))[0]
    hits = hits[hits < n - ngram]          # drop the suffix occurrence itself
    if hits.size == 0:
        return []
    full = hits[hits + ngram + max_tokens <= n]
    best = int(full[-1]) if full.size else int(hits[-1])
    cont = context[best + ngram : best + ngram + max_tokens]
    return [int(t) for t in cont]


@dataclass
class GenerationResult:
    """Output of one static ``generate`` batch."""

    tokens: np.ndarray          # (b, new_tokens)
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    first_token_s: float = 0.0  # time.perf_counter() when the prefill's tokens were out


@dataclass
class ServeRequest:
    """One prompt for the paged loop."""

    request_id: int
    prompt: np.ndarray
    max_new_tokens: int


@dataclass
class RequestResult:
    """Per-request serving metrics."""

    request_id: int
    tokens: np.ndarray          # (max_new_tokens,)
    slot: int
    admit_step: int             # decode-step boundary at which it was admitted
    finish_step: int
    ttft_s: float               # submit -> first token (prefill argmax)
    latency_s: float            # submit -> last token
    tokens_per_s: float
    itl_p50_s: float = 0.0      # inter-token latency (gaps between emissions)
    itl_p99_s: float = 0.0
    status: str = "completed"
    draft_proposed: int = 0     # speculative drafts proposed for this request
    draft_accepted: int = 0


@dataclass
class ContinuousStats:
    """Aggregate output of one ``serve_continuous`` run."""

    results: List[RequestResult]
    steps: int                  # decode steps executed
    wall_s: float
    total_tokens: int
    throughput_tps: float
    mean_slot_occupancy: float  # active slots per decode step
    prefill_s: float = 0.0      # host wall time inside admission prefills
    prefill_tokens: int = 0     # real prompt tokens prefilled
    decode_s: float = 0.0       # host wall time inside decode steps


@dataclass
class PagedStats:
    """Aggregate output of one ``serve_paged`` run."""

    results: List[RequestResult]
    steps: int                  # decode steps executed
    wall_s: float
    total_tokens: int
    throughput_tps: float
    mean_slot_occupancy: float  # active slots per decode step
    peak_slot_occupancy: int    # max concurrent requests observed
    page_size: int
    num_pages: int              # allocatable pages in the pool
    mean_pages_in_use: float
    peak_pages_in_use: int
    preemptions: int
    prefill_chunks: int         # prompt spans prefilled
    prefill_mode: str = "packed"
    prefill_launches: int = 0   # packed launches
    prefill_s: float = 0.0      # wall time spent inside prefill launches
    prefill_tokens: int = 0     # real prompt tokens computed by prefill
    prefill_padded_tokens: int = 0  # packed-buffer slots spent on padding
    prefill_budget: int = 0     # packed-buffer tokens per boundary
    prefill_budget_stats: Dict[str, float] = field(default_factory=dict)
    # prompt-token ledger; over any completed run
    #   prompt_tokens_admitted ==
    #       prefill_tokens + saved_prefill_tokens + prefill_tokens_dropped
    # (no prefix cache and no preemption yet: the last two stay 0)
    prompt_tokens_admitted: int = 0
    saved_prefill_tokens: int = 0
    prefill_tokens_dropped: int = 0
    decode_s: float = 0.0       # wall time spent inside decode launches
    spec_k: int = 0             # draft depth (0 = speculation off)
    spec_stats: Dict[str, float] = field(default_factory=dict)  # SpecLedger.stats()
    itl_p50_ms: float = 0.0     # inter-token latency over every gap in the run
    itl_p99_ms: float = 0.0
    kv_dtype: str = "float32"   # pool storage (int8/fp8: codes + f32 scales)
    kv_bytes_per_token: float = 0.0  # pool bytes per token, all layers


def _upload(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Copy int32 host arrays to ``device`` in ONE transfer; the returned
    tensors are contiguous views of the one device buffer."""
    flat = np.concatenate([np.asarray(a, np.int32).ravel() for a in arrays.values()])
    buf = torch.from_numpy(flat).to(device)
    out, off = {}, 0
    for k, a in arrays.items():
        n = int(np.prod(a.shape))
        out[k] = buf[off : off + n].view(a.shape)
        off += n
    return out


def _sync(device: torch.device) -> None:
    """Wait for the card (a host clock read after it times finished work)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    def __init__(
        self,
        model: DecoderLM,
        params,
        max_batch: int,
        max_seq: int,
        page_size: int = 16,
        device: Union[str, torch.device, None] = None,
        kv_dtype: Optional[str] = None,
    ) -> None:
        self.device = resolve_device(device)
        # None: the pool in the model's dtype; "int8"/"fp8": codes with
        # float32 per-row scales, dequantized inside the attention kernels
        if kv_dtype is not None and not kvquant.is_quantized(kv_dtype):
            raise ValueError(
                f"kv_dtype {kv_dtype!r}: expected None (the model's dtype) or one "
                f"of {sorted(kvquant.KV_DTYPES)}"
            )
        self.kv_dtype = kv_dtype
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine asked for {self.device}"
            )
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        # tokens per KV page
        self.page_size = page_size
        # right-padded ragged prefill (and kv-bounded decode) is exact only
        # for pure-attention caches; ssm state scans absorb pads, so the SSM
        # family keeps exact-length, left-padded shapes
        self._ragged_ok = not model.ssm

    def _kv_dtype_name(self) -> str:
        return self.kv_dtype or str(self.model.dtype).replace("torch.", "")

    # -- dense-cache engines ------------------------------------------------------
    def _kv_bucket(self, live_len: int) -> Optional[int]:
        """The decode bound on live lengths: a power-of-two multiple of the
        page size (or ``max_seq``), at most ``max_seq``; None (no bound) for
        the SSM family, whose cache has no sequence axis."""
        if not self._ragged_ok:
            return None
        return bucket_pow2(live_len, floor=min(self.page_size, self.max_seq), cap=self.max_seq)

    def _pad_prompts(self, prompts: List[np.ndarray],
                     max_new_tokens: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Pad a prompt batch to one prefill length.  Attention families
        right-pad to a power-of-two bucket floored at the page size: causal
        attention never reads the trailing pads and the model takes the
        logits at ``lengths - 1``.  The SSM family left-pads to the exact
        longest prompt, so every row's last token sits at the end.
        Returns (tokens (b, padded) int32, lengths (b,) int32)."""
        b = len(prompts)
        if b > self.max_batch:
            raise ValueError(f"batch {b} > max_batch {self.max_batch}")
        lens = np.asarray([len(p) for p in prompts], np.int32)
        max_len = int(lens.max())
        if max_len + max_new_tokens > self.max_seq:
            raise ValueError("prompt + generation exceeds max_seq")
        if not self._ragged_ok:
            out = np.zeros((b, max_len), np.int32)
            for i, p in enumerate(prompts):
                out[i, max_len - len(p):] = p
            return out, lens
        padded = bucket_pow2(max_len, floor=min(self.page_size, self.max_seq),
                             cap=max(self.max_seq - max_new_tokens, max_len))
        out = np.zeros((b, padded), np.int32)
        for i, p in enumerate(prompts):
            out[i, : len(p)] = p
        return out, lens

    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray], max_new_tokens: int) -> GenerationResult:
        """Static batched greedy generation: one prefill of the padded batch
        into a fresh dense cache, then ``max_new_tokens`` decode steps in
        lockstep (the last one's token is not kept, as in the JAX engine).
        Rows of one length, and the left-padded rows of the SSM family,
        decode at one shared position; a ragged attention batch writes each
        row at its own.  The tokens stay on the device until the end: the
        loop never waits for the card."""
        dev = self.device
        tokens, lens = self._pad_prompts(prompts, max_new_tokens)
        b = tokens.shape[0]
        max_len = int(lens.max())
        cache = self.model.init_cache(b, self.max_seq)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if self._ragged_ok:
            batch["lengths"] = torch.from_numpy(lens).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits = self.model.prefill(self.params, batch, cache)
        _sync(dev)
        t1 = time.perf_counter()
        out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        uniform = (not self._ragged_ok) or bool((lens == lens[0]).all())
        for i in range(max_new_tokens):
            out[:, i] = nxt
            logits = self.model.decode(self.params, nxt, cache, uniform_pos=uniform,
                                       kv_bound=self._kv_bucket(max_len + i + 1))
            nxt = logits.argmax(dim=-1).to(torch.int32)
        result = out.cpu().numpy()        # waits for the last decode step
        decode_s = time.perf_counter() - t1
        return GenerationResult(
            tokens=result,
            prefill_s=t1 - t0,
            decode_s=decode_s,
            tokens_per_s=b * max_new_tokens / decode_s if decode_s > 0 else float("inf"),
            first_token_s=t1,
        )

    def _write_slot(self, cache: Dict[str, torch.Tensor], one: Dict[str, torch.Tensor],
                    slot: int) -> None:
        """Copy a batch-1 cache into slot ``slot`` of every cache tensor, in
        place (JAX scatters with a donated ``dynamic_update_slice``)."""
        for name, ax in self.model.CACHE_BATCH_AXIS.items():
            cache[name].select(ax, slot).copy_(one[name].select(ax, 0))

    @torch.no_grad()
    def serve_continuous(
        self,
        requests: List[ServeRequest],
        num_slots: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
    ) -> ContinuousStats:
        """Slot-based continuous batching on the dense cache.

        Every prompt is right-padded to one bucketed prefill length (the SSM
        family: left-padded to the longest prompt, and every slot then
        starts at that length).  At each decode-step boundary finished
        requests retire, then every free slot admits the next queued
        request: a batch-1 prefill whose cache is copied into the slot.
        One decode step then advances every slot (idle slots too; their
        output is ignored), each at its own position.  ``clock`` is injectable so tests measure deterministic
        timings: it stamps the requests and the run, read where the JAX
        engine reads it; ``prefill_s``/``decode_s`` are host wall times.
        Greedy tokens equal the JAX engine's on the same weights."""
        if not requests:
            return ContinuousStats([], 0, 0.0, 0, 0.0, 0.0)
        dev = self.device
        num_slots = num_slots or self.max_batch
        max_prompt = max(len(r.prompt) for r in requests)
        prefill_len = (bucket_pow2(max_prompt, floor=min(self.page_size, self.max_seq),
                                   cap=self.max_seq) if self._ragged_ok else max_prompt)
        # a left-padded slot starts at prefill_len, a right-padded one at
        # its prompt's length: the decode budget counts from there
        start = lambda r: len(r.prompt) if self._ragged_ok else prefill_len
        for r in requests:
            if start(r) + r.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"request {r.request_id}: prompt + generation exceeds max_seq"
                )
        pool = SlotPool(num_slots)
        cache = self.model.init_cache(num_slots, self.max_seq)
        # one reusable batch-1 cache for admission prefills: a prefill writes
        # only positions [0, prefill_len), so the rest stays zero (an SSM
        # prefill rewrites all of its state)
        cache1 = self.model.init_cache(1, self.max_seq)
        queue = deque(requests)
        nxt = np.zeros((num_slots,), np.int32)
        slot_tokens: Dict[int, List[int]] = {}
        slot_len: Dict[int, int] = {}             # live length (prompt + generated)
        admit_step: Dict[int, int] = {}
        ttft: Dict[int, float] = {}
        finished: Dict[int, RequestResult] = {}
        t_start = clock()
        submit_s = {r.request_id: t_start for r in requests}
        step = 0
        occupancy_sum = 0
        prefill_s = decode_s = 0.0
        prefill_tokens = 0
        while queue or pool.num_active:
            # retire sequences that already hold all their tokens, so their
            # slots are free for admission at this same step boundary
            for slot in list(pool.active):
                req = pool.active[slot]
                if len(slot_tokens[slot]) >= req.max_new_tokens:
                    now = clock()
                    latency = now - submit_s[req.request_id]
                    finished[req.request_id] = RequestResult(
                        request_id=req.request_id,
                        tokens=np.asarray(slot_tokens.pop(slot), np.int32),
                        slot=slot,
                        admit_step=admit_step.pop(slot),
                        finish_step=step,
                        ttft_s=ttft.pop(slot),
                        latency_s=latency,
                        tokens_per_s=(
                            req.max_new_tokens / latency if latency > 0 else float("inf")
                        ),
                    )
                    pool.release(slot)
                    slot_len.pop(slot, None)
            # admission at the decode-step boundary: fill every free slot
            while queue and pool.num_free:
                req = queue.popleft()
                slot = pool.admit(req, step=step)
                padded = np.zeros((1, prefill_len), np.int32)
                if self._ragged_ok:
                    padded[0, : len(req.prompt)] = req.prompt
                else:
                    padded[0, prefill_len - len(req.prompt):] = req.prompt
                batch1 = {"tokens": torch.from_numpy(padded).to(dev)}
                if self._ragged_ok:
                    batch1["lengths"] = torch.tensor([len(req.prompt)], dtype=torch.int32,
                                                     device=dev)
                t0 = time.perf_counter()
                logits1 = self.model.prefill(self.params, batch1, cache1)
                tok0 = int(logits1[0].argmax())            # the sync
                prefill_s += time.perf_counter() - t0
                prefill_tokens += len(req.prompt)
                self._write_slot(cache, cache1, slot)
                nxt[slot] = tok0
                slot_tokens[slot] = [tok0]
                slot_len[slot] = start(req)
                admit_step[slot] = step
                ttft[slot] = clock() - submit_s[req.request_id]
            if not pool.num_active:
                if queue:
                    continue            # freshly-retired slots admit the queue
                break
            if all(len(slot_tokens[s]) >= pool.active[s].max_new_tokens
                   for s in pool.active):
                continue  # every active slot is at budget: retire, don't decode
            # one decode step for the whole pool (idle slots are ignored);
            # the kv bound tracks the longest live slot, not padded max_seq
            t0 = time.perf_counter()
            logits = self.model.decode(
                self.params, torch.from_numpy(nxt).to(dev), cache, uniform_pos=False,
                kv_bound=self._kv_bucket(max(slot_len.values()) + 1),
            )
            tokens_all = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()   # the sync
            decode_s += time.perf_counter() - t0
            step += 1
            occupancy_sum += pool.num_active
            for slot in pool.active:
                if len(slot_tokens[slot]) < pool.active[slot].max_new_tokens:
                    slot_tokens[slot].append(int(tokens_all[slot]))
                    nxt[slot] = tokens_all[slot]
                    slot_len[slot] += 1
        _sync(dev)
        wall = clock() - t_start
        results = [finished[r.request_id] for r in requests]
        total_tokens = sum(len(r.tokens) for r in results)
        return ContinuousStats(
            results=results,
            steps=step,
            wall_s=wall,
            total_tokens=total_tokens,
            throughput_tps=total_tokens / wall if wall > 0 else float("inf"),
            mean_slot_occupancy=occupancy_sum / step if step else float(num_slots),
            prefill_s=prefill_s,
            prefill_tokens=prefill_tokens,
            decode_s=decode_s,
        )

    # -- paged engine ---------------------------------------------------------------
    def _paged_decode_step(self, nxt: torch.Tensor, cache, table: torch.Tensor,
                           pos: torch.Tensor, mask: torch.Tensor,
                           pages_bound: int) -> torch.Tensor:
        """One fused paged decode step: attention + on-device argmax + the
        device-resident next-token / position bump for masked rows (in place
        on the mirrors).  Returns the (b,) int32 greedy tokens, still on the
        device: fetching them is the boundary's only host sync."""
        logits = self.model.decode_paged(
            self.params, nxt, cache, table, pos, pages_bound=pages_bound
        )
        tok = logits.argmax(dim=-1).to(torch.int32)
        nxt.copy_(torch.where(mask, tok, nxt))
        pos.copy_(torch.where(mask, pos + 1, pos))
        return tok

    def _spec_decode_step(self, win: np.ndarray, wlens: np.ndarray, cache,
                          table: torch.Tensor, pos: torch.Tensor, nxt: torch.Tensor,
                          pages_bound: int) -> Tuple[np.ndarray, np.ndarray]:
        """One fused verify step over every slot's ``[next_token, drafts]``
        window (``win`` (b, W), ``wlens`` (b,) real tokens, 0 for idle rows):
        attention, greedy argmax and acceptance on the device.  Draft ``j``
        survives iff it equals the greedy choice after position ``j - 1`` and
        every earlier draft survived (cumulative product); positions advance
        by ``accepted + 1`` and the next-token mirror to the last emitted
        token, in place.  Returns the host's (greedy (b, W), accepted (b,))
        from one fetch; the emitted tokens ``greedy[:, :accepted + 1]`` are
        those a run of one-token decode steps gives."""
        W = win.shape[1]
        up = _upload({"win": win, "wlens": wlens}, self.device)
        win_d, wl = up["win"], up["wlens"]
        logits = self.model.decode_spec(
            self.params, win_d, cache, table, pos, wl, pages_bound=pages_bound
        )
        greedy = logits.argmax(dim=-1).to(torch.int32)                   # (b, W)
        drafts = torch.arange(1, W, device=self.device)[None, :] < wl[:, None]
        match = (win_d[:, 1:] == greedy[:, :-1]) & drafts
        n_accept = match.to(torch.int32).cumprod(dim=1).sum(dim=1).to(torch.int32)
        active = wl > 0
        pos.copy_(torch.where(active, pos + n_accept + 1, pos))
        last = greedy.gather(1, n_accept.long()[:, None])[:, 0]
        nxt.copy_(torch.where(active, last, nxt))
        out = torch.cat([greedy, n_accept[:, None]], dim=1).cpu().numpy()  # the sync
        return out[:, :W], out[:, W]

    @torch.no_grad()
    def serve_paged(
        self,
        requests: List[ServeRequest],
        num_slots: Optional[int] = None,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        prefill_budget: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
        tracer=None,
        spec_k: int = 0,
        spec_ngram: int = 3,
    ) -> PagedStats:
        """Paged-KV continuous batching with packed varlen prefill.

        A request enters when a slot and its prompt's pages are free AND the
        pool's committed worst-case pages stay within capacity, so growth
        can never fail.  Each boundary retires finished requests, admits,
        runs one packed prefill launch of ``prefill_budget`` tokens (default
        16 pages) over every prefilling slot's next span, grows tables that
        cross a page, and runs one fused decode step over the pool.  Greedy
        tokens equal the JAX engine's on the same weights.

        ``spec_k > 0`` drafts up to ``spec_k`` tokens per slot by matching
        the last ``spec_ngram`` tokens against the request's prompt and
        output; a boundary with a draft anywhere runs one verify step of
        window ``spec_k + 1`` (slots without a draft verify just their next
        token), one with none the plain decode step.  Tokens equal the
        non-speculative run's; ``spec_stats`` holds the draft ledger."""
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if not requests:
            return PagedStats([], 0, 0.0, 0, 0.0, 0.0, 0, self.page_size, 0,
                              0.0, 0, 0, 0, kv_dtype=self._kv_dtype_name())
        dev = self.device
        page_size = page_size or self.page_size
        num_slots = num_slots or self.max_batch
        # packed-buffer size: the per-boundary prefill token budget, snapped
        # to a page multiple (chunk spans inside the buffer are page-aligned)
        t_pack = max(page_size, ((prefill_budget or 16 * page_size) // page_size) * page_size)
        budget = PrefillBudget(t_pack)
        max_pages_per_seq = pages_needed(self.max_seq, page_size)
        if num_pages is None:
            num_pages = num_slots * max_pages_per_seq + 1
        pool = PagePool(num_pages, page_size, reserved=1)
        for r in requests:
            if len(r.prompt) + r.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"request {r.request_id}: prompt + generation exceeds max_seq"
                )
            if pool.pages_needed(len(r.prompt) + r.max_new_tokens) > pool.capacity:
                raise ValueError(
                    f"request {r.request_id}: needs more pages than the pool admits"
                )
        slots = PagedSlotPool(num_slots, pool, tracer=tracer, clock=clock)
        table = PageTable(num_slots, max_pages_per_seq, scratch_page=0)
        cache = self.model.init_paged_cache(num_pages, page_size, self.kv_dtype)
        spec = spec_k > 0
        ledger = SpecLedger() if spec else None
        queue = deque(requests)
        nxt = np.zeros((num_slots,), np.int32)
        lengths = np.zeros((num_slots,), np.int32)   # live tokens per slot
        slot_tokens: Dict[int, List[int]] = {}
        slot_times: Dict[int, List[float]] = {}      # token-emission clocks
        slot_commit: Dict[int, int] = {}             # worst-case pages per slot
        prefilling: Dict[int, int] = {}              # slot -> next chunk start
        decoding: Set[int] = set()
        admit_order: Dict[int, int] = {}             # slot -> admission sequence
        admit_step: Dict[int, int] = {}
        ttft: Dict[int, float] = {}
        admit_seq = 0
        finished: Dict[int, RequestResult] = {}
        t_start = clock()
        submit_s = {r.request_id: t_start for r in requests}
        step = 0
        occupancy_sum = 0
        peak_occupancy = 0
        pages_sum = 0.0
        samples = 0
        chunks_done = 0
        prefill_launches = 0
        prefill_s = 0.0
        prefill_tokens = 0
        prefill_padded = 0
        prompt_admitted = 0
        decode_s = 0.0
        itl_all: List[float] = []
        # device-resident decode state, patched only for slots that changed
        dev_table = torch.zeros((num_slots, max_pages_per_seq), dtype=torch.int32, device=dev)
        dev_pos = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        dev_nxt = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        dev_mask = torch.zeros((num_slots,), dtype=torch.bool, device=dev)
        cur_mask = np.zeros((num_slots,), bool)
        dirty: Set[int] = set()

        def sync_device(active: List[int]) -> None:
            """Patch the device mirrors for slots whose table row, position,
            next token or active bit changed since the last launch: one
            upload of the dirty rows, then in-place row writes (JAX donates
            the mirrors to a jitted scatter instead).  Inactive rows point
            at the scratch page."""
            nonlocal cur_mask
            new_mask = np.zeros((num_slots,), bool)
            new_mask[active] = True
            stale = dirty | set(np.nonzero(new_mask != cur_mask)[0].tolist())
            if not stale:
                return
            idx = np.fromiter(sorted(stale), np.int64, len(stale))
            on = new_mask[idx]
            up = _upload({
                "rows": np.where(on[:, None], table.table[idx], 0),
                "pos": np.where(on, lengths[idx], 0),
                "nxt": np.where(on, nxt[idx], 0),
                "mask": on,
                "idx": idx,
            }, dev)
            i = up["idx"].long()
            dev_table[i] = up["rows"]
            dev_pos[i] = up["pos"]
            dev_nxt[i] = up["nxt"]
            dev_mask[i] = up["mask"].bool()
            cur_mask = new_mask
            dirty.clear()

        def release_slot(slot: int) -> None:
            slots.release_paged(slot, table.clear(slot))
            lengths[slot] = 0
            for d in (slot_tokens, slot_times, prefilling, admit_order,
                      slot_commit, admit_step, ttft):
                d.pop(slot, None)
            decoding.discard(slot)
            dirty.add(slot)

        while queue or slots.num_active:
            progressed = False
            # 1) retire finished sequences, returning their pages
            for slot in list(decoding):
                req = slots.active[slot]
                if len(slot_tokens[slot]) >= req.max_new_tokens:
                    now = clock()
                    times = slot_times.get(slot, [])
                    itls = [b - a for a, b in zip(times, times[1:])]
                    itl_all.extend(itls)
                    prop, acc = ledger.of(req.request_id) if spec else (0, 0)
                    latency = now - submit_s[req.request_id]
                    finished[req.request_id] = RequestResult(
                        request_id=req.request_id,
                        tokens=np.asarray(slot_tokens[slot], np.int32),
                        slot=slot,
                        admit_step=admit_step[slot],
                        finish_step=step,
                        ttft_s=ttft[slot],
                        latency_s=latency,
                        tokens_per_s=(
                            req.max_new_tokens / latency if latency > 0 else float("inf")
                        ),
                        itl_p50_s=percentile(itls, 50.0) if itls else 0.0,
                        itl_p99_s=percentile(itls, 99.0) if itls else 0.0,
                        draft_proposed=prop,
                        draft_accepted=acc,
                    )
                    release_slot(slot)
                    progressed = True
            # 2) admission keyed on free pages and worst-case commitment
            while queue:
                req = queue[0]
                npages = pool.pages_needed(len(req.prompt))
                worst = pool.pages_needed(len(req.prompt) + req.max_new_tokens)
                if not slots.num_free:
                    break
                if sum(slot_commit.values()) + worst > pool.capacity:
                    break
                if pool.num_free < npages:
                    break
                queue.popleft()
                slot, pages = slots.admit_paged(req, npages, step=step)
                table.assign(slot, pages)
                slot_tokens[slot] = []
                slot_commit[slot] = worst
                prompt_admitted += len(req.prompt)
                admit_order[slot] = admit_seq
                admit_seq += 1
                admit_step[slot] = step
                lengths[slot] = 0
                prefilling[slot] = 0
                progressed = True
            # 3) packed prefill: every prefilling slot's next span in ONE
            #    token-packed launch (oldest first, capped by the budget)
            if prefilling:
                t0p = clock()
                budget.begin_step()
                spans: List[Tuple[int, int, int, int]] = []
                used = 0
                for slot in sorted(prefilling, key=lambda s: admit_order[s]):
                    req = slots.active[slot]
                    rem = len(req.prompt) - prefilling[slot]
                    if used >= t_pack:
                        budget.defer(rem)   # left waiting: starvation signal
                        continue
                    take = budget.grant(min(rem, t_pack - used))
                    if take <= 0:
                        budget.defer(rem)
                        continue
                    if take < rem:
                        budget.defer(rem - take)
                    span = pages_needed(take, page_size) * page_size
                    spans.append((slot, prefilling[slot], take, span))
                    used += span
                if spans:
                    num_chunks = num_slots
                    tokens_p = np.zeros((1, t_pack), np.int32)
                    tok_pos = np.zeros((t_pack,), np.int32)
                    # buffer-tail pads write their K/V into the scratch page;
                    # offsets cycle so the writes spread over its rows
                    dst_page = np.zeros((t_pack,), np.int32)
                    dst_off = (np.arange(t_pack) % page_size).astype(np.int32)
                    cu = np.zeros((num_chunks + 1,), np.int32)
                    lens_c = np.zeros((num_chunks,), np.int32)
                    pos0_c = np.zeros((num_chunks,), np.int32)
                    last_idx = np.zeros((num_chunks,), np.int32)
                    tables_c = np.zeros((num_chunks, max_pages_per_seq), np.int32)
                    off = 0
                    for ci, (slot, start, take, span) in enumerate(spans):
                        req = slots.active[slot]
                        tokens_p[0, off : off + take] = req.prompt[start : start + take]
                        pos = start + np.arange(span, dtype=np.int32)
                        tok_pos[off : off + span] = pos
                        row = table.table[slot]
                        # chunk-pad K/V lands inside the prompt's allocated
                        # pages, length-masked until decode overwrites it
                        dst_page[off : off + span] = row[pos // page_size]
                        dst_off[off : off + span] = pos % page_size
                        cu[ci + 1] = off + span
                        lens_c[ci] = take
                        pos0_c[ci] = start
                        last_idx[ci] = off + take - 1
                        tables_c[ci] = row
                        off += span
                    cu[len(spans) + 1 :] = off
                    # bound on committed-context pages this launch, pow2-
                    # bucketed as in the JAX engine
                    ctx_pages = max(pages_needed(start, page_size) for _, start, _, _ in spans)
                    bound = bucket_pow2(max(ctx_pages, 1), cap=max_pages_per_seq)
                    batch = _upload({
                        "tokens": tokens_p, "tok_pos": tok_pos,
                        "dst_page": dst_page, "dst_off": dst_off,
                        "cu_seqlens": cu, "chunk_lens": lens_c,
                        "chunk_pos0": pos0_c, "page_tables": tables_c,
                        "last_idx": last_idx,
                    }, dev)
                    logits = self.model.prefill_packed(
                        self.params, batch, cache, pages_bound=bound
                    )
                    first_tok = logits.argmax(dim=-1).cpu().numpy()  # the sync
                    for ci, (slot, start, take, span) in enumerate(spans):
                        req = slots.active[slot]
                        new_start = start + take
                        lengths[slot] = new_start
                        chunks_done += 1
                        if new_start >= len(req.prompt):
                            del prefilling[slot]
                            tok0 = int(first_tok[ci])
                            nxt[slot] = tok0
                            slot_tokens[slot] = [tok0]
                            decoding.add(slot)
                            dirty.add(slot)
                            tnow = clock()
                            slot_times[slot] = [tnow]
                            ttft[slot] = tnow - submit_s[req.request_id]
                        else:
                            prefilling[slot] = new_start
                    real = sum(s[2] for s in spans)
                    prefill_launches += 1
                    prefill_tokens += real
                    prefill_padded += t_pack - real
                    now = clock()
                    prefill_s += now - t0p
                    if tracer is not None:
                        tracer.event(
                            "prefill:packed", t0p, now,
                            tokens=real, padding=t_pack - real,
                            chunks=len(spans), buffer=t_pack,
                            budget=budget.tokens_per_step,
                        )
                    progressed = True
            # 4) one decode step over the whole pool.  With ``spec_k > 0``
            #    the drafter proposes up to ``spec_k`` tokens per slot and
            #    ONE verify step scores every slot's window; a boundary with
            #    no draft anywhere runs the plain decode step.  Rows whose
            #    next token or window opens a page grow their table first
            #    (never fails: admission committed worst-case pages, and a
            #    draft never reaches past prompt + max_new_tokens)
            active_dec = [
                s for s in decoding
                if len(slot_tokens[s]) < slots.active[s].max_new_tokens
            ]
            drafts: Dict[int, List[int]] = {}
            if spec:
                for s in active_dec:
                    req = slots.active[s]
                    rem = req.max_new_tokens - len(slot_tokens[s])
                    # a boundary emits accepted + 1 tokens: never draft past
                    # the request's token budget or max_seq
                    cap = min(spec_k, rem - 1, self.max_seq - int(lengths[s]) - 1)
                    if cap > 0:
                        ctx = np.concatenate([req.prompt, np.asarray(slot_tokens[s], np.int32)])
                        drafts[s] = ngram_propose(ctx, spec_ngram, cap)
            for s in sorted(active_dec, key=lambda s: admit_order[s]):
                while table.num_pages_of(s) * page_size <= int(lengths[s]) + len(drafts.get(s, ())):
                    grown = slots.grow(1)
                    if grown is None:
                        raise RuntimeError("page pool exhausted despite admission commitment")
                    table.append(s, grown[0])
                    dirty.add(s)
            if active_dec:
                t0d = clock()
                use_spec = spec and any(drafts.get(s) for s in active_dec)
                sync_device(active_dec)
                live = max(int(lengths[s]) + 1 + len(drafts.get(s, ())) for s in active_dec)
                bound = bucket_pow2(pages_needed(live, page_size), cap=max_pages_per_seq)
                if use_spec:
                    W = spec_k + 1
                    win = np.zeros((num_slots, W), np.int32)
                    wlens_h = np.zeros((num_slots,), np.int32)
                    for s in active_dec:
                        d = drafts.get(s, [])
                        win[s, 0] = nxt[s]
                        win[s, 1 : 1 + len(d)] = d
                        wlens_h[s] = 1 + len(d)
                    g, na = self._spec_decode_step(
                        win, wlens_h, cache, dev_table, dev_pos, dev_nxt, bound
                    )
                else:
                    tok = self._paged_decode_step(
                        dev_nxt, cache, dev_table, dev_pos, dev_mask, bound
                    )
                    g = tok.cpu().numpy()[:, None]     # the boundary's one fetch
                    na = np.zeros((num_slots,), np.int32)
                now = clock()
                decode_s += now - t0d
                step += 1
                occupancy_sum += slots.num_active
                for s in active_dec:
                    a = int(na[s])
                    emitted = g[s, : a + 1]
                    slot_tokens[s].extend(int(t) for t in emitted)
                    nxt[s] = int(emitted[-1])
                    lengths[s] += a + 1
                    slot_times[s].extend([now] * (a + 1))
                    if spec:
                        ledger.record(slots.active[s].request_id, len(drafts.get(s, ())), a)
                        # rollback: the length is already the committed
                        # prefix; a rejected suffix that opened a page hands
                        # it back to the pool
                        freed = table.truncate(s, pages_needed(int(lengths[s]), page_size))
                        if freed:
                            pool.free(freed)
                            ledger.record_rollback(len(freed))
                            dirty.add(s)
                if spec:
                    ledger.record_launch(use_spec)
                progressed = True
            peak_occupancy = max(peak_occupancy, slots.num_active)
            pages_sum += pool.num_in_use
            samples += 1
            slots.record_occupancy(step)
            if not progressed and not prefilling and not decoding:
                raise RuntimeError("paged serve loop stalled (admission deadlock)")
        _sync(dev)
        wall = clock() - t_start
        results = [finished[r.request_id] for r in requests]
        total_tokens = sum(len(r.tokens) for r in results)
        return PagedStats(
            results=results,
            steps=step,
            wall_s=wall,
            total_tokens=total_tokens,
            throughput_tps=total_tokens / wall if wall > 0 else float("inf"),
            mean_slot_occupancy=occupancy_sum / step if step else 0.0,
            peak_slot_occupancy=peak_occupancy,
            page_size=page_size,
            num_pages=pool.capacity,
            mean_pages_in_use=pages_sum / samples if samples else 0.0,
            peak_pages_in_use=pool.peak_in_use,
            preemptions=slots.preemptions,
            prefill_chunks=chunks_done,
            prefill_launches=prefill_launches,
            prefill_s=prefill_s,
            prefill_tokens=prefill_tokens,
            prefill_padded_tokens=prefill_padded,
            prefill_budget=t_pack,
            prefill_budget_stats=budget.stats(),
            prompt_tokens_admitted=prompt_admitted,
            decode_s=decode_s,
            spec_k=spec_k,
            spec_stats=ledger.stats() if spec else {},
            itl_p50_ms=percentile(itl_all, 50.0) * 1e3 if itl_all else 0.0,
            itl_p99_ms=percentile(itl_all, 99.0) * 1e3 if itl_all else 0.0,
            kv_dtype=self._kv_dtype_name(),
            kv_bytes_per_token=float(
                sum(v.numel() * v.element_size() for v in cache.values())
                / (num_pages * page_size)
            ),
        )
