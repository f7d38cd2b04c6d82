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
(Mamba-2) and the hybrid family (zamba2) run the same two engines on their
caches of per-layer states (and, hybrid, the shared attention's K/V, a
ring past 64k tokens), with the reference's exact-length shapes: every
batch or admission is LEFT-padded to the longest prompt of its set, with
no bucket and no lengths (the pads flow through the state, so the shapes
must be the reference's for its tokens), and decodes with no bound on the
live lengths (a ring's live keys wrap the whole buffer); ``generate``
decodes them at one shared position.

``ServingEngine.serve_paged`` is paged-KV continuous batching: a global pool
of ``page_size``-token pages plus per-slot page tables; admission is keyed
on free pages and on the pool's worst-case commitment (every active
request's ``prompt + max_new_tokens``) times ``overcommit``; above 1 a dry
pool preempts the lowest-priority youngest request.  At each boundary every
prefilling slot's next span is packed into ONE token-packed varlen-prefill
launch of ``prefill_budget`` tokens (oldest request first, capped by the
:class:`PrefillBudget` ledger), or with ``prefill_mode="chunked"`` each
prefilling slot runs one batch-1 chunk; then one fused decode step runs
over the whole slot pool.  The prefix cache shares full prompt pages
across requests, with copy-on-write before any append into a shared page;
tenants, priorities and a deadline steer admission.

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

The encoder-decoder family (whisper) runs ``generate`` alone, with its
encoder frames passed as ``extra_inputs``; ``serve_continuous`` and
``serve_paged`` refuse it, as the reference does (an admission prefill
would need each request's frames).

``serve_paged`` takes the fleet's boundary hook and live KV migration:
``fault_hook`` runs once a boundary (faults, leases, drains), and a
:class:`~repro_torch.serve.faults.WorkerCrash` leaves it carrying the
finished results and the pending requests; ``checkpoint_every`` snapshots
each decoding slot's pages (``ops.export_pages`` to host tensors, with
per-page checksums) and ``restores`` admits a request from a snapshot
(``ops.import_pages``) instead of prefilling it.

Tensor parallelism (``ServingEngine(..., rules=serve_rules(mesh))``, one
engine on each rank of a world that :mod:`repro_torch.launch.mesh`
starts): ``tp`` is the effective degree (:func:`~repro_torch.sharding.
specs.tp_degree`: 1 where the head counts do not split, and then every
rank serves the whole model).  Above 1 the engine holds this rank's
weight shards, its ``kv_heads / tp`` heads of every page, and runs each
launch under the rules, so the model's row-parallel products close with
collectives (:mod:`repro_torch.sharding.comm`).  The page pool, tables,
prefix cache and admission stay host-global and identical on every rank:
a fixed page budget a rank carries ``tp`` times the tokens.  Rank 0
traces, with one analytic ``tp:collective`` event a launch (the
reference's formula); the tokens of every rank are held against rank 0's
at the end of a run.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..core.analysis import percentile
from ..device import resolve_device
from ..kernels import kvquant, ops
from ..models.lm import NOT_PAGED_ENCDEC, DecoderLM, EncDecLM
from ..sharding import comm
from ..sharding.specs import (
    ShardingRules, leaf_split, set_activation_rules, shard_params, tp_degree,
)
from .faults import FaultContext, WorkerCrash, WorkerDrain
from .page_table import (
    PagePool, PageSnapshot, PageTable, PrefixCache, page_checksums, pages_needed,
)
from .scheduler import (
    PagedSlotPool, PrefillBudget, SlotPool, SpecLedger, TenantLedger, TenantSpec,
)


# the reference's refusal of continuous batching for an encoder-decoder model
NOT_CONTINUOUS_ENCDEC = ("continuous batching does not support encoder-decoder models: "
                         "admission prefill would need per-request encoder frames")


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
    # multi-tenant serving: tenant, priority tier and latency SLO (the
    # defaults leave single-tenant callers as they were)
    tenant: str = "default"
    priority: int = 1
    slo_ms: float = 0.0


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
    status: str = "completed"   # or "rejected" (deadline, SLO shed)
    draft_proposed: int = 0     # speculative drafts proposed for this request
    draft_accepted: int = 0
    reason: str = ""            # why a request was rejected
    tenant: str = "default"
    priority: int = 1
    within_deadline: bool = True  # a late completion falls out of goodput


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
    prompt_tokens_admitted: int = 0   # per admission (re-admissions count again)
    saved_prefill_tokens: int = 0     # prompt tokens served from cached pages
    prefill_tokens_dropped: int = 0   # admitted, then preempted before prefill
    prefix_cache: bool = False
    cow_copies: int = 0         # shared pages split by copy-on-write
    cache_evictions: int = 0    # cached-unreferenced pages reclaimed
    prefix_stats: Dict[str, float] = field(default_factory=dict)  # PrefixCache.stats()
    decode_s: float = 0.0       # wall time spent inside decode launches
    spec_k: int = 0             # draft depth (0 = speculation off)
    spec_stats: Dict[str, float] = field(default_factory=dict)  # SpecLedger.stats()
    itl_p50_ms: float = 0.0     # inter-token latency over every gap in the run
    itl_p99_ms: float = 0.0
    kv_dtype: str = "float32"   # pool storage (int8/fp8: codes + f32 scales)
    kv_bytes_per_token: float = 0.0  # pool bytes per token, all layers
    # SLO / multi-tenant admission
    completed: int = 0          # terminal completed
    rejected: int = 0           # terminal rejected (deadline, SLO shed)
    deferred: int = 0           # tenant-boundary deferrals (a bucket ran dry)
    goodput: float = 1.0        # completed within the deadline / submitted
    deadline_ms: float = 0.0    # the run's TTL (0 = none)
    # live KV migration (checkpoint / restore)
    checkpoints_saved: int = 0  # slot snapshots taken this run
    checkpoint_bytes: int = 0   # bytes gathered into snapshots
    restored_requests: int = 0  # requests resumed from a snapshot
    restored_tokens: int = 0    # KV positions restored without recompute
    restore_bytes: int = 0      # bytes scattered back into the pool
    checksum_failures: int = 0  # snapshots rejected by verify, replayed
    tp: int = 1                 # effective tensor-parallel degree


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


# the logical axes the model's tensor-parallel paths take for split
_TP_AXES = {"vocab", "heads", "kv", "ffn", "experts"}


def _meta(defs):
    """A def tree's leaves as tensors on the meta device (shapes only)."""
    from ..models.params import tree_map_defs

    return tree_map_defs(lambda path, p: torch.empty(p.shape, device="meta"), defs)


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_shapes(v) for v in tree]
    return tuple(tree.shape)


def _sync(device: torch.device) -> None:
    """Wait for the card (a host clock read after it times finished work)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    def __init__(
        self,
        model: Union[DecoderLM, EncDecLM],
        params,
        max_batch: int,
        max_seq: int,
        page_size: int = 16,
        device: Union[str, torch.device, None] = None,
        kv_dtype: Optional[str] = None,
        rules: Optional[ShardingRules] = None,
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
        # tensor parallelism: ``tp`` is the EFFECTIVE degree, 1 where the
        # head counts do not divide the model axis (every rank then serves
        # the whole model, no collective); above 1 the launches run under
        # the rules and the engine keeps this rank's shards
        self.rules = rules
        cfg = model.cfg
        self.tp = tp_degree(rules, cfg.num_heads, cfg.num_kv_heads)
        self._tp_rules = rules if self.tp > 1 else None
        if self._tp_rules is not None:
            params = self._rank_shards(params)
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        # tokens per KV page
        self.page_size = page_size
        # right-padded ragged prefill (and kv-bounded decode) is exact only
        # for pure-attention caches; ssm/hybrid state scans absorb pads and
        # the hybrid ring cache wraps, so those keep exact-length,
        # left-padded shapes
        self._ragged_ok = not model.stateful

    def _paged_only(self, what: str) -> None:
        """Tensor parallelism serves the paged engine only, as in the
        reference (its driver refuses ``--tp`` elsewhere): the dense-cache
        engines of a sharded engine raise."""
        if self._tp_rules is not None:
            raise NotImplementedError(f"{what}: tensor parallelism (tp {self.tp}) serves the "
                                      f"paged engine only (serve_paged)")

    def _rank_shards(self, params):
        """This rank's shards of ``params``: a full tree (``init`` or
        ``from_jax``) is cut with ``shard_params``; a tree of this rank's
        shards (``init(rules=...)``) is kept; any other tree raises.  So
        does a leaf of a tensor-parallel axis (vocab, ffn, experts) that
        the rules leave whole: under the rules the model takes every such
        leaf for a shard (:mod:`repro_torch.models.modules`)."""
        import torch.distributed as dist

        from ..models.params import tree_map_defs

        if self.model.cfg.family not in ("dense", "moe") or self.model.stateful:
            raise NotImplementedError(f"{self.model.cfg.name}: tensor parallelism serves the "
                                      f"paged dense and MoE families only")
        defs = self.model.param_defs()
        whole = []

        def check(path, p):
            if set(p.axes or ()) & _TP_AXES and leaf_split(self._tp_rules, p, path) is None:
                whole.append(path)

        tree_map_defs(check, defs)
        if whole:
            raise NotImplementedError(f"{self.model.cfg.name} at tp {self.tp}: {whole[0]} does "
                                      f"not divide the model axis (the engine splits every "
                                      f"vocab, ffn and experts leaf)")
        group = comm.group_of(self._tp_rules)
        if group is None:
            raise ValueError("tensor parallelism needs a DeviceMesh over a process group "
                             "(repro_torch.launch.mesh.make_host_mesh inside run_ranks)")
        rank = dist.get_rank(group)
        meta = _meta(defs)
        if _tree_shapes(params) == _tree_shapes(meta):
            return shard_params(params, self._tp_rules, rank, defs=defs)
        if _tree_shapes(params) != _tree_shapes(shard_params(meta, self._tp_rules, rank,
                                                             defs=defs)):
            raise ValueError(f"params are neither the full tree nor rank {rank}'s shards "
                             f"under these rules")
        return params

    @torch.no_grad()
    def prompt_logits(self, prompt: np.ndarray) -> torch.Tensor:
        """Float32 last-token logits (V,) of ``prompt``: one chunked-prefill
        launch (``prefill_paged_chunk``, the prompt padded to whole pages)
        into a fresh pool of this engine's page size and ``kv_dtype``; at
        an effective tp above 1 under the rules, so every rank returns the
        whole vocabulary's logits."""
        n, ps = len(prompt), self.page_size
        pages = pages_needed(n, ps)
        cache = self.model.init_paged_cache(pages + 1, ps, self.kv_dtype, tp=self.tp)
        row = torch.arange(1, pages + 1, dtype=torch.int32, device=self.device)
        chunk = np.zeros((1, pages * ps), np.int32)
        chunk[0, :n] = prompt
        with set_activation_rules(self._tp_rules):
            logits = self.model.prefill_paged_chunk(
                self.params, torch.from_numpy(chunk).to(self.device), cache, row, n - 1, 0)
        return logits[0]

    def _kv_dtype_name(self) -> str:
        return self.kv_dtype or str(self.model.dtype).replace("torch.", "")

    # -- dense-cache engines ------------------------------------------------------
    def _kv_bucket(self, live_len: int) -> Optional[int]:
        """The decode bound on live lengths: a power-of-two multiple of the
        page size (or ``max_seq``), at most ``max_seq``; None (no bound) for
        the SSM family, whose cache has no sequence axis, and the hybrid
        family, whose ring's live keys wrap the whole buffer."""
        if not self._ragged_ok:
            return None
        return bucket_pow2(live_len, floor=min(self.page_size, self.max_seq), cap=self.max_seq)

    def _pad_prompts(self, prompts: List[np.ndarray],
                     max_new_tokens: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Pad a prompt batch to one prefill length.  Attention families
        right-pad to a power-of-two bucket floored at the page size: causal
        attention never reads the trailing pads and the model takes the
        logits at ``lengths - 1``.  The SSM and hybrid families left-pad to
        the exact longest prompt, so every row's last token sits at the end.
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
    def generate(self, prompts: List[np.ndarray], max_new_tokens: int,
                 extra_inputs: Optional[Dict[str, Any]] = None,
                 greedy: bool = True) -> GenerationResult:
        """Static batched greedy generation: one prefill of the padded batch
        into a fresh dense cache, then ``max_new_tokens`` decode steps in
        lockstep (the last one's token is not kept, as in the JAX engine).
        Rows of one length, and the left-padded rows of the SSM and hybrid
        families, decode at one shared position; a ragged attention batch writes each
        row at its own.  ``extra_inputs`` adds arrays (numpy or tensors) to
        the prefill's batch, each moved to the engine's device: the
        enc-dec family's ``frames`` (b, encoder_seq, D), in the model's
        dtype.  The tokens stay on the device until the end: the
        loop never waits for the card.  ``greedy`` is accepted and ignored,
        as the JAX engine ignores it: decoding is always greedy.  An engine
        holding tensor-parallel shards raises (:meth:`_paged_only`)."""
        self._paged_only("generate")
        dev = self.device
        tokens, lens = self._pad_prompts(prompts, max_new_tokens)
        b = tokens.shape[0]
        max_len = int(lens.max())
        cache = self.model.init_cache(b, self.max_seq)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if self._ragged_ok:
            batch["lengths"] = torch.from_numpy(lens).to(dev)
        for name, value in (extra_inputs or {}).items():
            t = torch.as_tensor(value)
            batch[name] = t.to(dev, dtype=self.model.dtype) if name == "frames" else t.to(dev)
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
        and hybrid families: left-padded to the longest prompt, and every
        slot then starts at that length).  At each decode-step boundary finished
        requests retire, then every free slot admits the next queued
        request: a batch-1 prefill whose cache is copied into the slot.
        One decode step then advances every slot (idle slots too; their
        output is ignored), each at its own position.  ``clock`` is injectable so tests measure deterministic
        timings: it stamps the requests and the run, read where the JAX
        engine reads it; ``prefill_s``/``decode_s`` are host wall times.
        Greedy tokens equal the JAX engine's on the same weights."""
        self._paged_only("serve_continuous")
        if not requests:
            return ContinuousStats([], 0, 0.0, 0, 0.0, 0.0)
        if self.model.cfg.family == "encdec":
            raise NotImplementedError(NOT_CONTINUOUS_ENCDEC)
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
        # only positions [0, prefill_len), so the rest stays zero (an SSM or
        # hybrid prefill rewrites all of its state; a hybrid ring shorter
        # than the prompt, all of its K/V)
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
        prefill_chunk: Optional[int] = None,
        overcommit: float = 1.0,
        prefill_mode: str = "packed",
        prefill_budget: Optional[int] = None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        prefix_cache: bool = False,
        clock: Callable[[], float] = time.perf_counter,
        tracer=None,
        fault_hook: Optional[Callable] = None,
        deadline_ms: float = 0.0,
        tenants: Optional[List[TenantSpec]] = None,
        fairness: bool = True,
        checkpoint_every: int = 0,
        checkpoints: Optional[Dict[int, PageSnapshot]] = None,
        restores: Optional[Dict[int, PageSnapshot]] = None,
    ) -> PagedStats:
        """Paged-KV continuous batching.

        A request enters when a slot and its prompt's pages are free AND the
        pool's committed worst-case pages (every active request's ``prompt +
        max_new_tokens``) stay within ``capacity * overcommit``: at the
        default 1.0 growth never fails and nothing is preempted.  Above 1 the
        pool may run dry at a decode step; the lowest-priority youngest
        request is then preempted (its pages freed, the request put back at
        the front of the queue to be prefilled again).

        Each boundary retires finished requests, admits, prefills, grows
        tables that cross a page and runs one fused decode step over the
        pool.  ``prefill_mode="packed"`` packs every prefilling slot's next
        span into ONE varlen-prefill launch of ``prefill_budget`` tokens
        (default 4 chunks), oldest request first; ``"chunked"`` runs one
        batch-1 chunk of ``prefill_chunk`` tokens (default 4 pages, snapped
        to a page multiple) per prefilling slot through
        :meth:`DecoderLM.prefill_paged_chunk`, one flash-attention launch
        per layer.  Greedy tokens equal the JAX engine's on the same
        weights in both modes.

        ``spec_k > 0`` drafts up to ``spec_k`` tokens per slot by matching
        the last ``spec_ngram`` tokens against the request's prompt and
        output; a boundary with a draft anywhere runs one verify step of
        window ``spec_k + 1`` (slots without a draft verify just their next
        token), one with none the plain decode step.  A draft never
        preempts live work: when the pool cannot grow a page for it, the
        draft is cut to the pages the slot holds.

        ``prefix_cache=True`` maps the longest cached page-aligned prefix of
        each admitted prompt read-only into its table
        (:class:`~repro_torch.serve.page_table.PrefixCache`), so only the
        rest is prefilled; cached tokens cost the prefill budget nothing,
        and the commitment counts each shared page once.  A full hit skips
        prefill and replays the last prompt token through the decode step,
        whose append first copies the shared last page into a private one
        (``ops.copy_pages``): cached pages are never written.  Pages of
        finished requests stay cached until admission, growth or a copy
        needs them.

        ``deadline_ms > 0`` is a run TTL: a request still queued past it is
        ``rejected``, one that finishes late stays ``completed`` but falls
        out of ``goodput``, and once the decode rate is measured, admission
        sheds queued work that can no longer meet it.  ``tenants``
        (:class:`~repro_torch.serve.scheduler.TenantSpec`) and tagged
        requests make admission pick by priority tier, then token bucket,
        then weighted fair share; ``fairness=False`` keeps FIFO.

        ``fault_hook`` (None: nothing runs) is called once a boundary with a
        :class:`~repro_torch.serve.faults.FaultContext` (step, pool, clock,
        tracer, checkpoints); the fleet's faults, leases and drains ride
        it.  A :class:`~repro_torch.serve.faults.WorkerCrash` it raises
        leaves ``serve_paged`` carrying ``results`` (the finished requests)
        and ``pending`` (every request not finished, replayable from its
        prompt); pressure pages the hook seized go back first.

        ``checkpoint_every=K > 0`` (with a ``checkpoints`` dict) snapshots
        every decoding slot each K decode steps into ``checkpoints`` by
        request id (:class:`~repro_torch.serve.page_table.PageSnapshot`:
        the exact stored bytes of its pages, scales too, with per-page
        checksums, its length and emitted tokens), at the top of the
        boundary before the hook, so a crash at step S leaves snapshots as
        of S.  A :class:`~repro_torch.serve.faults.WorkerDrain` first takes
        fresh snapshots of every decoding slot.  ``restores`` maps request
        ids to snapshots: such a request skips prefill; its checksums are
        verified, its pages scattered into fresh pages, its slot rebuilt,
        and it decodes on as an undisturbed run would.  A failed verify
        counts a ``checksum_failure``, drops the snapshot, and the request
        is prefilled from its prompt: corrupted state is never served.
        An encoder-decoder model raises ``NotImplementedError``.

        At an effective ``tp`` above 1 every rank of the world calls this
        with the same arguments: the launches run under the engine's rules
        (one ``tp:collective`` event a launch in rank 0's ``tracer``; the
        other ranks trace nothing), and the run ends by holding every
        rank's tokens against rank 0's (a mismatch raises on every rank)."""
        if self._tp_rules is None:
            return self._serve_paged(requests, num_slots, page_size, num_pages, prefill_chunk,
                                     overcommit, prefill_mode, prefill_budget, spec_k,
                                     spec_ngram, prefix_cache, clock, tracer, fault_hook,
                                     deadline_ms, tenants, fairness, checkpoint_every,
                                     checkpoints, restores)
        if comm.model_rank_of(self._tp_rules) != 0:
            tracer = None
        with set_activation_rules(self._tp_rules):
            stats = self._serve_paged(requests, num_slots, page_size, num_pages, prefill_chunk,
                                      overcommit, prefill_mode, prefill_budget, spec_k,
                                      spec_ngram, prefix_cache, clock, tracer, fault_hook,
                                      deadline_ms, tenants, fairness, checkpoint_every,
                                      checkpoints, restores)
        self._check_ranks_agree(stats)
        return stats

    def _check_ranks_agree(self, stats: "PagedStats") -> None:
        """Raise on every rank unless every rank's tokens equal rank 0's."""
        group = comm.group_of(self._tp_rules)
        mine = [(r.request_id, r.status, r.tokens.tolist()) for r in stats.results]
        same = comm.world_check(comm.broadcast_object(mine, group=group) == mine, group=group)
        if not same:
            raise RuntimeError(f"tensor-parallel serve: the ranks' tokens differ from rank 0's "
                               f"(tp {self.tp})")

    def _serve_paged(self, requests, num_slots, page_size, num_pages, prefill_chunk, overcommit,
                     prefill_mode, prefill_budget, spec_k, spec_ngram, prefix_cache, clock,
                     tracer, fault_hook, deadline_ms, tenants, fairness, checkpoint_every,
                     checkpoints, restores) -> "PagedStats":
        if self.model.cfg.family == "encdec":
            raise NotImplementedError(NOT_PAGED_ENCDEC)
        if prefill_mode not in ("packed", "chunked"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if checkpoint_every > 0 and checkpoints is None:
            raise ValueError("checkpoint_every > 0 needs a checkpoints dict")
        if not requests:
            return PagedStats([], 0, 0.0, 0, 0.0, 0.0, 0, self.page_size, 0,
                              0.0, 0, 0, 0, prefill_mode=prefill_mode,
                              kv_dtype=self._kv_dtype_name(), tp=self.tp)
        if overcommit <= 0:
            raise ValueError("overcommit must be > 0")
        dev = self.device
        page_size = page_size or self.page_size
        num_slots = num_slots or self.max_batch
        # chunk starts must stay page-aligned
        prefill_chunk = max(page_size, ((prefill_chunk or 4 * page_size) // page_size) * page_size)
        packed = prefill_mode == "packed"
        # packed-buffer size: the per-boundary prefill token budget, snapped
        # to a page multiple (chunk spans inside the buffer are page-aligned)
        t_pack = max(page_size, ((prefill_budget or 4 * prefill_chunk) // page_size) * page_size)
        budget = PrefillBudget(t_pack) if packed else None
        max_pages_per_seq = pages_needed(self.max_seq, page_size)
        if num_pages is None:
            num_pages = num_slots * max_pages_per_seq + 1
        pool = PagePool(num_pages, page_size, reserved=1)
        # growth still needs real pages: no request may commit above capacity
        commit_budget = min(pool.capacity, pool.capacity * overcommit)
        for r in requests:
            if len(r.prompt) + r.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"request {r.request_id}: prompt + generation exceeds max_seq"
                )
            if pool.pages_needed(len(r.prompt) + r.max_new_tokens) > commit_budget:
                raise ValueError(
                    f"request {r.request_id}: needs more pages than the pool "
                    f"(or overcommit budget) admits"
                )
        slots = PagedSlotPool(num_slots, pool, tracer=tracer, clock=clock)
        table = PageTable(num_slots, max_pages_per_seq, scratch_page=0)
        pcache = PrefixCache(pool) if prefix_cache else None
        # heads-split pools: a rank holds kv_heads / tp heads of EVERY page,
        # so the host-global page accounting above is the same on each rank
        cache = self.model.init_paged_cache(num_pages, page_size, self.kv_dtype, tp=self.tp)
        queue = deque(requests)
        # SLO / multi-tenant admission
        tenant_ledger = TenantLedger(tenants or ())
        fair = fairness and (bool(tenants) or any(
            r.tenant != "default" or r.priority != 1 for r in requests))
        req_cost = lambda r: float(len(r.prompt) + r.max_new_tokens)
        rejected_n = deferred_n = 0
        decode_tokens_emitted = 0
        spec = spec_k > 0
        ledger = SpecLedger() if spec else None
        nxt = np.zeros((num_slots,), np.int32)
        lengths = np.zeros((num_slots,), np.int32)   # live tokens per slot
        slot_tokens: Dict[int, List[int]] = {}
        slot_times: Dict[int, List[float]] = {}      # token-emission clocks
        prefilling: Dict[int, int] = {}              # slot -> next chunk start
        decoding: Set[int] = set()
        admit_order: Dict[int, int] = {}             # slot -> admission sequence
        admit_step: Dict[int, int] = {}
        ttft: Dict[int, float] = {}
        admit_seq = 0
        # per slot: worst-case PRIVATE pages, prompt tokens served from the
        # cache and prefilled this admission; full-hit slots whose first
        # token comes from their first decode step
        slot_commit: Dict[int, int] = {}
        slot_cached: Dict[int, int] = {}
        slot_prefilled: Dict[int, int] = {}
        replay_first: Set[int] = set()
        # slots rebuilt from a migrated snapshot: this worker never admitted
        # their prompt, so a preemption charges no dropped prefill for them
        restored_slots: Set[int] = set()
        # pages slots mapped from the cache: the commitment counts each once
        pinned_refs: Dict[int, int] = {}             # page -> mapping slots
        slot_shared: Dict[int, List[int]] = {}       # slot -> mapped pages
        finished: Dict[int, RequestResult] = {}
        t_start = clock()
        submit_s = {r.request_id: t_start for r in requests}
        deadline = t_start + deadline_ms / 1e3 if deadline_ms > 0 else None
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
        saved_tokens = 0
        dropped_tokens = 0
        cow_copies = 0
        ckpt_saved = ckpt_bytes = 0
        restored_n = restored_tok = restore_bytes = 0
        checksum_failures = 0
        last_ckpt_step = -1
        decode_s = 0.0
        itl_all: List[float] = []
        # device-resident decode state, patched only for slots that changed
        dev_table = torch.zeros((num_slots, max_pages_per_seq), dtype=torch.int32, device=dev)
        dev_pos = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        dev_nxt = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        dev_mask = torch.zeros((num_slots,), dtype=torch.bool, device=dev)
        cur_mask = np.zeros((num_slots,), bool)
        dirty: Set[int] = set()
        # the analytic TP-collective ledger (the reference's): every layer
        # closes two row-parallel boundaries (o-projection, MLP
        # down-projection), each summing a (tokens, d_model) float32 block
        # output over the model axis; a ring all-reduce moves 2(tp-1)/tp of
        # the payload a rank, a reduce-scatter (rs_block_outputs, on a
        # prefill launch whose tokens divide tp) (tp-1)/tp
        tp = self.tp
        rs_opt = bool(self._tp_rules is not None and self._tp_rules.opts.get("rs_block_outputs"))
        d_model, n_layers = self.model.cfg.d_model, self.model.cfg.num_layers

        def tp_event(phase: str, t0: float, t1: float, tokens: int,
                     seq_shardable: bool = False) -> None:
            if tp <= 1 or tracer is None or not tokens:
                return
            kind = ("reduce_scatter" if rs_opt and seq_shardable and tokens % tp == 0
                    else "psum")
            count = 2 * n_layers
            payload = tokens * d_model * 4
            factor = (tp - 1) / tp * (2.0 if kind == "psum" else 1.0)
            tracer.event("tp:collective", t0, t1, phase=phase, kind=kind, tp=tp, count=count,
                         payload_bytes=payload * count,
                         moved_bytes=int(payload * count * factor))

        def sync_device(active: List[int]) -> None:
            """Patch the device mirrors for slots whose table row, position,
            next token or active bit changed since the last launch (admission,
            growth, copy-on-write, rollback, release, preemption): one upload
            of the dirty rows, then in-place row writes (JAX donates the
            mirrors to a jitted scatter instead).  Inactive rows point at the
            scratch page."""
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

        def unpin(slot: int, page: int) -> None:
            """Drop ``slot``'s record of mapping ``page`` from the cache."""
            held = slot_shared.get(slot, [])
            if page in held:
                held.remove(page)
                pinned_refs[page] -= 1
                if not pinned_refs[page]:
                    del pinned_refs[page]

        def release_slot(slot: int, preempted: bool = False) -> ServeRequest:
            nonlocal dropped_tokens
            req = slots.release_paged(slot, table.clear(slot), preempted=preempted)
            if preempted and slot not in restored_slots:
                # prompt tokens this admission promised but never prefilled
                dropped_tokens += max(len(req.prompt) - slot_cached.get(slot, 0)
                                      - slot_prefilled.get(slot, 0), 0)
            lengths[slot] = 0
            for d in (slot_tokens, slot_times, prefilling, admit_order, slot_commit,
                      slot_cached, slot_prefilled, admit_step, ttft):
                d.pop(slot, None)
            decoding.discard(slot)
            replay_first.discard(slot)
            restored_slots.discard(slot)
            for p in list(slot_shared.get(slot, [])):
                unpin(slot, p)
            slot_shared.pop(slot, None)
            dirty.add(slot)
            return req

        def preempt_one() -> Optional[int]:
            """Preempt the lowest-priority youngest request: free its pages
            and put it back at the front of the queue.  The victim may be
            the slot that asked to grow."""
            if not admit_order:
                return None
            victim = min(admit_order,
                         key=lambda s: (slots.active[s].priority, -admit_order[s]))
            queue.appendleft(release_slot(victim, preempted=True))
            return victim

        def ensure_free(n: int) -> bool:
            """``n`` free pages, evicting cached-unreferenced pages (LRU)
            before the caller queues or preempts: the only path that evicts."""
            if pool.num_free >= n:
                return True
            if pcache is not None:
                evicted = pcache.evict(n - pool.num_free)
                if evicted and tracer is not None:
                    now = clock()
                    tracer.event("prefix:evict", now, now, pages=evicted)
            return pool.num_free >= n

        def cow_if_shared(s: int) -> bool:
            """Before an append at ``lengths[s]``: if that page is still
            referenced by others (the cache, other requests), copy it into a
            private page (``ops.copy_pages``, every layer, scales too) and
            remap the slot's table.  False when no page is free for the copy
            (the caller preempts)."""
            nonlocal cow_copies
            li = int(lengths[s]) // page_size
            held = table.pages_of(s)
            if li >= len(held):
                return True          # the append opens a fresh page (growth)
            p = held[li]
            if pool.refcount(p) <= 1:
                return True          # ours alone already
            if not ensure_free(1):
                return False
            fresh = pool.alloc(1)
            t0c = clock()
            ops.copy_pages(cache["k_pages"], cache["v_pages"], [p], fresh,
                           cache.get("k_scales"), cache.get("v_scales"))
            table.replace(s, li, fresh[0])
            pool.free([p])           # drop our reference to the shared page
            unpin(s, p)
            cow_copies += 1
            dirty.add(s)
            if tracer is not None:
                tracer.event("prefix:cow", t0c, clock(), slot=s, page=fresh[0])
            return True

        def snapshot_slot(s: int) -> Optional[PageSnapshot]:
            """Slot ``s``'s live pages as a :class:`PageSnapshot`: one gather
            of exactly the pages that hold its first ``lengths[s]`` tokens
            (``ops.export_pages``; the scale pools too when quantized),
            copied to host tensors, with its emitted tokens, length and
            per-page checksums.  None for a slot still prefilling: replay
            from its prompt is already the cheapest recovery there."""
            nonlocal ckpt_saved, ckpt_bytes
            if s not in decoding or not slot_tokens.get(s):
                return None
            req = slots.active[s]
            length = int(lengths[s])
            held = table.pages_of(s)[: pool.pages_needed(max(length, 1))]
            if not held:
                return None
            t0s = clock()
            # page-major host copies under (L, n, ...) views, so that the
            # checksums read each page in place; .cpu() waits for the gather
            k, v, *scales = (t.transpose(0, 1).contiguous().cpu().transpose(0, 1)
                             for t in ops.export_pages(
                                 cache["k_pages"], cache["v_pages"], held,
                                 cache.get("k_scales"), cache.get("v_scales")))
            ks, vs = scales if scales else (None, None)
            snap = PageSnapshot(
                request_id=req.request_id, prompt_len=len(req.prompt), length=length,
                tokens=np.asarray(slot_tokens[s], np.int32), k=k, v=v,
                k_scales=ks, v_scales=vs, checksums=page_checksums(k, v, ks, vs),
                step=step, kv_dtype=self._kv_dtype_name(),
            )
            ckpt_saved += 1
            ckpt_bytes += snap.nbytes
            if tracer is not None:
                tracer.event("ckpt:save", t0s, clock(), request=req.request_id, step=step,
                             pages=len(held), bytes=snap.nbytes, tokens=len(slot_tokens[s]))
            return snap

        def checkpoint_all() -> None:
            for s in sorted(decoding):
                snap = snapshot_slot(s)
                if snap is not None:
                    checkpoints[snap.request_id] = snap

        def emit_tenant(req: ServeRequest, status: str, now: float, latency: float) -> None:
            if tracer is None:
                return
            slo = req.slo_ms or deadline_ms
            tracer.event(
                "sched:tenant", now, now, tenant=req.tenant, priority=req.priority,
                status=status, latency_s=latency, slo_ms=slo,
                slo_ok=status == "completed" and (slo <= 0 or latency * 1e3 <= slo),
                tokens=req_cost(req),
            )

        def reject(req: ServeRequest, reason: str) -> None:
            """A terminal ``rejected`` result: never silent."""
            nonlocal rejected_n
            now_r = clock()
            latency = now_r - submit_s[req.request_id]
            finished[req.request_id] = RequestResult(
                request_id=req.request_id, tokens=np.zeros((0,), np.int32), slot=-1,
                admit_step=-1, finish_step=step, ttft_s=0.0, latency_s=latency,
                tokens_per_s=0.0, status="rejected", reason=reason, tenant=req.tenant,
                priority=req.priority, within_deadline=False,
            )
            rejected_n += 1
            emit_tenant(req, "rejected", now_r, latency)

        def unmeetable(req: ServeRequest, queued_prompt_ahead: int, now: float) -> bool:
            """The queue's prompt tokens ahead flow through the per-boundary
            prefill budget, then the request decodes at the measured per-slot
            rate: shed it when even that finish lands past the deadline."""
            if deadline is None or step == 0 or decode_s <= 0:
                return False
            decode_tps = decode_tokens_emitted / decode_s
            if decode_tps <= 0:
                return False
            boundary_s = (prefill_s + decode_s) / step
            prefill_wait = ((queued_prompt_ahead + len(req.prompt)) / t_pack * boundary_s
                            if packed else 0.0)
            per_slot_tps = decode_tps / max(1, slots.num_active)
            return now + prefill_wait + req.max_new_tokens / per_slot_tps > deadline

        def pick_admission(now: float) -> int:
            """Index of the next admission: priority tier first, then weighted
            fair share across tenants (a dry bucket sinks its tenant), then
            FIFO order."""
            if not fair or len(queue) == 1:
                return 0
            best, best_key = 0, None
            for i, r in enumerate(queue):
                dry = 1 if tenant_ledger.dry(r.tenant, req_cost(r), now) else 0
                key = (dry, -r.priority, tenant_ledger.vtime.get(r.tenant, 0.0), i)
                if best_key is None or key < best_key:
                    best, best_key = i, key
            return best

        def start_decoding(slot: int, req: ServeRequest, tok0: int) -> None:
            """The prompt is in: its first token came from the prefill."""
            del prefilling[slot]
            if pcache is not None:
                pcache.insert(req.prompt, table.pages_of(slot))
            nxt[slot] = tok0
            slot_tokens[slot] = [tok0]
            decoding.add(slot)
            dirty.add(slot)
            tnow = clock()
            slot_times[slot] = [tnow]
            ttft[slot] = tnow - submit_s[req.request_id]

        while queue or slots.num_active:
            progressed = False
            # 0a) periodic checkpoint, BEFORE the hook: a crash at boundary S
            #     leaves snapshots as of S.  Keyed on the decode-step counter,
            #     once per value (prefill-only boundaries leave it as it is)
            if (checkpoint_every > 0 and checkpoints is not None and step > 0
                    and step % checkpoint_every == 0 and step != last_ckpt_step):
                last_ckpt_step = step
                checkpoint_all()
            # 0b) the boundary hook: a WorkerCrash is raised only here, so the
            #     finished results and the pending requests are attached here
            if fault_hook is not None:
                try:
                    fault_hook(FaultContext(step=step, pool=pool, clock=clock, tracer=tracer,
                                            checkpoints=checkpoints))
                except WorkerCrash as crash:
                    if isinstance(crash, WorkerDrain) and checkpoints is not None:
                        # a planned drain: fresh snapshots of every decoding
                        # slot, so that all of them migrate with no recompute
                        checkpoint_all()
                    crash.results = [finished[r.request_id] for r in requests
                                     if r.request_id in finished]
                    crash.pending = [r for r in requests if r.request_id not in finished]
                    if hasattr(fault_hook, "release"):
                        fault_hook.release()   # seized pressure pages go back
                    raise
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
                        tenant=req.tenant,
                        priority=req.priority,
                        # a late completion stays completed, out of goodput
                        within_deadline=deadline is None or now <= deadline,
                    )
                    emit_tenant(req, "completed", now, latency)
                    release_slot(slot)
                    progressed = True
            # 2) admission keyed on free pages and the worst-case commitment;
            #    a cached prefix is mapped instead of allocated, and each
            #    shared page counts once (plus one copy page for a full hit)
            if deadline is not None and queue and clock() > deadline:
                while queue:                 # expired while queued: rejected
                    reject(queue.popleft(), "deadline")
                progressed = True
            while queue:
                now_adm = clock()
                i0 = pick_admission(now_adm)
                req = queue[i0]
                if unmeetable(req, sum(len(r.prompt) for r in queue) - len(req.prompt),
                              now_adm):
                    del queue[i0]
                    reject(req, "slo-unmeetable")
                    progressed = True
                    continue
                # a request with a migrated snapshot skips prefill: verify its
                # checksums, scatter its pages into fresh ones, rebuild the
                # slot and decode on.  A failed verify drops the snapshot and
                # the request is prefilled from its prompt
                snap = restores.get(req.request_id) if restores else None
                if snap is not None and not snap.verify():
                    checksum_failures += 1
                    del restores[req.request_id]
                    if tracer is not None:
                        now_cf = clock()
                        tracer.event("migrate:checksum_fail", now_cf, now_cf,
                                     request=req.request_id, step=step, pages=snap.num_pages)
                    snap = None
                if snap is not None:
                    worst = pool.pages_needed(len(req.prompt) + req.max_new_tokens)
                    npages = snap.num_pages
                    if not slots.num_free:
                        break
                    if sum(slot_commit.values()) + len(pinned_refs) + worst > (
                            pool.capacity * overcommit):
                        break
                    if not ensure_free(npages):
                        break
                    del queue[i0]
                    del restores[req.request_id]
                    if fair:
                        tenant_ledger.on_admit(req.tenant, req_cost(req), now_adm)
                    t0m = clock()
                    slot, pages = slots.admit_paged(req, npages, step=step)
                    table.assign(slot, pages)
                    ops.import_pages(cache["k_pages"], cache["v_pages"], pages, snap.k, snap.v,
                                     cache.get("k_scales"), cache.get("v_scales"),
                                     snap.k_scales, snap.v_scales)
                    lengths[slot] = snap.length
                    toks = [int(t) for t in snap.tokens]
                    slot_tokens[slot] = toks
                    slot_times[slot] = []
                    nxt[slot] = toks[-1]
                    slot_commit[slot] = worst
                    slot_cached[slot] = 0
                    slot_prefilled[slot] = 0
                    admit_order[slot] = admit_seq
                    admit_seq += 1
                    admit_step[slot] = step
                    # the first token came from the source worker: TTFT here
                    # is the restore's latency
                    ttft[slot] = clock() - submit_s[req.request_id]
                    decoding.add(slot)
                    restored_slots.add(slot)
                    dirty.add(slot)       # the mirrors take its length and table
                    restored_n += 1
                    restored_tok += snap.length
                    restore_bytes += snap.nbytes
                    if tracer is not None:
                        tracer.event("migrate:restore", t0m, clock(), request=req.request_id,
                                     pages=len(pages), bytes=snap.nbytes, tokens=len(toks),
                                     length=snap.length)
                    progressed = True
                    continue
                hit_pages, cached = pcache.match(req.prompt) if pcache is not None else ([], 0)
                full_hit = cached >= len(req.prompt)
                npages = pool.pages_needed(len(req.prompt)) - len(hit_pages)
                worst = pool.pages_needed(len(req.prompt) + req.max_new_tokens)
                commit = worst - len(hit_pages) + (1 if full_hit else 0)
                pinned = len(pinned_refs) + sum(1 for p in hit_pages if p not in pinned_refs)
                if not slots.num_free:
                    break
                if sum(slot_commit.values()) + pinned + commit > pool.capacity * overcommit:
                    break
                # pin the hit pages BEFORE eviction: they are exactly the
                # cached-unreferenced pages ensure_free may reclaim
                if hit_pages:
                    pool.incref(hit_pages)
                if not ensure_free(npages):
                    if hit_pages:
                        pool.free(hit_pages)
                    break
                del queue[i0]
                if fair:
                    tenant_ledger.on_admit(req.tenant, req_cost(req), now_adm)
                if pcache is not None:
                    pcache.record(len(req.prompt), hit_pages)
                slot, pages = slots.admit_paged(req, npages, step=step)
                table.assign(slot, hit_pages + pages)
                for p in hit_pages:
                    pinned_refs[p] = pinned_refs.get(p, 0) + 1
                slot_shared[slot] = list(hit_pages)
                slot_tokens[slot] = []
                slot_commit[slot] = commit
                slot_prefilled[slot] = 0
                prompt_admitted += len(req.prompt)
                admit_order[slot] = admit_seq
                admit_seq += 1
                admit_step[slot] = step
                slot_cached[slot] = cached
                saved_tokens += cached
                if budget is not None and cached:
                    budget.credit(cached)
                if full_hit:
                    # nothing to prefill: the last prompt token goes through
                    # the decode step (its append copies the shared last page)
                    lengths[slot] = len(req.prompt) - 1
                    nxt[slot] = int(req.prompt[-1])
                    slot_times[slot] = []
                    decoding.add(slot)
                    replay_first.add(slot)
                    dirty.add(slot)
                else:
                    lengths[slot] = cached
                    prefilling[slot] = cached
                if tracer is not None and pcache is not None:
                    now = clock()
                    tracer.event("prefix:lookup", now, now, prompt_tokens=len(req.prompt),
                                 cached_tokens=cached, hit_pages=len(hit_pages),
                                 full_hit=int(full_hit))
                progressed = True
            if fair and queue:
                # one deferral per tenant per boundary whose queued work was
                # passed over because its bucket ran dry
                now_d = clock()
                seen_dry: Set[str] = set()
                for r in queue:
                    if r.tenant not in seen_dry and tenant_ledger.dry(r.tenant, req_cost(r),
                                                                       now_d):
                        seen_dry.add(r.tenant)
                        tenant_ledger.note_defer(r.tenant)
                        deferred_n += 1
                        if tracer is not None:
                            tracer.event("sched:defer", now_d, now_d, tenant=r.tenant)
            # 3) prefill.  packed: every prefilling slot's next span in ONE
            #    token-packed launch (oldest first, capped by the budget);
            #    chunked: one batch-1 chunk per prefilling slot
            if prefilling and packed:
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
                        # chunk-pad K/V lands inside the prompt's own private
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
                        slot_prefilled[slot] += take
                        chunks_done += 1
                        if new_start >= len(req.prompt):
                            start_decoding(slot, req, int(first_tok[ci]))
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
                    tp_event("prefill", t0p, now, t_pack, seq_shardable=True)
                    progressed = True
            elif prefilling:
                t0p = clock()
                chunk_tok = 0
                for slot in list(prefilling):
                    req = slots.active[slot]
                    start = prefilling[slot]
                    c = min(prefill_chunk, len(req.prompt) - start)
                    # a page-multiple chunk: its pad K/V lands inside the
                    # prompt's own pages, length-masked until overwritten
                    c_pad = min(prefill_chunk, pages_needed(c, page_size) * page_size)
                    chunk = np.zeros((1, c_pad), np.int32)
                    chunk[0, :c] = req.prompt[start : start + c]
                    up = _upload({"chunk": chunk, "row": table.table[slot]}, dev)
                    logits = self.model.prefill_paged_chunk(
                        self.params, up["chunk"], cache, up["row"], c - 1, start
                    )
                    chunks_done += 1
                    prefill_launches += 1
                    prefill_tokens += c
                    prefill_padded += c_pad - c
                    chunk_tok += c_pad
                    start += c
                    lengths[slot] = start
                    slot_prefilled[slot] += c
                    progressed = True
                    if start >= len(req.prompt):
                        start_decoding(slot, req, int(logits[0].argmax()))
                    else:
                        prefilling[slot] = start
                _sync(dev)
                now = clock()
                prefill_s += now - t0p
                tp_event("prefill", t0p, now, chunk_tok, seq_shardable=True)
            # 4) one decode step over the whole pool.  With ``spec_k > 0``
            #    the drafter proposes up to ``spec_k`` tokens per slot and
            #    ONE verify step scores every slot's window; a boundary with
            #    no draft anywhere runs the plain decode step
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
                    else:
                        drafts[s] = []
            # copy-on-write, then growth, for every decoding row: the next
            # token (and any draft) appends at ``lengths[s]``.  Both reclaim
            # cached-unreferenced pages before preempting; a draft that
            # cannot get a page is cut to the pages the slot holds, so only
            # the real next token's page may preempt
            for s in sorted(active_dec, key=lambda s: admit_order[s]):
                while s in decoding and not cow_if_shared(s):
                    if preempt_one() is None:
                        raise RuntimeError("page pool exhausted with nothing to preempt")
                while (s in decoding    # may have been preempted (even by itself)
                       and table.num_pages_of(s) * page_size
                       <= int(lengths[s]) + len(drafts.get(s, ()))):
                    grown = slots.grow(1) if ensure_free(1) else None
                    if grown is None:
                        d = drafts.get(s)
                        if d:
                            fit = table.num_pages_of(s) * page_size - int(lengths[s]) - 1
                            del d[max(fit, 0):]
                            continue
                        if preempt_one() is None:
                            raise RuntimeError("page pool exhausted with nothing to preempt")
                        continue
                    table.append(s, grown[0])
                    dirty.add(s)
            active_dec = [s for s in active_dec if s in decoding]
            if active_dec:
                t0d = clock()
                use_spec = spec and any(drafts.get(s) for s in active_dec)
                W = spec_k + 1 if use_spec else 1
                sync_device(active_dec)
                live = max(int(lengths[s]) + 1 + len(drafts.get(s, ())) for s in active_dec)
                bound = bucket_pow2(pages_needed(live, page_size), cap=max_pages_per_seq)
                if use_spec:
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
                tp_event("verify" if use_spec else "decode", t0d, now, num_slots * W)
                step += 1
                occupancy_sum += slots.num_active
                prop_total = acc_total = 0
                for s in active_dec:
                    a = int(na[s])
                    emitted = g[s, : a + 1]
                    req = slots.active[s]
                    slot_tokens[s].extend(int(t) for t in emitted)
                    nxt[s] = int(emitted[-1])
                    lengths[s] += a + 1
                    decode_tokens_emitted += a + 1
                    slot_times[s].extend([now] * (a + 1))
                    if s in replay_first:
                        # a full hit: its first token came from this step
                        replay_first.discard(s)
                        ttft[s] = now - submit_s[req.request_id]
                    if spec:
                        prop = len(drafts.get(s, ()))
                        ledger.record(req.request_id, prop, a)
                        prop_total += prop
                        acc_total += a
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
                    if use_spec and tracer is not None:
                        tracer.event(
                            "spec:verify", t0d, now, window=W, slots=len(active_dec),
                            proposed=prop_total, accepted=acc_total,
                            emitted=len(active_dec) + acc_total,
                        )
                progressed = True
            # peak concurrency is per boundary: a prefill-only boundary
            # still holds admitted requests
            peak_occupancy = max(peak_occupancy, slots.num_active)
            pages_sum += pool.num_in_use
            samples += 1
            slots.record_occupancy(step)
            if not progressed and not prefilling and not decoding:
                raise RuntimeError("paged serve loop stalled (admission deadlock)")
        if fault_hook is not None and hasattr(fault_hook, "release"):
            fault_hook.release()   # pressure seizures held past the last step
        _sync(dev)
        wall = clock() - t_start
        results = [finished[r.request_id] for r in requests]
        total_tokens = sum(len(r.tokens) for r in results)
        completed = [r for r in results if r.status == "completed"]
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
            prefill_mode=prefill_mode,
            prefill_launches=prefill_launches,
            prefill_s=prefill_s,
            prefill_tokens=prefill_tokens,
            prefill_padded_tokens=prefill_padded,
            prefill_budget=t_pack if packed else 0,
            prefill_budget_stats=budget.stats() if budget else {},
            prompt_tokens_admitted=prompt_admitted,
            saved_prefill_tokens=saved_tokens,
            prefill_tokens_dropped=dropped_tokens,
            prefix_cache=prefix_cache,
            cow_copies=cow_copies,
            cache_evictions=pcache.evicted_pages if pcache else 0,
            prefix_stats=pcache.stats() if pcache else {},
            decode_s=decode_s,
            spec_k=spec_k,
            spec_stats=ledger.stats() if spec else {},
            itl_p50_ms=percentile(itl_all, 50.0) * 1e3 if itl_all else 0.0,
            itl_p99_ms=percentile(itl_all, 99.0) * 1e3 if itl_all else 0.0,
            kv_dtype=self._kv_dtype_name(),
            # the whole pool's bytes: a rank holds 1/tp of them
            kv_bytes_per_token=float(
                sum(v.numel() * v.element_size() for v in cache.values()) * tp
                / (num_pages * page_size)
            ),
            completed=len(completed),
            rejected=rejected_n,
            deferred=deferred_n,
            goodput=(sum(1 for r in completed if r.within_deadline) / len(results)
                     if results else 1.0),
            deadline_ms=deadline_ms,
            checkpoints_saved=ckpt_saved,
            checkpoint_bytes=ckpt_bytes,
            restored_requests=restored_n,
            restored_tokens=restored_tok,
            restore_bytes=restore_bytes,
            checksum_failures=checksum_failures,
            tp=tp,
        )
