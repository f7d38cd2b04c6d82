"""Decoder-only LMs: the serving paths of ``repro.models.lm``.

What is ported: parameters; the full-sequence :meth:`DecoderLM.forward`;
for the dense family (``family="dense"``) the dense KV cache ``(L, b,
max_seq, kvh, d)`` with one right-padded prefill (:meth:`DecoderLM.prefill`)
and one decode step (:meth:`DecoderLM.decode`), as the static and
continuous engines drive them; the paged KV pool (full precision, or
int8/fp8 codes with float32 scale pools), one paged decode step
(:meth:`DecoderLM.decode_paged`), one speculative verify step
(:meth:`DecoderLM.decode_spec`) and one packed varlen-prefill launch
(:meth:`DecoderLM.prefill_packed`).  For the attention-free SSM family
(``family="ssm"``, Mamba-2) the same ``prefill``/``decode``/``forward`` over
a cache of per-layer SSD states ``(L, b, h, p, n)`` (float32) and
convolution histories ``(L, b, K-1, conv_dim)``; its state is not paged.
Layers run as a Python loop over a list of per-layer parameter dicts (JAX
scans stacked leaves); caches and pools stay stacked on a leading layer
axis and each layer writes its slice in place, where JAX returns updated
arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ..device import resolve_device, resolve_dtype
from ..kernels import kvquant, ops
from .config import ArchConfig
from .modules import (
    attn_decode,
    attn_decode_paged,
    attn_decode_spec,
    attn_defs,
    attn_full,
    attn_prefill_packed,
    mamba_defs,
    mamba_forward,
    mamba_step,
    mlp_apply,
    mlp_defs,
    norm_defs,
)
from .params import P, init_params


# the reference's reason for refusing a paged cache (``repro.models.lm``)
NOT_PAGED = ("paged KV cache supports dense/moe (non-interleaved) decoder caches only; "
             "ssm/hybrid state is not paged")
# the reference's reason for refusing a right-padded prefill
_NOT_RAGGED = ("ragged (right-padded) prefill requires a pure-attention cache; "
               "ssm/hybrid state would absorb the pad tokens")


class DecoderLM:
    """Dense GQA decoder (``family="dense"``) or attention-free Mamba-2
    stack (``family="ssm"``).

    ``device`` defaults to ``cuda`` (and raises where there is none);
    ``dtype`` is the weight and activation dtype: bf16 on the card, float32
    on the CPU unless given.  Softmax statistics and accumulation are
    float32 inside the kernels; logits are returned in float32."""

    def __init__(self, cfg: ArchConfig, device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype, None] = None) -> None:
        cfg.validate()
        unsupported = [
            name for name, on in (
                (f"family {cfg.family}", cfg.family not in ("dense", "ssm")),
                ("qk_norm", cfg.qk_norm),
                ("post_norms", cfg.post_norms),
                ("scale_embed", cfg.scale_embed),
                ("logit_softcap", cfg.logit_softcap > 0),
                ("sliding/global windows", cfg.global_every > 0 and cfg.sliding_window > 0),
            ) if on
        ]
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: not ported yet: {', '.join(unsupported)}"
            )
        self.cfg = cfg
        self.ssm = cfg.family == "ssm"
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        # the batch axis of each cache tensor (the continuous engine's slot copy)
        self.CACHE_BATCH_AXIS = ({"pos": 0, "ssm": 1, "conv": 1} if self.ssm
                                 else {"pos": 0, "k": 1, "v": 1})

    # -- params ---------------------------------------------------------------
    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        V, D = cfg.vocab_size, cfg.d_model
        if self.ssm:
            block = lambda: {"ln": norm_defs(cfg), "mamba": mamba_defs(cfg)}
        else:
            block = lambda: {
                "ln1": norm_defs(cfg),
                "attn": attn_defs(cfg),
                "ln2": norm_defs(cfg),
                "mlp": mlp_defs(cfg),
            }
        defs = {
            "embed": P((V, D)),
            "blocks": [block() for _ in range(cfg.num_layers)],
            "final_norm": norm_defs(cfg),
        }
        if not cfg.tie_embeddings:
            defs["lm_head"] = P((D, V))
        return defs

    def init(self, seed: int = 0):
        """Random weights on the model's device and dtype from a seeded
        ``torch.Generator`` on that device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device, self.dtype)

    # -- helpers ----------------------------------------------------------------
    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return ops.rmsnorm(x, w, self.cfg.norm_eps)

    def _embed_tokens(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(x, params["final_norm"])
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return (x @ head).float()

    def _block_ffn(self, blk, x: torch.Tensor) -> torch.Tensor:
        """ln2 + MLP, residual-added."""
        return x + mlp_apply(blk["mlp"], self._norm(x, blk["ln2"]))

    def _mamba_block_full(self, blk, x: torch.Tensor, return_state: bool = False):
        """ln + Mamba-2 over the sequence, residual-added; with
        ``return_state`` also the final SSD state and conv history of a
        scan from a zero state."""
        out = mamba_forward(blk["mamba"], self._norm(x, blk["ln"]), self.cfg,
                            return_state=return_state)
        if return_state:
            y, state, conv = out
            return x + y, state, conv
        return x + out

    def _mamba_block_step(self, blk, x1: torch.Tensor, state: torch.Tensor,
                          conv: torch.Tensor):
        """ln + one Mamba-2 decode token, residual-added."""
        y, state, conv = mamba_step(blk["mamba"], self._norm(x1, blk["ln"]), state, conv,
                                    self.cfg)
        return x1 + y, state, conv

    # -- full sequence ------------------------------------------------------------
    def forward(self, params, batch: Dict[str, torch.Tensor]):
        """Logits of every position of ``batch["tokens"]`` (b, s): float32
        (b, s, V), and the auxiliary loss (0 for a dense model), as the JAX
        model returns them.  ``remat`` (a training option) is not ported."""
        x = self._embed_tokens(params, batch["tokens"])
        for blk in params["blocks"]:
            if self.ssm:
                x = self._mamba_block_full(blk, x)
                continue
            x = x + attn_full(blk["attn"], self._norm(x, blk["ln1"]), self.cfg)
            x = self._block_ffn(blk, x)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    # -- dense cache ------------------------------------------------------------------
    def cache_defs(self, batch: int, max_seq: int) -> Dict[str, tuple]:
        """Shapes of the dense cache: ``pos`` (b,) int32, the next position
        of each row, and K/V stacks (L, b, max_seq, kvh, d); for the SSM
        family the SSD states (L, b, h, p, n) and conv histories (L, b,
        K-1, conv_dim), whose size does not depend on ``max_seq``."""
        cfg = self.cfg
        L = cfg.num_layers
        if self.ssm:
            n = cfg.ssm_state
            return {"pos": (batch,),
                    "ssm": (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                    "conv": (L, batch, cfg.conv_kernel - 1, cfg.ssm_inner + 2 * n)}
        kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
        return {"pos": (batch,), "k": (L, batch, max_seq, kv, dh),
                "v": (L, batch, max_seq, kv, dh)}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """A zeroed cache: K/V and conv histories in the model's dtype (bf16
        on the card, float32 on the CPU), SSD states float32, ``pos``
        int32."""
        dtypes = {"pos": torch.int32, "ssm": torch.float32}
        return {
            k: torch.zeros(shape, device=self.device, dtype=dtypes.get(k, self.dtype))
            for k, shape in self.cache_defs(batch, max_seq).items()
        }

    def _prefill_logits(self, params, batch, x: torch.Tensor,
                        cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Last-token logits, and each row's next position into
        ``cache["pos"]``.  With ``batch["lengths"]`` the prompts are
        right-padded to a common length: causal attention never reads the
        trailing pads, so the logits at ``lengths - 1`` are those of the
        unpadded prompts."""
        b, s = x.shape[:2]
        lengths = batch.get("lengths")
        if lengths is None:
            cache["pos"].fill_(s)
            x_last = x[:, -1:].contiguous()
        else:
            lengths = lengths.to(device=x.device, dtype=torch.int32)
            cache["pos"].copy_(lengths)
            x_last = x[torch.arange(b, device=x.device), lengths.long() - 1][:, None]
        return self._logits(params, x_last)[:, 0]

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill ``batch["tokens"]`` (b, s), optionally right-padded with
        ``batch["lengths"]`` (b,): every layer attends the prompt with one
        flash-attention launch and writes its K/V into positions ``[0, s)``
        of the dense cache, in place.  The SSM family scans every row from a
        zero state with one ``ssd`` launch per layer and writes each layer's
        final state and conv history; its rows are left-padded to one
        length and take no ``lengths``, as the pads flow through the state.
        Returns float32 last-token logits (b, V)."""
        x = self._embed_tokens(params, batch["tokens"])
        if self.ssm:
            if batch.get("lengths") is not None:
                raise NotImplementedError(_NOT_RAGGED)
            for li, blk in enumerate(params["blocks"]):
                x, state, conv = self._mamba_block_full(blk, x, return_state=True)
                cache["ssm"][li].copy_(state)
                cache["conv"][li].copy_(conv)
            return self._prefill_logits(params, batch, x, cache)
        s = x.shape[1]
        for li, blk in enumerate(params["blocks"]):
            a, (k, v) = attn_full(blk["attn"], self._norm(x, blk["ln1"]), self.cfg,
                                  return_kv=True)
            cache["k"][li, :, :s] = k
            cache["v"][li, :, :s] = v
            x = self._block_ffn(blk, x + a)
        return self._prefill_logits(params, batch, x, cache)

    def decode(self, params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
               uniform_pos: bool = True, kv_bound: Optional[int] = None) -> torch.Tensor:
        """One token step over a dense cache.  ``tokens``: (b,) int32, the
        token at position ``cache["pos"]`` of each row; its K/V are written
        there in place and ``pos`` advances by one.  ``uniform_pos=False``
        writes each row at its own position (continuous batching);
        ``kv_bound`` is a host-known bound on the live lengths, so attention
        reads only that prefix of the cache.  The SSM family advances every
        layer's state and conv history in place (``uniform_pos`` and
        ``kv_bound`` do not apply).  Returns float32 logits (b, V)."""
        pos = cache["pos"]
        x = self._embed_tokens(params, tokens)[:, None, :]          # (b, 1, D)
        if self.ssm:
            x1 = x[:, 0]
            for li, blk in enumerate(params["blocks"]):
                x1, state, conv = self._mamba_block_step(blk, x1, cache["ssm"][li],
                                                         cache["conv"][li])
                cache["ssm"][li].copy_(state)
                cache["conv"][li].copy_(conv)
            pos.add_(1)
            return self._logits(params, x1)
        for li, blk in enumerate(params["blocks"]):
            a = attn_decode(blk["attn"], self._norm(x, blk["ln1"]), cache["k"][li],
                            cache["v"][li], pos, self.cfg, uniform_pos=uniform_pos,
                            kv_bound=kv_bound)
            x = self._block_ffn(blk, x + a)
        pos.add_(1)
        return self._logits(params, x)[:, 0]

    # -- paged KV pool --------------------------------------------------------------
    def paged_cache_defs(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None) -> Dict[str, tuple]:
        """Shapes of the paged KV layout: one global pool of ``page_size``-
        token pages per layer, indexed through per-request page tables.  An
        int8/fp8 ``kv_dtype`` adds the float32 scale pools, one scale per
        page row per kv head.  The SSM family has no paged layout."""
        if self.ssm:
            raise NotImplementedError(NOT_PAGED)
        cfg = self.cfg
        L, kv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        shapes = {"k_pages": (L, num_pages, page_size, kv, dh),
                  "v_pages": (L, num_pages, page_size, kv, dh)}
        if kvquant.is_quantized(kv_dtype):
            shapes.update(k_scales=(L, num_pages, page_size, kv),
                          v_scales=(L, num_pages, page_size, kv))
        return shapes

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Zeroed pools: in the model's dtype, or int8/fp8 codes (``kv_dtype``
        ``"int8"``/``"fp8"``) with float32 scale pools."""
        quantized = kvquant.is_quantized(kv_dtype)
        store = kvquant.pool_dtype(kv_dtype) if quantized else self.dtype
        return {
            k: torch.zeros(shape, device=self.device,
                           dtype=torch.float32 if k.endswith("scales") else store)
            for k, shape in self.paged_cache_defs(num_pages, page_size, kv_dtype).items()
        }

    @staticmethod
    def _layer_pools(cache: Dict[str, torch.Tensor], li: int) -> tuple:
        """Layer ``li``'s K/V pools and scale pools (None for a full-precision
        pool), as views that the layer writes in place."""
        scales = ((cache["k_scales"][li], cache["v_scales"][li])
                  if "k_scales" in cache else (None, None))
        return cache["k_pages"][li], cache["v_pages"][li], *scales

    # -- serving ----------------------------------------------------------------------
    def decode_paged(self, params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                     page_table: torch.Tensor, lengths: torch.Tensor,
                     pages_bound: Optional[int] = None) -> torch.Tensor:
        """One paged decode step for a pool of slots.

        ``tokens``: (b,) next-token ids; ``page_table``: (b, max_pages) int32
        physical page ids; ``lengths``: (b,) int32 tokens already held per
        slot.  The new token is appended at logical position ``lengths`` and
        attention covers ``lengths + 1`` tokens; ``pages_bound`` bounds the
        live pages per request.  The pools in ``cache`` are written in
        place.  Returns float32 logits (b, V)."""
        pos = lengths.to(torch.int32)
        x = self._embed_tokens(params, tokens)[:, None, :]          # (b, 1, D)
        for li, blk in enumerate(params["blocks"]):
            kp, vp, ks, vs = self._layer_pools(cache, li)
            h = self._norm(x, blk["ln1"])
            a = attn_decode_paged(
                blk["attn"], h, kp, vp, page_table, pos, self.cfg,
                pages_bound=pages_bound, k_scales=ks, v_scales=vs,
            )
            x = self._block_ffn(blk, x + a)
        return self._logits(params, x)[:, 0]

    def decode_spec(self, params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                    page_table: torch.Tensor, lengths: torch.Tensor,
                    window_lens: torch.Tensor,
                    pages_bound: Optional[int] = None) -> torch.Tensor:
        """One speculative verify step for a pool of slots.

        ``tokens``: (b, W) int32 windows, per slot the pending next token
        and up to ``W - 1`` draft tokens, right-padded; ``window_lens``: (b,)
        real tokens per window (0 for idle slots); ``lengths``: (b,) tokens
        already committed, so the window occupies positions ``[lengths,
        lengths + window_lens)``.  Every layer writes the window's K/V into
        the pools in place and attends the committed context plus the
        window's causal prefix in one launch.  ``pages_bound`` bounds the
        committed-plus-in-flight pages.  Returns float32 logits (b, W, V):
        row ``w`` is the next-token distribution after ``tokens[:, :w + 1]``,
        so greedy acceptance compares ``argmax(logits[:, w - 1])`` with
        ``tokens[:, w]``."""
        pos = lengths.to(torch.int32)
        wlens = window_lens.to(torch.int32)
        x = self._embed_tokens(params, tokens)                       # (b, W, D)
        for li, blk in enumerate(params["blocks"]):
            kp, vp, ks, vs = self._layer_pools(cache, li)
            h = self._norm(x, blk["ln1"])
            a = attn_decode_spec(
                blk["attn"], h, kp, vp, page_table, pos, wlens, self.cfg,
                pages_bound=pages_bound, k_scales=ks, v_scales=vs,
            )
            x = self._block_ffn(blk, x + a)
        return self._logits(params, x)

    def prefill_packed(self, params, batch: Dict[str, torch.Tensor],
                       cache: Dict[str, torch.Tensor],
                       pages_bound: Optional[int] = None) -> torch.Tensor:
        """One packed varlen-prefill launch over a token-packed ``(1, T)``
        buffer of prompt chunks from many requests; each chunk attends its
        request's committed pages plus the causal prefix of its own tokens,
        and the packed K/V are written into the pools in place.

        ``batch`` holds ``tokens`` plus the packing metadata of
        :func:`~repro_torch.models.modules.attn_prefill_packed` and
        ``last_idx`` (C,), the packed row of each chunk's last real token.
        Returns float32 logits (C, V) at ``last_idx``; only rows of chunks
        that complete their prompt are meaningful."""
        meta = {
            k: batch[k]
            for k in ("tok_pos", "dst_page", "dst_off", "cu_seqlens",
                      "chunk_lens", "chunk_pos0", "page_tables")
        }
        x = self._embed_tokens(params, batch["tokens"])             # (1, T, D)
        for li, blk in enumerate(params["blocks"]):
            kp, vp, ks, vs = self._layer_pools(cache, li)
            h = self._norm(x, blk["ln1"])
            a = attn_prefill_packed(
                blk["attn"], h, kp, vp, meta, self.cfg,
                pages_bound=pages_bound, k_scales=ks, v_scales=vs,
            )
            x = self._block_ffn(blk, x + a)
        last = batch["last_idx"].long()
        return self._logits(params, x[0, last][:, None, :])[:, 0]
