"""The port's LMs, decoder-only and encoder-decoder: the serving paths of
``repro.models.lm``.

What is ported: parameters; the full-sequence :meth:`DecoderLM.forward`;
for the dense family (``family="dense"``, with the options the zoo's dense
configs set: QK-norm, post-norms, scaled embeddings, attention and logit
softcaps, alternating sliding/global windows) and the MoE family
(``family="moe"``: every block's MLP a mixture of experts, or with
``moe_every=2`` dense and MoE blocks interleaved in pairs) the dense KV
cache ``(L, b, max_seq, kvh, d)`` (interleaved: ``(L/2, 2, b, max_seq,
kvh, d)``, a dense and a MoE layer per pair) with one right-padded
prefill (:meth:`DecoderLM.prefill`)
and one decode step (:meth:`DecoderLM.decode`), as the static and
continuous engines drive them; the paged KV pool (full precision, or
int8/fp8 codes with float32 scale pools), one paged decode step
(:meth:`DecoderLM.decode_paged`), one speculative verify step
(:meth:`DecoderLM.decode_spec`), one packed varlen-prefill launch
(:meth:`DecoderLM.prefill_packed`) and one batch-1 prefill chunk
(:meth:`DecoderLM.prefill_paged_chunk`); the interleaved layout has no
paged form, as in the reference.  For the attention-free SSM family
(``family="ssm"``, Mamba-2) the same ``prefill``/``decode``/``forward`` over
a cache of per-layer SSD states ``(L, b, h, p, n)`` (float32) and
convolution histories ``(L, b, K-1, conv_dim)``; its state is not paged.
For the hybrid family (``family="hybrid"``, zamba2: groups of
``hybrid_attn_every`` Mamba-2 layers, each group followed by one attention
+ MLP block whose weights all groups share) the same three over the SSD
states and conv histories ``(G, E, b, ...)`` and the shared block's K/V
per group ``(G, b, S, kvh, d)``; ``S`` is ``max_seq``, or past
:data:`RING_THRESHOLD` a ring of ``long_context_window`` slots.  Its
state is not paged either.  The encoder-decoder family (``family="encdec"``,
whisper-large-v3; :class:`EncDecLM`, which :func:`build_model` gives it)
runs ``forward`` and the dense-cache ``prefill``/``decode`` over the
decoder's self-attention K/V and a cross cache of the encoder's K/V per
layer, on the static engine only; it has no paged form.
Layers run as a Python loop over a list of per-layer parameter dicts (JAX
scans stacked leaves); caches and pools stay stacked on a leading layer
axis and each layer writes its slice in place, where JAX returns updated
arrays.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, resolve_dtype
from ..kernels import decode_attention as _decode_attention
from ..kernels import kvquant, ops
from .config import ArchConfig
from .modules import (
    attn_decode,
    attn_decode_paged,
    attn_decode_spec,
    attn_defs,
    attn_full,
    attn_prefill_packed,
    attn_prefill_paged,
    cross_attn_decode,
    mamba_defs,
    mamba_forward,
    mamba_step,
    mlp_apply,
    mlp_defs,
    moe_apply,
    moe_defs,
    norm_defs,
    sinusoidal,
)
from .params import P, init_params


# the window of a global layer (``repro.models.lm._BIG_WINDOW``): wider than
# any sequence, so it masks no key; the kernels' ``q_pos - window + 1`` stays
# far inside int32 for any position below 2**30
GLOBAL_WINDOW = 1 << 30
# a hybrid model's cache longer than this holds its shared attention's K/V
# in a ring of ``cfg.long_context_window`` slots
# (``repro.models.lm._RING_THRESHOLD``)
RING_THRESHOLD = 65_536
# vocabulary columns per float32 slice of the LM head (bf16 on the CPU)
_HEAD_SLICE = 1 << 15
# the reference's reason for refusing a paged cache (``repro.models.lm``)
NOT_PAGED = ("paged KV cache supports dense/moe (non-interleaved) decoder caches only; "
             "ssm/hybrid state is not paged")
# the end of the reference's refusal of each paged path for the interleaved layout
_NOT_PAGED_INTERLEAVED = "supports dense/moe (non-interleaved) only"
# why the enc-dec family has no paged form (the reference's EncDecLM has no
# paged methods, and its engine serves the family through generate alone)
NOT_PAGED_ENCDEC = ("paged serving does not support encoder-decoder models (family encdec): "
                    "admission prefill would need per-request encoder frames, and the model "
                    "has no paged KV cache")
# the reference's reason for refusing a right-padded prefill
_NOT_RAGGED = ("ragged (right-padded) prefill requires a pure-attention cache; "
               "ssm/hybrid state would absorb the pad tokens")


def weights_fit(cfg: ArchConfig, dtype: torch.dtype, capacity: int) -> Optional[str]:
    """None if ``cfg``'s weights in ``dtype`` fit ``capacity`` bytes, else
    why not."""
    need = cfg.param_count() * torch.empty((), dtype=dtype).element_size()
    if need <= capacity:
        return None
    return (f"{cfg.name} at this width needs {need / 2**30:.1f} GiB of {dtype} weights, more "
            f"than the device's {capacity / 2**30:.1f} GiB: it runs reduced only on one card")


def _run(fn: Callable, remat: bool, *args):
    """``fn(*args)``, or with ``remat`` under activation checkpointing: only
    the inputs are saved and the body runs again in the backward, as
    ``jax.checkpoint`` does on the reference's scan body."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class _HeadProduct(torch.autograd.Function):
    """The bf16 LM head on the card with a derivative: the forward is the
    serving path's one cuBLAS product with a float32 output; the backward
    rounds the float32 cotangent to bf16, the operands' dtype, and runs two
    bf16 products (dx and dhead)."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ head.T, x2.T @ g


def _device_memory(device: torch.device) -> Optional[int]:
    """Bytes of memory on a CUDA device; None elsewhere (no limit checked)."""
    return torch.cuda.get_device_properties(device).total_memory if device.type == "cuda" \
        else None


class _BaseLM:
    """What every model of the port shares (``repro.models.lm.BaseModel``):
    the config, device and dtype, seeded ``init``, the norm, the token
    embedding, the float32 LM head and the prefill's last-token logits.

    ``device`` defaults to ``cuda`` (and raises where there is none);
    ``dtype`` is the weight and activation dtype: bf16 on the card, float32
    on the CPU unless given.  Softmax statistics and accumulation are
    float32 inside the kernels; logits are returned in float32."""

    def __init__(self, cfg: ArchConfig, device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype, None] = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        # sqrt(d_model) rounded to the model dtype, as the reference scales a
        # cast embedding by a weakly typed scalar
        self._embed_scale = (torch.tensor(math.sqrt(cfg.d_model), dtype=self.dtype).item()
                             if cfg.scale_embed else None)

    def param_defs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def init(self, seed: int = 0, dtype: Optional[torch.dtype] = None):
        """Random weights on the model's device from a seeded
        ``torch.Generator`` on that device, in the model's dtype or
        ``dtype`` (the trainer's float32 masters).  Raises ``MemoryError``
        before allocating anything where the weights alone exceed the
        card's memory (``weights_fit``)."""
        dtype = dtype or self.dtype
        capacity = _device_memory(self.device)
        why = weights_fit(self.cfg, dtype, capacity) if capacity is not None else None
        if why:
            raise MemoryError(why)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device, dtype)

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return ops.rmsnorm(x, w, self.cfg.norm_eps)

    def _embed_tokens(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens.long()]
        return x if self._embed_scale is None else x * self._embed_scale

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm, then the head product accumulated and returned in
        float32 (a tied head reads ``embed`` transposed, no copy), then the
        logit softcap where the config sets one."""
        cfg = self.cfg
        x = self._norm(x, params["final_norm"])
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        if x.dtype == torch.float32:
            logits = x @ head
        elif x.is_cuda:
            # bf16 operands, float32 output from one cuBLAS call, as the
            # reference's preferred_element_type=float32: nothing is rounded
            # to bf16 before the softcap and the argmax (the product has no
            # derivative in torch: training takes _HeadProduct)
            x2 = x.reshape(-1, x.shape[-1])
            logits = (_HeadProduct.apply(x2, head) if ops.wants_grad(x2, head)
                      else torch.mm(x2, head, out_dtype=torch.float32)
                      ).view(*x.shape[:-1], head.shape[1])
        else:
            # the CPU has no mm with a float32 output for bf16 operands: the
            # same product in float32, a slice of the vocabulary at a time so
            # that the head's float32 copy stays small
            xf = x.float()
            logits = torch.cat([xf @ head[:, i:i + _HEAD_SLICE].float()
                                for i in range(0, head.shape[1], _HEAD_SLICE)], dim=-1)
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits

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


class DecoderLM(_BaseLM):
    """Dense GQA decoder (``family="dense"``), mixture-of-experts decoder
    (``family="moe"``, interleaved with dense layers where ``moe_every``
    is 2), attention-free Mamba-2 stack (``family="ssm"``) or Mamba-2
    stack with a shared attention block (``family="hybrid"``); the
    enc-dec family raises (:func:`build_model` gives it
    :class:`EncDecLM`)."""

    def __init__(self, cfg: ArchConfig, device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype, None] = None) -> None:
        cfg.validate()
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(f"{cfg.name}: DecoderLM does not take family "
                                      f"{cfg.family}: build it with build_model")
        super().__init__(cfg, device, dtype)
        # the cache has no sequence axis (attention-free)
        self.ssm = cfg.family == "ssm"
        self.hybrid = cfg.family == "hybrid"
        # the state scans every token, pads too: prompts keep exact lengths
        # (left-padded), and the state has no paged form
        self.stateful = self.ssm or self.hybrid
        # llama4-style pairs of a dense and a MoE block (no paged layout)
        self.interleaved = cfg.family == "moe" and cfg.moe_every == 2
        self.windows = self._layer_windows()
        # the batch axis of each cache tensor (the continuous engine's slot copy)
        kv_axis = 2 if self.interleaved else 1
        if self.ssm:
            self.CACHE_BATCH_AXIS = {"pos": 0, "ssm": 1, "conv": 1}
        elif self.hybrid:
            self.CACHE_BATCH_AXIS = {"pos": 0, "ssm": 2, "conv": 2, "k": 1, "v": 1}
        else:
            self.CACHE_BATCH_AXIS = {"pos": 0, "k": kv_axis, "v": kv_axis}

    # -- params ---------------------------------------------------------------
    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        V, D = cfg.vocab_size, cfg.d_model
        L = cfg.num_layers

        def block(kind):
            if kind == "mamba":
                return {"ln": norm_defs(cfg), "mamba": mamba_defs(cfg)}
            mlp = (moe_defs(cfg) if kind == "moe"
                   else mlp_defs(cfg, cfg.dense_d_ff if self.interleaved else 0))
            blk = {"ln1": norm_defs(cfg), "attn": attn_defs(cfg), "ln2": norm_defs(cfg),
                   "mlp": mlp}
            if cfg.post_norms:
                blk.update(post_attn_norm=norm_defs(cfg), post_mlp_norm=norm_defs(cfg))
            return blk

        if self.interleaved:
            blocks = [{"a": block("dense"), "b": block("moe")} for _ in range(L // 2)]
        else:
            kind = {"ssm": "mamba", "hybrid": "mamba", "moe": "moe"}.get(cfg.family, "dense")
            blocks = [block(kind) for _ in range(L)]
        defs = {"embed": P((V, D)), "blocks": blocks, "final_norm": norm_defs(cfg)}
        if self.hybrid:
            defs["shared"] = {"ln1": norm_defs(cfg), "attn": attn_defs(cfg),
                              "ln2": norm_defs(cfg), "mlp": mlp_defs(cfg)}
        if not cfg.tie_embeddings:
            defs["lm_head"] = P((D, V))
        return defs

    # -- helpers ----------------------------------------------------------------
    def _layer_windows(self) -> List[Optional[int]]:
        """Each layer's attention window (``repro.models.lm._layer_windows``):
        with alternating local/global attention, layer ``l`` is global (and
        takes :data:`GLOBAL_WINDOW`) iff ``l % global_every == global_every -
        1``, else local with ``sliding_window``; otherwise None (no window)."""
        cfg = self.cfg
        if cfg.global_every <= 0 or cfg.sliding_window <= 0:
            return [None] * cfg.num_layers
        return [GLOBAL_WINDOW if l % cfg.global_every == cfg.global_every - 1
                else cfg.sliding_window for l in range(cfg.num_layers)]

    def _layers(self, params):
        """(layer, block, cache index) of each layer in order:
        ``params["blocks"][l]`` over ``k[l]``/``v[l]`` of the dense cache;
        in the interleaved layout each pair's dense block ``a`` then its MoE
        block ``b``, over ``k[l // 2, 0]`` and ``k[l // 2, 1]``."""
        if self.interleaved:
            for i, pair in enumerate(params["blocks"]):
                yield 2 * i, pair["a"], (i, 0)
                yield 2 * i + 1, pair["b"], (i, 1)
        else:
            yield from ((li, blk, li) for li, blk in enumerate(params["blocks"]))

    def _refuse_paged(self, what: str) -> None:
        """The reference's refusal of a paged path for the SSM and hybrid
        families and the interleaved layout (``what``: "paged decode",
        "packed paged prefill", ...)."""
        if self.stateful:
            raise NotImplementedError(NOT_PAGED)
        if self.interleaved:
            raise NotImplementedError(f"{what} {_NOT_PAGED_INTERLEAVED}")

    def _attn_residual(self, blk, x: torch.Tensor, a: torch.Tensor, with_aux: bool = False):
        """The rest of an attention block once attention has run on
        ``ln1(x)``: the attention output ``a`` (post-normed where the config
        has post-norms) added to the residual ``x``, then ln2 + MLP, or the
        mixture of experts where the block has a router (post-normed
        likewise), residual-added.  With ``with_aux`` returns (x, the
        block's MoE auxiliary loss, None for a dense block)."""
        post = self.cfg.post_norms
        if post:
            a = self._norm(a, blk["post_attn_norm"])
        x = x + a
        h = self._norm(x, blk["ln2"])
        aux = None
        if "router" in blk["mlp"]:
            m, aux = moe_apply(blk["mlp"], h, self.cfg, need_aux=with_aux)
        else:
            m = mlp_apply(blk["mlp"], h)
        if post:
            m = self._norm(m, blk["post_mlp_norm"])
        return (x + m, aux) if with_aux else x + m

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

    def _attn_block_full(self, blk, x: torch.Tensor, window: Optional[int],
                         with_aux: bool = False):
        """ln1 + attention over the sequence and ln2 + MLP (or MoE),
        residual-added; with ``with_aux`` also the MoE auxiliary loss."""
        a = attn_full(blk["attn"], self._norm(x, blk["ln1"]), self.cfg, window=window)
        return self._attn_residual(blk, x, a, with_aux)

    def _block_full(self, li: int, blk, x: torch.Tensor) -> torch.Tensor:
        return (self._mamba_block_full(blk, x) if self.stateful
                else self._attn_block_full(blk, x, self.windows[li]))

    def _shared_block_full(self, shared, x: torch.Tensor, return_kv: bool = False):
        """The hybrid family's shared block over the sequence: ln1 +
        attention (no window), residual-added, then ln2 + MLP,
        residual-added; with ``return_kv`` also the attention's K/V (b, s,
        kvh, d)."""
        out = attn_full(shared["attn"], self._norm(x, shared["ln1"]), self.cfg,
                        return_kv=return_kv)
        a, kv = out if return_kv else (out, None)
        x = x + a
        x = x + mlp_apply(shared["mlp"], self._norm(x, shared["ln2"]))
        return (x, kv) if return_kv else x

    def _shared_after(self, li: int) -> bool:
        """Whether the hybrid family's shared block follows layer ``li``:
        after every ``hybrid_attn_every``-th Mamba-2 layer, the end of a
        group."""
        E = self.cfg.hybrid_attn_every
        return self.hybrid and li % E == E - 1

    def cache_len(self, max_seq: int) -> int:
        """Slots of the attention cache: a hybrid model past
        :data:`RING_THRESHOLD` holds a ring of ``long_context_window``;
        otherwise ``max_seq``."""
        if self.hybrid and max_seq > RING_THRESHOLD:
            return self.cfg.long_context_window
        return max_seq

    # -- full sequence ------------------------------------------------------------
    def forward(self, params, batch: Dict[str, torch.Tensor], remat: bool = False):
        """Logits of every position of ``batch["tokens"]`` (b, s): float32
        (b, s, V), and the auxiliary loss, as the JAX model returns them:
        the MoE blocks' Switch losses summed over layers in float32 (0 for
        a dense or SSM model).  ``remat`` (training) checkpoints each layer
        body (each group of Mamba-2 layers and its shared block in the
        hybrid family, as the reference checkpoints its group body; each
        layer of an interleaved pair on its own, where the reference
        checkpoints the pair): the backward recomputes the body from its
        saved input."""
        x = self._embed_tokens(params, batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.ssm:
            for blk in params["blocks"]:
                x = _run(self._mamba_block_full, remat, blk, x)
        elif self.hybrid:
            E = self.cfg.hybrid_attn_every

            def group(g, x):
                for blk in params["blocks"][g * E:(g + 1) * E]:
                    x = self._mamba_block_full(blk, x)
                return self._shared_block_full(params["shared"], x)

            for g in range(len(params["blocks"]) // E):
                x = _run(group, remat, g, x)
        else:
            for li, blk, _ in self._layers(params):
                x, a = _run(lambda blk, x, w: self._attn_block_full(blk, x, w, with_aux=True),
                            remat, blk, x, self.windows[li])
                if a is not None:
                    aux = aux + a
        return self._logits(params, x), aux

    def forward_instrumented(self, params, batch: Dict[str, torch.Tensor],
                             hook: Callable[[str, Callable[[], torch.Tensor]], torch.Tensor]
                             ) -> torch.Tensor:
        """:meth:`forward`'s logits, computed layer by layer with
        ``hook(name, thunk)`` around each piece (the FRAMEWORK trace level;
        the counterpart of ``repro.models.lm._forward_instrumented_decoder``).
        The pieces are ``embed``, ``layer_{l:03d}_attn`` (dense and MoE; a
        windowed config's layers add ``_w{window}`` as the reference names
        them: ``_w1073741824`` on a global layer), ``layer_{l:03d}_dense``
        and ``layer_{l:03d}_moe`` (the interleaved layout's pairs) or
        ``layer_{l:03d}_mamba`` (ssm and hybrid; the hybrid family's shared
        block after group ``g`` is ``layer_{g:03d}_shared_attn``), and
        ``logits``.  Each piece runs the ops ``forward`` runs, in its
        order."""
        x = hook("embed", lambda: self._embed_tokens(params, batch["tokens"]))
        for l, blk, _ in self._layers(params):
            w = self.windows[l]
            kind = ("mamba" if self.stateful else ("dense", "moe")[l % 2] if self.interleaved
                    else "attn")
            name = f"layer_{l:03d}_{kind}" + ("" if w is None else f"_w{w}")
            x = hook(name, lambda l=l, blk=blk, x=x: self._block_full(l, blk, x))
            if self._shared_after(l):
                g = l // self.cfg.hybrid_attn_every
                x = hook(f"layer_{g:03d}_shared_attn",
                         lambda x=x: self._shared_block_full(params["shared"], x))
        return hook("logits", lambda: self._logits(params, x))

    # -- dense cache ------------------------------------------------------------------
    def cache_defs(self, batch: int, max_seq: int) -> Dict[str, tuple]:
        """Shapes of the dense cache: ``pos`` (b,) int32, the next position
        of each row, and K/V stacks (L, b, max_seq, kvh, d) (the interleaved
        layout: (L/2, 2, b, max_seq, kvh, d), a pair's dense layer then its
        MoE layer); for the SSM family the SSD states (L, b, h, p, n) and
        conv histories (L, b, K-1, conv_dim), whose size does not depend on
        ``max_seq``; for the hybrid family those states as (G, E, b, ...),
        group by layer of the group, and the shared block's K/V per group
        (G, b, S, kvh, d), ``S`` from :meth:`cache_len`."""
        cfg = self.cfg
        L = cfg.num_layers
        kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
        if self.stateful:
            n = cfg.ssm_state
            lead = (L,)
            defs = {"pos": (batch,)}
            if self.hybrid:
                E = cfg.hybrid_attn_every
                lead = (L // E, E)
                S = self.cache_len(max_seq)
                defs.update(k=(L // E, batch, S, kv, dh), v=(L // E, batch, S, kv, dh))
            defs.update(ssm=lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                        conv=lead + (batch, cfg.conv_kernel - 1, cfg.ssm_inner + 2 * n))
            return defs
        lead = (L // 2, 2) if self.interleaved else (L,)
        return {"pos": (batch,), "k": lead + (batch, max_seq, kv, dh),
                "v": lead + (batch, max_seq, kv, dh)}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """A zeroed cache: K/V and conv histories in the model's dtype (bf16
        on the card, float32 on the CPU), SSD states float32, ``pos``
        int32."""
        dtypes = {"pos": torch.int32, "ssm": torch.float32}
        return {
            k: torch.zeros(shape, device=self.device, dtype=dtypes.get(k, self.dtype))
            for k, shape in self.cache_defs(batch, max_seq).items()
        }

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill ``batch["tokens"]`` (b, s), optionally right-padded with
        ``batch["lengths"]`` (b,): every layer attends the prompt with one
        flash-attention launch and writes its K/V into positions ``[0, s)``
        of the dense cache, in place.  The SSM family scans every row from a
        zero state with one ``ssd`` launch per layer and writes each layer's
        final state and conv history; its rows are left-padded to one
        length and take no ``lengths``, as the pads flow through the state.
        The hybrid family does the same for its Mamba-2 layers, and its
        shared block writes each group's K/V: at ``[0, s)``, or, where the
        prompt is longer than a ring of ``S`` slots, its last ``S`` tokens
        each at slot ``pos % S``, as decode expects them.  Returns float32
        last-token logits (b, V)."""
        x = self._embed_tokens(params, batch["tokens"])
        s = x.shape[1]
        if self.stateful:
            if batch.get("lengths") is not None:
                raise NotImplementedError(_NOT_RAGGED)
            for li, blk in enumerate(params["blocks"]):
                x, state, conv = self._mamba_block_full(blk, x, return_state=True)
                at = self._state_index(li)
                cache["ssm"][at].copy_(state)
                cache["conv"][at].copy_(conv)
                if self._shared_after(li):
                    x, (k, v) = self._shared_block_full(params["shared"], x, return_kv=True)
                    g = li // self.cfg.hybrid_attn_every
                    self._write_prompt_kv(cache["k"][g], k)
                    self._write_prompt_kv(cache["v"][g], v)
            return self._prefill_logits(params, batch, x, cache)
        for li, blk, at in self._layers(params):
            a, (k, v) = attn_full(blk["attn"], self._norm(x, blk["ln1"]), self.cfg,
                                  window=self.windows[li], return_kv=True)
            cache["k"][at][:, :s] = k
            cache["v"][at][:, :s] = v
            x = self._attn_residual(blk, x, a)
        return self._prefill_logits(params, batch, x, cache)

    def _state_index(self, li: int):
        """Layer ``li``'s index into the SSD state and conv history stacks:
        ``li`` (ssm), ``(group, layer of the group)`` (hybrid)."""
        return divmod(li, self.cfg.hybrid_attn_every) if self.hybrid else li

    @staticmethod
    def _write_prompt_kv(dst: torch.Tensor, kv: torch.Tensor) -> None:
        """A prompt's K or V (b, s, kvh, d) into a group's cache (b, S, kvh,
        d), in place: at ``[0, s)``, or, where ``s > S`` (a ring shorter
        than the prompt), the last ``S`` tokens rolled so that position
        ``t`` lands at slot ``t % S``."""
        S, s = dst.shape[1], kv.shape[1]
        if s <= S:
            dst[:, :s] = kv
        else:
            dst.copy_(torch.roll(kv[:, -S:], (s - S) % S, dims=1))

    def decode(self, params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
               uniform_pos: bool = True, kv_bound: Optional[int] = None) -> torch.Tensor:
        """One token step over a dense cache.  ``tokens``: (b,) int32, the
        token at position ``cache["pos"]`` of each row; its K/V are written
        there in place and ``pos`` advances by one.  ``uniform_pos=False``
        writes each row at its own position (continuous batching);
        ``kv_bound`` is a host-known bound on the live lengths, so attention
        reads only that prefix of the cache.  The SSM family advances every
        layer's state and conv history in place (``uniform_pos`` and
        ``kv_bound`` do not apply).  The hybrid family does so too, and its
        shared block attends each group's cache as a ring (slot ``pos %
        S``: the same as a plain cache while ``pos < S``), at ``uniform_pos``
        and with no bound.  Returns float32 logits (b, V)."""
        pos = cache["pos"]
        x = self._embed_tokens(params, tokens)[:, None, :]          # (b, 1, D)
        if self.stateful:
            x1 = x[:, 0]
            for li, blk in enumerate(params["blocks"]):
                at = self._state_index(li)
                x1, state, conv = self._mamba_block_step(blk, x1, cache["ssm"][at],
                                                         cache["conv"][at])
                cache["ssm"][at].copy_(state)
                cache["conv"][at].copy_(conv)
                if self._shared_after(li):
                    x1 = self._shared_block_step(params["shared"], x1, cache, pos,
                                                 li // self.cfg.hybrid_attn_every, uniform_pos)
            pos.add_(1)
            return self._logits(params, x1)
        for li, blk, at in self._layers(params):
            a = attn_decode(blk["attn"], self._norm(x, blk["ln1"]), cache["k"][at],
                            cache["v"][at], pos, self.cfg, window=self.windows[li],
                            uniform_pos=uniform_pos, kv_bound=kv_bound)
            x = self._attn_residual(blk, x, a)
        pos.add_(1)
        return self._logits(params, x)[:, 0]

    def _shared_block_step(self, shared, x1: torch.Tensor, cache: Dict[str, torch.Tensor],
                           pos: torch.Tensor, g: int, uniform_pos: bool) -> torch.Tensor:
        """The hybrid family's shared block for one token a row (x1 (b, D))
        over group ``g``'s ring: ln1 + attention, residual-added, then ln2
        + MLP, residual-added."""
        x = x1[:, None]
        a = attn_decode(shared["attn"], self._norm(x, shared["ln1"]), cache["k"][g],
                        cache["v"][g], pos, self.cfg, ring=True, uniform_pos=uniform_pos)
        x = x + a
        x = x + mlp_apply(shared["mlp"], self._norm(x, shared["ln2"]))
        return x[:, 0]

    # -- paged KV pool --------------------------------------------------------------
    def paged_cache_defs(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None) -> Dict[str, tuple]:
        """Shapes of the paged KV layout: one global pool of ``page_size``-
        token pages per layer, indexed through per-request page tables.  An
        int8/fp8 ``kv_dtype`` adds the float32 scale pools, one scale per
        page row per kv head.  The SSM and hybrid families and the
        interleaved MoE layout have no paged layout."""
        if self.stateful or self.interleaved:
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
        self._refuse_paged("paged decode")
        pos = lengths.to(torch.int32)
        x = self._embed_tokens(params, tokens)[:, None, :]          # (b, 1, D)
        for li, blk in enumerate(params["blocks"]):
            kp, vp, ks, vs = self._layer_pools(cache, li)
            h = self._norm(x, blk["ln1"])
            a = attn_decode_paged(
                blk["attn"], h, kp, vp, page_table, pos, self.cfg, window=self.windows[li],
                pages_bound=pages_bound, k_scales=ks, v_scales=vs,
            )
            x = self._attn_residual(blk, x, a)
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
        self._refuse_paged("speculative paged decode")
        pos = lengths.to(torch.int32)
        wlens = window_lens.to(torch.int32)
        x = self._embed_tokens(params, tokens)                       # (b, W, D)
        for li, blk in enumerate(params["blocks"]):
            kp, vp, ks, vs = self._layer_pools(cache, li)
            h = self._norm(x, blk["ln1"])
            a = attn_decode_spec(
                blk["attn"], h, kp, vp, page_table, pos, wlens, self.cfg,
                window=self.windows[li], pages_bound=pages_bound, k_scales=ks, v_scales=vs,
            )
            x = self._attn_residual(blk, x, a)
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
        self._refuse_paged("packed paged prefill")
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
                blk["attn"], h, kp, vp, meta, self.cfg, window=self.windows[li],
                pages_bound=pages_bound, k_scales=ks, v_scales=vs,
            )
            x = self._attn_residual(blk, x, a)
        last = batch["last_idx"].long()
        return self._logits(params, x[0, last][:, None, :])[:, 0]

    def prefill_paged_chunk(self, params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                            page_row: torch.Tensor, last_index: int, pos0: int) -> torch.Tensor:
        """One chunked-prefill step: the (1, c) prompt chunk ``tokens``
        starting at page-aligned position ``pos0`` attends the request's
        paged context (``page_row``: (max_pages,) int32 physical pages) and
        itself, each layer in one flash-attention launch, and writes its
        K/V into the request's pages in place.  The chunk may be right-
        padded to a page multiple; ``last_index`` is the offset of its last
        real token.  Returns float32 logits (1, V) at ``last_index`` (only
        the final chunk's matter: their argmax is the first new token)."""
        self._refuse_paged("chunked paged prefill")
        x = self._embed_tokens(params, tokens)                       # (1, c, D)
        for li, blk in enumerate(params["blocks"]):
            kp, vp, ks, vs = self._layer_pools(cache, li)
            h = self._norm(x, blk["ln1"])
            a = attn_prefill_paged(blk["attn"], h, kp, vp, page_row, pos0, self.cfg,
                                   window=self.windows[li], k_scales=ks, v_scales=vs)
            x = self._attn_residual(blk, x, a)
        return self._logits(params, x[:, last_index:last_index + 1])[:, 0]


class EncDecLM(_BaseLM):
    """Encoder–decoder (``family="encdec"``, whisper-style; the audio front
    end is a stub: the model takes precomputed frame embeddings ``(b, Se,
    D)``), the port's ``repro.models.lm.EncDecLM``.  The encoder adds
    :func:`~repro_torch.models.modules.sinusoidal` positions to the frames
    and runs ``encoder_layers`` non-causal attention + GELU MLP blocks, then
    ``enc_norm``; the decoder adds sinusoidal positions to its token
    embeddings and runs ``num_layers`` blocks of causal self-attention,
    cross-attention over the encoder output and the GELU MLP (pre-norms
    ``ln1``/``ln2``/``ln3``), then the final norm and the LM head.  No RoPE
    anywhere.  The frames are cast to the model's dtype on entry: the
    reference adds float32 frames to a bf16 model's positions and so runs
    its encoder in float32, where the port keeps a bf16 model's encoder in
    bf16 (in float32 the two agree exactly).

    It serves from a dense cache through ``generate`` (the static engine)
    alone: ``serve_continuous`` and ``serve_paged`` refuse it, as the
    reference does, and its paged methods raise."""

    # the decoder's self-attention keys are its right-padded prompt tokens:
    # right-padded prefill and kv-bounded decode are exact
    stateful = False

    def __init__(self, cfg: ArchConfig, device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype, None] = None) -> None:
        cfg.validate()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM takes family encdec, not {cfg.family}")
        super().__init__(cfg, device, dtype)
        # the cross cache's slots: encoder_seq rounded up to the whole 16-key
        # pages that the bf16 decode-attention kernel views a dense cache as
        m = _decode_attention.BLOCK_K
        self.cross_len = -(-cfg.encoder_seq // m) * m

    # -- params ---------------------------------------------------------------
    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        V, D = cfg.vocab_size, cfg.d_model
        enc = [{"ln1": norm_defs(cfg), "attn": attn_defs(cfg), "ln2": norm_defs(cfg),
                "mlp": mlp_defs(cfg, gated=False)} for _ in range(cfg.encoder_layers)]
        dec = [{"ln1": norm_defs(cfg), "self_attn": attn_defs(cfg), "ln2": norm_defs(cfg),
                "cross_attn": attn_defs(cfg, cross=True), "ln3": norm_defs(cfg),
                "mlp": mlp_defs(cfg, gated=False)} for _ in range(cfg.num_layers)]
        return {"embed": P((V, D)), "enc_blocks": enc, "enc_norm": norm_defs(cfg),
                "dec_blocks": dec, "final_norm": norm_defs(cfg), "lm_head": P((D, V))}

    def cache_len(self, max_seq: int) -> int:
        """Slots of the self-attention cache: ``max_seq``."""
        return max_seq

    def _refuse_paged(self, *_args, **_kw):
        raise NotImplementedError(f"{self.cfg.name}: {NOT_PAGED_ENCDEC}")

    paged_cache_defs = init_paged_cache = _refuse_paged
    decode_paged = decode_spec = prefill_packed = prefill_paged_chunk = _refuse_paged

    # -- encoder ----------------------------------------------------------------
    def _positions(self, positions: torch.Tensor) -> torch.Tensor:
        return sinusoidal(positions, self.cfg.d_model).to(self.dtype)

    def _enc_embed(self, frames: torch.Tensor) -> torch.Tensor:
        """The frames (b, Se, D) in the model's dtype on its device, plus the
        sinusoidal positions ``[0, Se)``."""
        x = frames.to(device=self.device, dtype=self.dtype)
        return x + self._positions(torch.arange(x.shape[1], device=self.device))

    def _enc_layer(self, blk, x: torch.Tensor) -> torch.Tensor:
        x = x + attn_full(blk["attn"], self._norm(x, blk["ln1"]), self.cfg, causal=False,
                          use_rope=False)
        return x + mlp_apply(blk["mlp"], self._norm(x, blk["ln2"]))

    def encode(self, params, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """The encoder output (b, Se, D) of frame embeddings ``frames`` (b,
        Se, D): one non-causal flash-attention launch and two rmsnorms per
        layer (each layer checkpointed with ``remat``), then ``enc_norm``."""
        x = self._enc_embed(frames)
        for blk in params["enc_blocks"]:
            x = _run(self._enc_layer, remat, blk, x)
        return self._norm(x, params["enc_norm"])

    # -- decoder ------------------------------------------------------------------
    def _embed_dec(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = self._embed_tokens(params, tokens)
        return x + self._positions(torch.arange(x.shape[1], device=x.device))

    def _dec_layer(self, blk, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + attn_full(blk["self_attn"], self._norm(x, blk["ln1"]), cfg, use_rope=False)
        x = x + attn_full(blk["cross_attn"], self._norm(x, blk["ln2"]), cfg, use_rope=False,
                          kv_from=enc)
        return x + mlp_apply(blk["mlp"], self._norm(x, blk["ln3"]))

    def forward(self, params, batch: Dict[str, torch.Tensor], remat: bool = False):
        """Logits of every position of ``batch["tokens"]`` (b, s) over the
        encoding of ``batch["frames"]`` (b, Se, D): float32 (b, s, V), and
        the auxiliary loss (0), as the JAX model returns them.  ``remat``
        checkpoints each encoder and decoder layer."""
        enc = self.encode(params, batch["frames"], remat=remat)
        x = self._embed_dec(params, batch["tokens"])
        for blk in params["dec_blocks"]:
            x = _run(self._dec_layer, remat, blk, x, enc)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def forward_instrumented(self, params, batch: Dict[str, torch.Tensor],
                             hook: Callable[[str, Callable[[], torch.Tensor]], torch.Tensor]
                             ) -> torch.Tensor:
        """:meth:`forward`'s logits piece by piece with ``hook(name, thunk)``
        around each (``repro.models.lm._forward_instrumented_encdec``):
        ``enc_embed``, ``enc_layer_{l:03d}``, ``enc_norm``, ``dec_embed``,
        ``dec_layer_{l:03d}``, ``logits``."""
        x = hook("enc_embed", lambda: self._enc_embed(batch["frames"]))
        for l, blk in enumerate(params["enc_blocks"]):
            x = hook(f"enc_layer_{l:03d}", lambda blk=blk, x=x: self._enc_layer(blk, x))
        enc = hook("enc_norm", lambda x=x: self._norm(x, params["enc_norm"]))
        x = hook("dec_embed", lambda: self._embed_dec(params, batch["tokens"]))
        for l, blk in enumerate(params["dec_blocks"]):
            x = hook(f"dec_layer_{l:03d}", lambda blk=blk, x=x: self._dec_layer(blk, x, enc))
        return hook("logits", lambda: self._logits(params, x))

    # -- dense caches ---------------------------------------------------------------
    def cache_defs(self, batch: int, max_seq: int) -> Dict[str, tuple]:
        """Shapes of the cache: ``pos`` (b,) int32, the decoder's
        self-attention K/V (L, b, max_seq, kvh, d) and the encoder's K/V of
        every layer's cross-attention ``k_cross``/``v_cross`` (L, b,
        ``cross_len``, kvh, d).  ``cross_len`` is ``encoder_seq`` rounded up
        to a multiple of 16 (whisper: 1504 slots for 1500 frames), where
        the reference's cross cache holds ``encoder_seq`` slots: the bf16
        decode-attention kernel views a dense cache as 16-key pages.  The
        pad slots stay zero and are never read."""
        cfg = self.cfg
        L, kv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        return {"pos": (batch,),
                "k": (L, batch, max_seq, kv, dh), "v": (L, batch, max_seq, kv, dh),
                "k_cross": (L, batch, self.cross_len, kv, dh),
                "v_cross": (L, batch, self.cross_len, kv, dh)}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """A zeroed cache: K/V in the model's dtype, ``pos`` int32."""
        return {
            k: torch.zeros(shape, device=self.device,
                           dtype=torch.int32 if k == "pos" else self.dtype)
            for k, shape in self.cache_defs(batch, max_seq).items()
        }

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Encode ``batch["frames"]`` (b, encoder_seq, D), then prefill
        ``batch["tokens"]`` (b, s), optionally right-padded with
        ``batch["lengths"]`` (b,): every decoder layer attends the prompt
        causally with one flash-attention launch and writes its K/V into
        positions ``[0, s)`` of the self cache, then attends the encoder
        output with one non-causal launch and writes that K/V into the
        first ``encoder_seq`` slots of the cross cache, in place.  Returns
        float32 last-token logits (b, V)."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        Se = enc.shape[1]
        if Se != cfg.encoder_seq:
            raise ValueError(f"{cfg.name}: {Se} frames, the cross cache holds {cfg.encoder_seq}")
        x = self._embed_dec(params, batch["tokens"])
        s = x.shape[1]
        for l, blk in enumerate(params["dec_blocks"]):
            a, (k, v) = attn_full(blk["self_attn"], self._norm(x, blk["ln1"]), cfg,
                                  use_rope=False, return_kv=True)
            cache["k"][l][:, :s] = k
            cache["v"][l][:, :s] = v
            x = x + a
            c, (kx, vx) = attn_full(blk["cross_attn"], self._norm(x, blk["ln2"]), cfg,
                                    use_rope=False, kv_from=enc, return_kv=True)
            cache["k_cross"][l][:, :Se] = kx
            cache["v_cross"][l][:, :Se] = vx
            x = x + c
            x = x + mlp_apply(blk["mlp"], self._norm(x, blk["ln3"]))
        return self._prefill_logits(params, batch, x, cache)

    def decode(self, params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
               uniform_pos: bool = True, kv_bound: Optional[int] = None) -> torch.Tensor:
        """One token step: ``tokens`` (b,) int32 at positions ``cache["pos"]``
        plus their sinusoidal positions; per layer the self-attention writes
        its K/V there in place and attends ``pos + 1`` keys (at most
        ``kv_bound``; ``uniform_pos`` as in :meth:`DecoderLM.decode`), then
        the cross-attention attends the ``encoder_seq`` cached encoder
        keys; ``pos`` advances by one.  Two decode-attention launches and
        three rmsnorms a layer.  Returns float32 logits (b, V)."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed_tokens(params, tokens)[:, None, :]          # (b, 1, D)
        x = x + self._positions(pos[:, None])
        for l, blk in enumerate(params["dec_blocks"]):
            x = x + attn_decode(blk["self_attn"], self._norm(x, blk["ln1"]), cache["k"][l],
                                cache["v"][l], pos, cfg, use_rope=False,
                                uniform_pos=uniform_pos, kv_bound=kv_bound)
            x = x + cross_attn_decode(blk["cross_attn"], self._norm(x, blk["ln2"]),
                                      cache["k_cross"][l], cache["v_cross"][l], cfg)
            x = x + mlp_apply(blk["mlp"], self._norm(x, blk["ln3"]))
        pos.add_(1)
        return self._logits(params, x)[:, 0]


def build_model(cfg: ArchConfig, device: Union[str, torch.device, None] = None,
                dtype: Union[str, torch.dtype, None] = None) -> Union[DecoderLM, EncDecLM]:
    """The model of ``cfg``'s family (``repro.models.lm.build_model``):
    :class:`EncDecLM` for ``encdec``, else :class:`DecoderLM`."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device, dtype)
    return DecoderLM(cfg, device, dtype)
