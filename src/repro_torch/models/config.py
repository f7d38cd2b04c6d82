"""Architecture configuration (a copy of ``repro.models.config``).

One :class:`ArchConfig` instance fully determines a model: family, block
structure, attention variant, MoE/SSM parameters. The configurations live
in :mod:`repro_torch.configs`; each also provides a ``REDUCED`` variant for
CPU tests. The port keeps its own copy so that it never imports ``repro``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 0
    # attention variants
    sliding_window: int = 0      # >0: local attention window (where used)
    global_every: int = 0        # >0: layer l is GLOBAL iff l % global_every == global_every-1
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    qk_norm: bool = False
    post_norms: bool = False     # gemma2-style post-attn/post-mlp norms
    tie_embeddings: bool = False
    scale_embed: bool = False    # gemma-style sqrt(d_model) embedding scale
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1           # 2 = alternate dense/MoE layers (llama4-style)
    dense_d_ff: int = 0          # FFN width of interleaved dense layers
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4
    hybrid_attn_every: int = 0   # zamba2: shared attention after every k SSM layers
    # enc-dec
    encoder_layers: int = 0
    encoder_seq: int = 0         # fixed encoder context (whisper: 1500 frames)
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # serving: attention window used by hybrid archs at very long context
    long_context_window: int = 4096

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode? (assignment: ssm/hybrid only)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "hybrid", "ssm", "encdec"), self.family
        if self.family in ("dense", "moe", "encdec"):
            assert self.num_heads > 0 and self.num_kv_heads > 0
            assert self.num_heads % self.num_kv_heads == 0, "GQA grouping"
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0
            assert self.moe_every in (1, 2)
            if self.moe_every == 2:
                assert self.num_layers % 2 == 0 and self.dense_d_ff > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.ssm_inner % self.ssm_head_dim == 0
        if self.family == "hybrid":
            assert self.hybrid_attn_every > 0
            assert self.num_layers % self.hybrid_attn_every == 0
        if self.family == "encdec":
            assert self.encoder_layers > 0 and self.encoder_seq > 0

    # approximate parameter counts (used for MODEL_FLOPS = 6·N·D)
    def param_count(self, active_only: bool = False) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, dh = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        if self.family in ("dense", "encdec"):
            per_layer = attn + 3 * D * F
            total += L * per_layer
            if self.family == "encdec":
                # encoder self-attn + mlp, decoder already counted; add cross-attn
                total += self.encoder_layers * (attn + 3 * D * F)
                total += L * attn  # cross-attention in decoder
        elif self.family == "moe":
            experts = self.experts_per_token if active_only else self.num_experts
            moe_layers = L // self.moe_every
            dense_layers = L - moe_layers
            total += moe_layers * (attn + D * self.num_experts + experts * 3 * D * F)
            total += dense_layers * (attn + 3 * D * self.dense_d_ff)
        elif self.family in ("ssm", "hybrid"):
            din, n, hh = self.ssm_inner, self.ssm_state, self.ssm_heads
            in_proj = D * (2 * din + 2 * n + hh)
            per_layer = in_proj + self.conv_kernel * (din + 2 * n) + din * D
            total += L * per_layer
            if self.family == "hybrid":
                total += attn + 3 * D * F  # one shared attention+mlp block
        return total
