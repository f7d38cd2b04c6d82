"""llama4-maverick-400b-a17b — MoE, early fusion [hf:meta-llama/Llama-4-*; unverified] (copy of
``repro.configs.llama4_maverick_400b_a17b``).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048,
MoE 128 experts top-1. Early-fusion multimodality enters as token ids
(frontend stub); text-only token stream here. Per the published model,
MoE layers interleave with dense layers (every other layer, dense FFN
16384), which lands the totals at ~400B / ~17B-active.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    vocab_size=202048,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    num_experts=128,
    experts_per_token=1,
    capacity_factor=1.25,
    moe_every=2,
    dense_d_ff=16384,
    rope_theta=500_000.0,
)

REDUCED = CONFIG.replace(
    name="llama4-maverick-400b-a17b-reduced",
    num_layers=2,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    num_experts=8,
    experts_per_token=1,
    capacity_factor=2.0,
    moe_every=2,
    dense_d_ff=128,
)
