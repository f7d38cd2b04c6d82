"""qwen3-moe-30b-a3b — 128 experts, top-8 routing [hf:Qwen/Qwen3-30B-A3B; hf] (copy of
``repro.configs.qwen3_moe_30b_a3b``).

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936.
head_dim=128 and QK-norm per the HF config.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    vocab_size=151936,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    num_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    name="qwen3-moe-30b-a3b-reduced",
    num_layers=2,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    num_experts=8,
    experts_per_token=2,
    capacity_factor=2.0,
)
