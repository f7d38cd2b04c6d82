"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]
(copy of ``repro.configs.zamba2_2p7b``).

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Adaptations (DESIGN.md §Arch-applicability): the shared transformer block is
applied after every 6th Mamba2 layer with a single shared parameter set; at
>64k-token decode its attention runs on a ``long_context_window`` ring cache
(the sub-quadratic long-context path).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    hybrid_attn_every=6,
    long_context_window=4096,
)

REDUCED = CONFIG.replace(
    name="zamba2-2.7b-reduced",
    num_layers=4,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    hybrid_attn_every=2,
    long_context_window=64,
)
