"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060; unverified]
(copy of ``repro.configs.mamba2_130m``).

24L d_model=768 vocab=50280, ssm_state=128, d_ff=0 (the Mamba2 block is both
mixer and channel path); d_inner=1536, head_dim=64 -> 24 SSD heads.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50280,
    d_ff=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    name="mamba2-130m-reduced",
    num_layers=3,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
)
