"""deepseek-67b — llama-arch dense [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
Copy of ``repro.configs.deepseek_67b``.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    vocab_size=102400,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    name="deepseek-67b-reduced",
    num_layers=3,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
)
