"""granite-20b — llama-arch dense, code model, MQA [arXiv:2405.04324; hf].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Copy of ``repro.configs.granite_20b``.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    vocab_size=49152,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
)

REDUCED = CONFIG.replace(
    name="granite-20b-reduced",
    num_layers=3,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
)
