"""glm4-9b — RoPE + GQA dense [hf:THUDM/glm-4-9b; hf] (copy of
``repro.configs.glm4_9b``).

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    vocab_size=151552,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
)

REDUCED = CONFIG.replace(
    name="glm4-9b-reduced",
    num_layers=3,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
)
