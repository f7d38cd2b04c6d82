"""gemma2-27b — alternating local/global attention, logit softcaps
[arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; 4096-token sliding
window on local layers (every other layer global), attn softcap 50, final
logit softcap 30, tied + scaled embeddings, pre+post norms.
Copy of ``repro.configs.gemma2_27b``.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    vocab_size=256000,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    sliding_window=4096,
    global_every=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    scale_embed=True,
)

REDUCED = CONFIG.replace(
    name="gemma2-27b-reduced",
    num_layers=4,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    sliding_window=8,
)
