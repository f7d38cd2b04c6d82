"""chameleon-34b — early-fusion VLM with VQ image tokens [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The modality
frontend is a STUB: VQ-VAE image codes are token ids inside the 65536
vocabulary, so ``input_specs()`` provides interleaved text+image token ids.
QK-norm as in the published training recipe.
Copy of ``repro.configs.chameleon_34b``.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="dense",
    num_layers=48,
    d_model=8192,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    qk_norm=True,
)

REDUCED = CONFIG.replace(
    name="chameleon-34b-reduced",
    num_layers=3,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
)
