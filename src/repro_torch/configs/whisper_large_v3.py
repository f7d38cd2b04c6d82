"""whisper-large-v3 — encoder-decoder ASR backbone [arXiv:2212.04356; unverified]
(copy of ``repro.configs.whisper_large_v3``).

32L (enc) + 32L (dec), d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
The conv/audio frontend is a STUB: the model takes 1500 precomputed
log-mel frame embeddings (b, 1500, d_model). Sinusoidal positions on both
stacks (adaptation: the decoder's learned positions are replaced by
sinusoidal — DESIGN.md).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    vocab_size=51866,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    encoder_layers=32,
    encoder_seq=1500,
)

REDUCED = CONFIG.replace(
    name="whisper-large-v3-reduced",
    num_layers=2,
    d_model=64,
    vocab_size=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    encoder_layers=2,
    encoder_seq=16,
)
