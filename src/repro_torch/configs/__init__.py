"""Architecture configs of the port (copies of ``repro.configs``).

Each ``<id>.py`` exports ``CONFIG`` (the published configuration) and
``REDUCED`` (a same-family small config for CPU tests), in the
reference's order: the hybrid ``zamba2-2.7b`` (Mamba-2 layers with
one shared attention block after every sixth, its attention on a ring
cache past 64k tokens), the MoE decoders ``qwen3-moe-30b-a3b`` (128
experts, top 8, QK-norm) and ``llama4-maverick-400b-a17b`` (dense and MoE
layers interleaved, top 1), the dense decoders ``deepseek-67b``,
``granite-20b`` (MQA), ``glm4-9b``, ``gemma2-27b`` (sliding/global
windows, softcaps, post-norms, scaled embeddings) and ``chameleon-34b``
(QK-norm), the attention-free SSM ``mamba2-130m``, and the
encoder-decoder ``whisper-large-v3`` (32 encoder and 32 decoder layers over
1500 precomputed audio frames; its audio front end is a stub, as in the
reference).  That is every ``ArchConfig`` of the reference.  The paper's
ResNet-50 is no ``ArchConfig`` in either package: its config is
``repro_torch.models.resnet.ResNetConfig``.
"""
from __future__ import annotations

from importlib import import_module
from typing import List

from ..models.config import ArchConfig

# canonical ids (dashes) -> module names
_ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "deepseek-67b": "deepseek_67b",
    "granite-20b": "granite_20b",
    "glm4-9b": "glm4_9b",
    "gemma2-27b": "gemma2_27b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-130m": "mamba2_130m",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in _ALIASES.values():
        raise ValueError(f"unknown architecture {arch!r}; available: {list_archs()}")
    mod = import_module(f".{mod_name}", __package__)
    return mod.REDUCED if reduced else mod.CONFIG


def list_archs() -> List[str]:
    return list(_ALIASES)
