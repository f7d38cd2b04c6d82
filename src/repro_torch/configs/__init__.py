"""Architecture configs the port supports so far (copies of ``repro.configs``).

Each ``<id>.py`` exports ``CONFIG`` (the published configuration) and
``REDUCED`` (a same-family small config for CPU tests).  Ported so far: the
dense decoder ``glm4-9b`` and the attention-free SSM ``mamba2-130m``; the
other architectures of ``repro.configs`` follow with the model families
that need them.
"""
from __future__ import annotations

from importlib import import_module
from typing import List

from ..models.config import ArchConfig

# canonical ids (dashes) -> module names
_ALIASES = {
    "glm4-9b": "glm4_9b",
    "mamba2-130m": "mamba2_130m",
}


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in _ALIASES.values():
        raise ValueError(
            f"architecture {arch!r} is not ported yet; available: {list_archs()}"
        )
    mod = import_module(f".{mod_name}", __package__)
    return mod.REDUCED if reduced else mod.CONFIG


def list_archs() -> List[str]:
    return list(_ALIASES)
