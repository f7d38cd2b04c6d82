"""The port's kernels, serving and training: plain PyTorch versions
(:mod:`.ref`), hand-written CUDA kernels for sm_90a (``csrc/``, built by
:mod:`._build`) and their wrappers, dispatched by device in :mod:`.ops`."""
from __future__ import annotations

import functools
import importlib
import pkgutil
from types import ModuleType
from typing import Dict


@functools.cache
def kernel_counters() -> Dict[str, ModuleType]:
    """Each kernel wrapper module of this package that counts its launches
    (a ``launches`` attribute), by name; built on the first call."""
    mods = (importlib.import_module(f"{__name__}.{m.name}") for m in pkgutil.iter_modules(__path__))
    return {mod.__name__.rsplit(".", 1)[1]: mod for mod in mods if hasattr(mod, "launches")}
