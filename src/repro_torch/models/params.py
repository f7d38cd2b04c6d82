"""Parameter definitions, initialisation and the bridge from JAX weights.

A model describes its parameters once as a tree (dicts and per-layer lists)
of :class:`P` leaves.  :func:`init_params` materialises the tree on the
target device, directly in the target dtype, from an explicit
``torch.Generator``; :func:`from_jax` converts the pytree of
``repro``'s ``model.init`` (stacked ``blocks/*`` leaves) into the port's
layout (one dict per layer), so both packages can run identical weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class P:
    """One parameter leaf: its shape, its init (``normal`` or ``zeros``)
    and the standard deviation of ``normal``."""

    shape: Tuple[int, ...]
    init: str = "normal"
    std: float = 0.02


def tree_map_defs(fn, defs, path: str = ""):
    """Map ``fn(path, P) -> value`` over a def tree, keeping its structure."""
    if isinstance(defs, P):
        return fn(path, defs)
    if isinstance(defs, dict):
        return {k: tree_map_defs(fn, v, f"{path}/{k}") for k, v in defs.items()}
    if isinstance(defs, list):
        return [tree_map_defs(fn, v, f"{path}/{i}") for i, v in enumerate(defs)]
    raise TypeError(f"bad def node at {path}: {type(defs)}")


def count_params(defs) -> int:
    total = 0

    def add(path: str, p: P) -> None:
        nonlocal total
        total += int(np.prod(p.shape))

    tree_map_defs(add, defs)
    return total


def init_params(defs, generator: torch.Generator, device: torch.device,
                dtype: torch.dtype):
    """Materialise a def tree on ``device`` in ``dtype``.  The leaves draw in
    tree order from ``generator``, which must live on ``device``."""

    def make(path: str, p: P) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, device=device, dtype=dtype)
        if p.init == "normal":
            t = torch.randn(p.shape, generator=generator, device=device, dtype=dtype)
            return t.mul_(p.std)
        raise ValueError(f"unknown init {p.init!r} at {path}")

    return tree_map_defs(make, defs)


def from_jax(params: Dict[str, Any], device="cpu", dtype=torch.float32):
    """Convert a ``repro`` ``DecoderLM`` parameter pytree (leaves anything
    ``numpy.asarray`` takes) into the port's layout: the stacked
    ``blocks/*`` leaves of shape ``(L, ...)`` become a list of ``L``
    per-layer dicts; every other leaf keeps its name and shape."""

    def conv(x) -> torch.Tensor:
        arr = np.array(np.asarray(x), dtype=np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return conv(node)

    out = {k: walk(v) for k, v in params.items() if k != "blocks"}
    blocks = walk(params["blocks"])
    num_layers = _leading_dim(blocks)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return node[i].contiguous()

    out["blocks"] = [layer(blocks, i) for i in range(num_layers)]
    return out


def _leading_dim(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int(node.shape[0])
