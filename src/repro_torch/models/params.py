"""Parameter definitions, initialisation and the bridge from JAX weights.

A model describes its parameters once as a tree (dicts and per-layer lists)
of :class:`P` leaves.  :func:`init_params` materialises the tree on the
target device, directly in the target dtype, from an explicit
``torch.Generator``; :func:`from_jax` converts the pytree of
``repro``'s ``model.init`` (stacked ``*blocks`` subtrees) into the port's
layout (one dict per layer), so both packages can run identical weights;
:func:`resnet_from_jax` does the same for ResNet-50's tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class P:
    """One parameter leaf: its shape, its init (``normal``, ``zeros``,
    ``ones``, ``ssm_a`` or ``dt_bias``), the standard deviation of
    ``normal``, and a dtype that overrides the model's for this leaf (the
    SSD scalars stay float32 in a bf16 model)."""

    shape: Tuple[int, ...]
    init: str = "normal"
    std: float = 0.02
    dtype: Optional[torch.dtype] = None


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
    """Materialise a def tree on ``device`` in ``dtype`` (or the leaf's own
    dtype).  The leaves draw in tree order from ``generator``, which must
    live on ``device``.  ``ssm_a`` and ``dt_bias`` follow the JAX package's
    Mamba-2 inits: ``A_log = log(u)``, u uniform in [1, 16], and
    ``dt_bias = log(expm1(u))``, u uniform in [1e-3, 1e-1], so that
    ``softplus(dt_bias)`` spans [1e-3, 1e-1]."""

    def uniform(p: P, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(p.shape, generator=generator, device=device, dtype=torch.float32)
        return u.mul_(hi - lo).add_(lo)

    def make(path: str, p: P) -> torch.Tensor:
        ldtype = p.dtype or dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, device=device, dtype=ldtype)
        if p.init == "ones":
            return torch.ones(p.shape, device=device, dtype=ldtype)
        if p.init == "normal":
            t = torch.randn(p.shape, generator=generator, device=device, dtype=ldtype)
            return t.mul_(p.std)
        if p.init == "ssm_a":
            return uniform(p, 1.0, 16.0).log_().to(ldtype)
        if p.init == "dt_bias":
            return uniform(p, 1e-3, 1e-1).expm1_().log_().to(ldtype)
        raise ValueError(f"unknown init {p.init!r} at {path}")

    return tree_map_defs(make, defs)


# leaves a mamba block keeps in float32 whatever the model dtype (JAX's
# ``BaseModel._cast_mamba``)
FP32_LEAVES = frozenset({"A_log", "D", "dt_bias"})


def from_jax(params: Dict[str, Any], device="cpu", dtype=torch.float32):
    """Convert a ``repro`` model's parameter pytree (leaves anything
    ``numpy.asarray`` takes) into the port's layout: every stacked subtree
    whose name ends in ``blocks`` (``blocks``; the enc-dec family's
    ``enc_blocks`` and ``dec_blocks``), leaves of shape ``(L, ...)``,
    becomes a list of ``L`` per-layer dicts; every other leaf keeps its name
    and shape.  Leaves go to ``dtype``, except the SSD scalars
    (:data:`FP32_LEAVES`), which stay float32."""

    def conv(x, name: str) -> torch.Tensor:
        arr = np.array(np.asarray(x), dtype=np.float32)
        return torch.from_numpy(arr).to(
            device=device, dtype=torch.float32 if name in FP32_LEAVES else dtype)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return conv(node, name)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return node[i].contiguous()

    out = {}
    for k, v in params.items():
        out[k] = walk(v, k)
        if k.endswith("blocks"):
            out[k] = [layer(out[k], i) for i in range(_leading_dim(out[k]))]
    return out


def resnet_from_jax(params: Dict[str, Any], device="cpu", dtype=torch.float32):
    """Convert ``repro.models.resnet.ResNet``'s parameter tree into the
    port's: every convolution weight (the 4-d leaves) from JAX's HWIO to
    OIHW; the stage dicts ``stages[str(i)][str(b)]``, the folded norms'
    ``scale``/``bias`` and the ``(8 * 4 * width, classes)`` head keep their
    names and shapes."""

    def conv(x) -> torch.Tensor:
        arr = np.array(np.asarray(x), dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return conv(node)

    return walk(params)


def _leading_dim(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int(node.shape[0])
