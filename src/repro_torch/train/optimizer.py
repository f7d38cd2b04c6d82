"""AdamW with warmup+cosine schedule, clipping and int8 gradient compression
(the port's ``repro.train.optimizer``).

The optimizer state mirrors the parameter tree: ``{"step": int32 (), "m":
tree, "v": tree}``, the moments in ``m_dtype``/``v_dtype``.  The update is
the reference's formula, ``delta = mhat / (sqrt(vhat) + eps) + wd * p``, in
float32, and it happens in place under ``torch.no_grad()``: the parameter,
moment and gradient tensors are overwritten (at glm4-9b's widths a second
copy of the float32 masters and moments would not fit the card), so the
trees handed in are the trees handed back.  Every scalar (the step, the
learning rate, the global norm) stays a 0-dim tensor on the parameters'
device, so a step forces no host sync.  ``opt_state_specs`` (sharding) is
not ported: tensor parallelism is ROADMAP item 9.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Union

import torch

from ..device import resolve_device, resolve_dtype
from ..models.params import P, tree_map_defs


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "float32"
    v_dtype: str = "float32"
    compress_grads: bool = False


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts and lists, in insertion order (trees
    built from one def tree list their leaves alike)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_rebuild(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    return _fill(tree, iter(leaves))


def _fill(tree, it):
    # a module-level walk: a closure that calls itself is a reference cycle,
    # and one over the leaves' iterator would hold every leaf (a step's
    # gradients, gigabytes on the card) until the garbage collector ran
    if isinstance(tree, dict):
        return {k: _fill(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, it) for v in tree)
    return next(it)


def lr_at(step: Union[int, torch.Tensor], cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr``, float32, on
    ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def opt_state_defs(model_defs, cfg: OptimizerConfig):
    """P-tree of the state: the step and (m, v) mirroring the parameter
    def tree."""

    def mk(dtype: str):
        dt = resolve_dtype(dtype, torch.device("cpu"))
        return lambda path, p: P(p.shape, "zeros", dtype=dt)

    return {
        "step": P((), "zeros", dtype=torch.int32),
        "m": tree_map_defs(mk(cfg.m_dtype), model_defs),
        "v": tree_map_defs(mk(cfg.v_dtype), model_defs),
    }


def init_opt_state(model_defs, cfg: OptimizerConfig,
                   device: Union[str, torch.device, None] = None):
    """A zero state on ``device`` (cuda unless the caller asks)."""
    dev = resolve_device(device)
    return tree_map_defs(lambda path, p: torch.zeros(p.shape, dtype=p.dtype, device=dev),
                         opt_state_defs(model_defs, cfg))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squares, in float32."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in tree_leaves(tree)]
    return torch.sqrt(sum(n * n for n in norms))


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled by ``min(1, max_norm / norm)``, norm); new tensors."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_rebuild(tree, [g * scale.to(g.dtype) for g in tree_leaves(tree)]), norm


def quantize_int8(g: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Stochastic-rounding int8 quantize/dequantize (per-tensor scale), the
    noise uniform in [-0.5, 0.5) from ``generator`` (on g's device)."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    noise = torch.rand(g.shape, generator=generator, device=g.device, dtype=torch.float32) - 0.5
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127).to(torch.int8)
    return (q.float() * scale).to(g.dtype)


def compress_gradients(grads, seed: Union[int, torch.Tensor]):
    """Int8 compression numerics leaf by leaf: leaf ``i`` draws its noise
    from a ``torch.Generator`` seeded with ``seed * 65536 + i`` (the seed is
    the step; reading it syncs, so a compressed step waits for the card)."""
    base = int(seed) * 65_536
    out = []
    for i, g in enumerate(tree_leaves(grads)):
        gen = torch.Generator(device=g.device)
        gen.manual_seed(base + i)
        out.append(quantize_int8(g, gen))
    return tree_rebuild(grads, out)


@torch.no_grad()
def adamw_update(params, grads, state: Dict[str, Any], cfg: OptimizerConfig):
    """One AdamW step, in place.  Returns (params, state, metrics) as the
    reference does: the same parameter tree, updated; the state with the
    advanced step and the updated moments; ``{"grad_norm", "lr"}`` as 0-dim
    float32 tensors.  ``grads`` is consumed: clipping scales it in place."""
    step = state["step"] + 1
    if cfg.compress_grads:
        grads = compress_gradients(grads, step)
    flat_g = tree_leaves(grads)
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in flat_g:
        g.mul_(scale.to(g.dtype))
    lr = lr_at(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        gf = g.float()
        mf = m if m.dtype == torch.float32 else m.float()
        vf = v if v.dtype == torch.float32 else v.float()
        mf.mul_(b1).add_(gf, alpha=1 - b1)
        vf.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        pf = p if p.dtype == torch.float32 else p.float()
        delta = (mf / bc1).div_(torch.sqrt(vf / bc2).add_(cfg.eps))
        delta.add_(pf, alpha=cfg.weight_decay)
        pf.sub_(delta.mul_(lr))
        for dst, src in ((m, mf), (v, vf), (p, pf)):
            if dst is not src:
                dst.copy_(src)
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
