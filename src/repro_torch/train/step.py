"""Training step: loss, microbatch gradient accumulation, remat (the port's
``repro.train.step``).

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``.  ``params`` are the masters (float32); the model
computes in its own dtype (bf16 on the card), so each step casts the
masters to a compute copy (the SSD scalars ``A_log``, ``D`` and
``dt_bias`` stay float32, as ``_cast_mamba`` keeps them), takes the
gradients of that copy by ``torch.autograd.grad`` and carries them back to
the masters' dtype, which is what autodiff through the reference's cast
gives.  With ``cast_params_once`` the copy is made once a step, before the
microbatch loop; otherwise once a microbatch, as the reference's model
casts inside its forward.  Microbatches split the batch on its first axis
and sum their gradients in ``accum_dtype`` (only one microbatch's
activations are live at a time); ``remat`` checkpoints each layer body.
The metrics are 0-dim tensors on the device: a step forces no host sync.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import torch

from ..device import resolve_dtype
from ..models.params import FP32_LEAVES
from .optimizer import OptimizerConfig, adamw_update, tree_rebuild

AUX_LOSS_WEIGHT = 0.01


def make_loss_fn(model, remat: bool = False):
    """Next-token cross entropy (+ MoE aux loss); labels = shifted tokens."""

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = model.forward(params, batch, remat=remat)
        tgt = batch["tokens"][:, 1:].long()
        lg = logits[:, :-1].float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
        ce = torch.mean(logz - gold)
        loss = ce + AUX_LOSS_WEIGHT * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    return loss_fn


def _named_leaves(tree, name: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _named_leaves(v, name)]
    return [(name, tree)]


def cast_params(model, params):
    """The compute copy of a master tree: every leaf in the model's dtype
    except the SSD scalars, which stay float32."""
    return tree_rebuild(params, [t if name in FP32_LEAVES or t.dtype == model.dtype
                             else t.to(model.dtype) for name, t in _named_leaves(params)])


def make_grad_fn(
    model,
    microbatches: int = 1,
    remat: bool = False,
    accum_dtype: Union[str, torch.dtype] = torch.float32,
    cast_params_once: bool = False,
) -> Callable:
    """``(params, batch) -> (grads, metrics)``: the gradients of the mean
    loss with respect to the masters, in their dtype with one microbatch,
    else summed in ``accum_dtype`` and divided by ``microbatches``; the
    metrics (loss, ce, aux) averaged over the microbatches."""
    loss_fn = make_loss_fn(model, remat=remat)
    accum_dtype = resolve_dtype(accum_dtype, model.device)

    def compute_leaves(masters):
        return [t.detach().requires_grad_() for _, t in _named_leaves(cast_params(model, masters))]

    def grad_fn(params, batch):
        masters = [t for _, t in _named_leaves(params)]

        def micro(i):
            def cut(t):
                b = t.shape[0]
                assert b % microbatches == 0, (b, microbatches)
                return t.reshape(microbatches, b // microbatches, *t.shape[1:])[i]

            return {k: cut(t) for k, t in batch.items()}

        leaves = compute_leaves(params) if cast_params_once else None
        acc, met_sum = None, None
        for i in range(microbatches):
            lv = leaves if leaves is not None else compute_leaves(params)
            _, metrics = loss_fn(tree_rebuild(params, lv), micro(i) if microbatches > 1 else batch)
            grads = torch.autograd.grad(metrics["loss"], lv, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, lv)]
            metrics = {k: v.detach() for k, v in metrics.items()}
            if microbatches == 1:
                return (tree_rebuild(params, [g.to(p.dtype) for g, p in zip(grads, masters)]),
                        metrics)
            if acc is None:
                acc = [g.to(accum_dtype, copy=True) for g in grads]
                met_sum = metrics
            else:
                for a, g in zip(acc, grads):
                    a.add_(g.to(accum_dtype))
                met_sum = {k: met_sum[k] + v for k, v in metrics.items()}
            del grads
        for a in acc:
            a.div_(microbatches)
        return tree_rebuild(params, acc), {k: v / microbatches for k, v in met_sum.items()}

    return grad_fn


def make_train_step(
    model,
    opt_cfg: OptimizerConfig,
    microbatches: int = 1,
    remat: bool = True,
    accum_dtype: Union[str, torch.dtype] = torch.float32,
    grad_shardings=None,
    cast_params_once: bool = False,
):
    """The reference's train step on the port's model.  ``grad_shardings``
    pins gradients to a tensor-parallel layout (ROADMAP item 9, not
    ported): anything but None raises."""
    if grad_shardings is not None:
        raise NotImplementedError("grad_shardings is tensor parallelism (ROADMAP item 9): "
                                  "not ported")
    grad_fn = make_grad_fn(model, microbatches, remat, accum_dtype, cast_params_once)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
