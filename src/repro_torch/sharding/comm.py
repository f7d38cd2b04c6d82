"""The collectives of tensor-parallel serving: the one module of the port
that calls ``torch.distributed``.

Each function works over the ``model`` group of the active rules
(:func:`~repro_torch.sharding.specs.activation_rules`, whose mesh is a
``DeviceMesh``): :func:`all_reduce` (the row-parallel close of an
attention or MLP block, and the vocab-parallel embedding),
:func:`reduce_scatter` over tokens (the ``rs_block_outputs`` lever) and
:func:`all_gather` (the vocab-parallel logits, and the tokens a
reduce-scatter left on other ranks).  With no rules, or a model axis of
one, each is the identity.  A collective runs on the tensor's own device:
two ranks that share one card run gloo on CUDA tensors (NCCL refuses two
ranks on one device); where the backend does not take the op on that
device, the call raises with the op's name; it is never routed through
the host here.  A failed collective raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .specs import activation_rules, mesh_shape


class CollectiveError(RuntimeError):
    """A collective of tensor-parallel serving failed or is not supported."""


def model_group():
    """(process group of the active rules' model axis, its size, this
    rank's index in it); (None, 1, 0) where no rules are active or the
    axis is 1 wide."""
    rules = activation_rules()
    if rules is None:
        return None, 1, 0
    size = mesh_shape(rules.mesh).get("model", 1)
    if size <= 1:
        return None, 1, 0
    get_group = getattr(rules.mesh, "get_group", None)
    if get_group is None:
        raise CollectiveError(
            f"a model axis of {size} needs a DeviceMesh over a process group, not "
            f"{type(rules.mesh).__name__} (run the ranks through repro_torch.launch.mesh)")
    import torch.distributed as dist

    group = get_group("model")
    return group, size, dist.get_rank(group)


def _run(name: str, fn, t: torch.Tensor):
    try:
        return fn()
    except (RuntimeError, ValueError, NotImplementedError) as e:
        raise CollectiveError(
            f"{name} over the model group failed on a {t.dtype} tensor on {t.device}: {e}"
        ) from e


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group, in place where ``x`` is
    contiguous (callers hand it a fresh partial): every rank gets the same
    bits.  ``x`` itself where the group is one rank."""
    group, size, _ = model_group()
    if size == 1:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    _run("all_reduce", lambda: dist.all_reduce(x, group=group), x)
    return x


def reduce_scatter(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the model group, cut along ``dim`` into equal
    pieces, this rank's piece (``x.shape[dim]`` must divide the group)."""
    group, size, _ = model_group()
    if size == 1:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide "
                         f"the model group's {size} ranks")
    import torch.distributed as dist

    pieces = [p.contiguous() for p in x.chunk(size, dim=dim)]
    out = torch.empty_like(pieces[0])
    _run("reduce_scatter", lambda: dist.reduce_scatter(out, pieces, group=group), x)
    return out


def all_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    group, size, _ = model_group()
    if size == 1:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    _run("all_gather", lambda: dist.all_gather(parts, x, group=group), x)
    return torch.cat(parts, dim=dim)


def model_rank() -> int:
    """This rank's index in the model group (0 without one)."""
    return model_group()[2]


def world_check(flag: bool, group=None) -> bool:
    """Whether ``flag`` holds on every rank of ``group`` (the default
    group where None): one all-reduce of a max, so that every rank
    returns the same answer and none waits alone for a collective."""
    import torch.distributed as dist

    t = torch.tensor([0 if flag else 1], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item()) == 0


def broadcast_object(obj, group=None):
    """Rank 0's ``obj`` on every rank of ``group`` (pickled, on the host)."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def model_rank_of(rules) -> int:
    """This rank's index in the model group of ``rules``' mesh (0 without
    one)."""
    group = group_of(rules)
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def group_of(rules) -> Optional[object]:
    """The model group of ``rules``' mesh, or None."""
    get_group = getattr(getattr(rules, "mesh", None), "get_group", None)
    return get_group("model") if get_group is not None else None
