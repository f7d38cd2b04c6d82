"""The collectives of tensor-parallel serving: the one module of the port
that calls ``torch.distributed``.

Each function works over the ``model`` group of the active rules
(:func:`~repro_torch.sharding.specs.activation_rules`, whose mesh is a
``DeviceMesh``): :func:`all_reduce` (the row-parallel close of an
attention or MLP block, and the vocab-parallel embedding),
:func:`reduce_scatter` over tokens (the ``rs_block_outputs`` lever) and
:func:`all_gather` (the vocab-parallel logits, the tokens a
reduce-scatter left on other ranks, and a layer's K/V where the cache's
sequence dim is split over "model"); :func:`all_gather_data` gathers an
FSDP weight over the batch axes ("pod", "data") under rules with
``fsdp``.  With no rules, or a group of one, each is the identity.  A
collective runs on the tensor's own device: two ranks that share one card
run gloo on CUDA tensors (NCCL refuses two ranks on one device); where the
backend does not take the op on that device, the call raises with the
op's name; it is never routed through the host here.  A failed collective
raises.  Under the roofline's counter each collective adds its entry to
the ledger (:func:`repro_torch.roofline.count.collective`).

:func:`counting` opens a counting world: a mesh of any size (the
production meshes' 256 and 512 devices) seen from one rank, with no
process and no group.  Inside it each collective runs exactly the aten ops
it runs in a real world (the same copies, buffers and concatenations) but
the exchange itself, and writes the same ledger entry, so a count of a
rank's program there equals the count of the same rank in a real world.
It takes meta tensors only (their values are never read) and raises on
any other, so it can never stand in for a real world.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Mapping, Optional, Tuple

import torch

from ..roofline import count
from .specs import MeshAxes, activation_rules, coordinate, mesh_shape


class CollectiveError(RuntimeError):
    """A collective of tensor-parallel serving failed or is not supported."""


class CountingWorld:
    """The mesh's axis sizes and the one rank the count is made for."""

    def __init__(self, sizes: Mapping[str, int], rank: int = 0) -> None:
        self.sizes = mesh_shape(sizes)
        n = 1
        for v in self.sizes.values():
            n *= v
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n} devices {self.sizes}")
        self.rank = rank


_counting: Optional[CountingWorld] = None


@contextlib.contextmanager
def counting(sizes: Mapping[str, int], rank: int = 0) -> Iterator[CountingWorld]:
    """A counting world over a mesh of ``sizes`` (``{axis: size}``), seen
    from ``rank`` (see the module); the active rules' mesh must have the
    same sizes."""
    global _counting
    prev = _counting
    _counting = CountingWorld(sizes, rank)
    try:
        yield _counting
    finally:
        _counting = prev


def _counting_group(rules, axes: MeshAxes, size: int) -> Tuple[str, int, int]:
    if mesh_shape(rules.mesh) != _counting.sizes:
        raise CollectiveError(f"the rules' mesh {mesh_shape(rules.mesh)} is not the counting "
                              f"world's {_counting.sizes}")
    name = axes if isinstance(axes, str) else "+".join(axes)
    return name, size, coordinate(rules.mesh, _counting.rank, axes)


def model_group():
    """(process group of the active rules' model axis, its size, this
    rank's index in it); (None, 1, 0) where no rules are active or the
    axis is 1 wide.  In a counting world the group is the axis' name."""
    rules = activation_rules()
    if rules is None:
        return None, 1, 0
    size = mesh_shape(rules.mesh).get("model", 1)
    if size <= 1:
        return None, 1, 0
    if _counting is not None:
        return _counting_group(rules, "model", size)
    get_group = getattr(rules.mesh, "get_group", None)
    if get_group is None:
        raise CollectiveError(
            f"a model axis of {size} needs a DeviceMesh over a process group, not "
            f"{type(rules.mesh).__name__} (run the ranks through repro_torch.launch.mesh)")
    import torch.distributed as dist

    group = get_group("model")
    return group, size, dist.get_rank(group)


def data_group(axes: MeshAxes):
    """(process group of mesh ``axes`` (some of the batch axes, "pod" and
    "data") of the active rules, its size, this rank's index over them)
    where the rules shard weights over them (``fsdp``); (None, 1, 0)
    elsewhere.  A real world takes a "data" axis only; a counting world
    any."""
    rules = activation_rules()
    if rules is None or not rules.fsdp:
        return None, 1, 0
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    size = rules.axis_size(axes)
    if size <= 1:
        return None, 1, 0
    if _counting is not None:
        return _counting_group(rules, axes if len(axes) > 1 else axes[0], size)
    if axes != ("data",) or getattr(rules.mesh, "get_group", None) is None:
        raise CollectiveError(f"FSDP over {axes} needs a DeviceMesh with a data axis (run the "
                              f"ranks through repro_torch.launch.mesh)")
    import torch.distributed as dist

    group = rules.mesh.get_group("data")
    return group, size, dist.get_rank(group)


def _run(name: str, fn, t: torch.Tensor, what: str = "model"):
    """Run the exchange ``fn`` (the counting world runs none)."""
    if _counting is not None:
        # the counting world: the exchange is the one thing not run
        if t.device.type != "meta":
            raise CollectiveError(f"{name} in a counting world on a tensor on {t.device}: it "
                                  f"takes meta tensors only and never stands in for a real "
                                  f"world")
        return None
    try:
        return fn()
    except (RuntimeError, ValueError, NotImplementedError) as e:
        raise CollectiveError(
            f"{name} over the {what} group failed on a {t.dtype} tensor on {t.device}: {e}"
        ) from e


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group, in place where ``x`` is
    contiguous (callers hand it a fresh partial): every rank gets the same
    bits.  ``x`` itself where the group is one rank."""
    group, size, _ = model_group()
    if size == 1:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    with count.collective("all-reduce", "model", size, _nbytes(x), buffers=(x,)):
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
    with count.collective("reduce-scatter", "model", size, _nbytes(x), buffers=(out, *pieces)):
        _run("reduce_scatter", lambda: dist.reduce_scatter(out, pieces, group=group), x)
    return out


def _gather(x: torch.Tensor, dim: int, group, size: int, what: str) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    with count.collective("all-gather", what, size, _nbytes(x) * size, buffers=(x, *parts)):
        _run("all_gather", lambda: dist.all_gather(parts, x, group=group), x, what)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    group, size, _ = model_group()
    if size == 1:
        return x
    return _gather(x, dim, group, size, "model")


def all_gather_data(x: torch.Tensor, dim: int, axes: MeshAxes) -> torch.Tensor:
    """Every rank's ``x`` over mesh ``axes`` (:func:`data_group`: an FSDP
    weight's shards over the batch axes) concatenated along ``dim`` in rank
    order."""
    group, size, _ = data_group(axes)
    if size == 1:
        return x
    return _gather(x, dim, group, size, "data")


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
