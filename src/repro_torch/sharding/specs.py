"""Logical-axis -> mesh-axis sharding rules (the port's copy of
``repro.sharding.specs``).

Models annotate parameters (:attr:`repro_torch.models.params.P.axes`) with
*logical* axis names; these rules map them onto the axes of the port's
mesh: a ``torch.distributed.device_mesh.DeviceMesh`` with dim names
``("data", "model")`` (:func:`repro_torch.launch.mesh.make_host_mesh`), or
a plain ``{axis: size}`` mapping where no process group exists.  Only the
axis sizes are read here.

Batch-like logical axes shard over ("pod", "data"); tensor-parallel axes
(heads / kv / ffn / vocab / experts / inner) over "model"; with ``fsdp``
the weights' "embed" dims shard over the batch axes too (ZeRO-3: a layer's
leaves are all-gathered over the data group before it runs).  A dim that
does not divide its mesh axes falls back to replication (granite-20b's one
kv head, or glm4-9b's two on a 4-way model axis).  In place of the
reference's ``PartitionSpec`` tree, :func:`leaf_splits` gives each leaf
its splits, ``((dim, mesh axes), ...)``: none for a replicated leaf, two
for an FSDP weight that also splits over "model"; :func:`param_pspecs`
(the serving paths' one-dim view) gives ``(dim, mesh axis)`` or None;
:func:`local_shape` gives a rank's shard shape and :func:`shard_params`
cuts a full parameter tree to one rank's shards.  Every function here
reads the mesh's axis sizes only, so the production meshes
(:func:`repro_torch.launch.mesh.make_production_mesh`, 256 and 512
devices) are plain mappings.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
# a leaf's split: (the dim cut into equal shards, the mesh axis it spans)
Split = Optional[Tuple[int, MeshAxes]]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its dim names and
    shape) or of a mapping of axis sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    raise TypeError(f"not a mesh: {type(mesh).__name__} (a DeviceMesh with dim names, or a "
                    f"mapping of axis sizes)")


@dataclass(frozen=True)
class ShardingRules:
    """One arch x mode sharding policy: logical axis -> mesh axes.

    ``opts`` gates the reference's beyond-baseline levers, so that the
    baseline and each lever are both reproducible:

    * ``gather_kv_once``    — all-gather seq-sharded K/V once per layer
                              instead of once per flash KV-block (the
                              reference's training lever; the port's dense
                              decode gathers a seq-sharded cache once per
                              layer always, and its training shardings are
                              not ported)
    * ``rs_block_outputs``  — reduce-scatter the block outputs of a packed
                              prefill over tokens instead of all-reducing
                              them (the paged serving path)
    * ``ssd_shard_p``       — shard the SSD head_dim (p) over "model" when
                              the head count can't split it (not ported:
                              the ssm and hybrid families' shardings)
    * ``moe_decode_gather`` — the one-token MoE path computes only the
                              selected experts
                              (:func:`repro_torch.models.modules.moe_apply`)
    """

    mesh: Any
    fsdp: bool = False          # shard weight "embed" dims over data axes
    rules: Dict[str, MeshAxes] = field(default_factory=dict)
    opts: Dict[str, bool] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    def axis_size(self, axes: MeshAxes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        shape = self.shape
        size = 1
        for a in axes:
            size *= shape[a]
        return size

    def mesh_axes_for(self, logical: Optional[str], dim: int) -> MeshAxes:
        """Resolve a logical axis to mesh axes, honouring divisibility."""
        if logical is None:
            return None
        axes = self.rules.get(logical)
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        shape = self.shape
        # drop trailing axes until the dim divides evenly
        cur: Tuple[str, ...] = tuple(a for a in axes if a in shape)
        while cur:
            size = 1
            for a in cur:
                size *= shape[a]
            if dim % size == 0:
                return cur if len(cur) > 1 else cur[0]
            cur = cur[:-1]
        return None


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes a batch dimension shards over (pod composes with data)."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def default_rules(mesh, fsdp: bool = False) -> ShardingRules:
    b = batch_axes(mesh)
    rules: Dict[str, MeshAxes] = {
        # --- weights ---
        "vocab": "model",
        "heads": "model",
        "kv": "model",
        "ffn": "model",
        "experts": "model",
        "expert_ffn": None,
        "inner": "model",
        "inner_all": "model",
        "conv_dim": "model",
        "ssm_heads": "model",
        "embed": b if fsdp else None,   # FSDP: weight embed dims over data
        "head_dim": None,
        "layer": None,
        "group": None,
        # --- activations ---
        "batch": b,
        "act_embed": None,
        "act_heads": "model",
        "act_kv": "model",
        "act_ffn": "model",
        "seq": None,
        "kv_seq": None,                 # "model" where kv heads don't shard (dryrun.rules_for)
        "act_experts": "model",
        "act_vocab": "model",
        "ssm_p": "model",
        "state": None,
    }
    return ShardingRules(mesh=mesh, fsdp=fsdp, rules=rules)


def serve_rules(mesh, *, rs_block_outputs: bool = False) -> ShardingRules:
    """Tensor-parallel rules for the paged serving stack: the default rules
    (heads / kv / ffn / vocab / experts on "model"), plus the
    ``rs_block_outputs`` lever, which puts the packed-prefill token axis
    on "model" so that the row-parallel block outputs reduce-scatter over
    tokens instead of all-reducing.  Decode launches keep the all-reduce."""
    rules = default_rules(mesh)
    if rs_block_outputs:
        rules = replace(
            rules,
            rules={**rules.rules, "seq": "model"},
            opts={**rules.opts, "rs_block_outputs": True},
        )
    return rules


def heads_shard_axis(heads: int, kv_heads: int):
    """(mesh, axis) the serving attention shards its head dims over, or
    None when the current rules do not tensor-parallelize this head
    layout: the query-head AND kv-head counts must resolve to the SAME
    single mesh axis (a GQA group never straddles shards); either count
    failing divisibility falls back to replication, as the weight and
    pool dims do."""
    rules = activation_rules()
    if rules is None:
        return None
    ah = rules.mesh_axes_for("act_heads", heads)
    ak = rules.mesh_axes_for("act_kv", kv_heads)
    if not isinstance(ah, str) or ah != ak:
        return None
    if rules.axis_size(ah) <= 1:
        return None
    return rules.mesh, ah


def tp_degree(rules: Optional[ShardingRules], heads: int, kv_heads: int) -> int:
    """Effective tensor-parallel degree of one head layout: the "model"
    axis size when the heads split, else 1 (the replication fallback)."""
    if rules is None:
        return 1
    with set_activation_rules(rules):
        info = heads_shard_axis(heads, kv_heads)
    return rules.axis_size(info[1]) if info else 1


def _dedup(dims):
    """Drop mesh axes already claimed by an earlier dim (earlier dim wins)."""
    used = set()
    out = []
    for d in dims:
        axes = (d,) if isinstance(d, str) else tuple(d or ())
        keep = tuple(a for a in axes if a not in used)
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(keep)
    return out


def logical_pspec(rules: ShardingRules, axes: Sequence[Optional[str]],
                  shape: Sequence[int]) -> Tuple[MeshAxes, ...]:
    """Mesh axes of each dim of a tensor with logical ``axes`` (the
    reference's ``PartitionSpec`` as a tuple)."""
    return tuple(_dedup([rules.mesh_axes_for(a, d) for a, d in zip(axes, shape)]))


def leaf_splits(rules: ShardingRules, p, path: str = "") -> Tuple[Tuple[int, MeshAxes], ...]:
    """Every split of one def leaf ``p`` (a
    :class:`~repro_torch.models.params.P`): ``(dim, mesh axes)`` for each
    dim its logical axis puts on the mesh, in dim order (the reference's
    ``PartitionSpec`` less its None entries)."""
    axes = p.axes if p.axes is not None else (None,) * len(p.shape)
    if len(axes) != len(p.shape):
        raise ValueError(f"{path}: axes {axes} rank != shape {p.shape}")
    spec = logical_pspec(rules, axes, p.shape)
    return tuple((i, a) for i, a in enumerate(spec) if a is not None)


def leaf_split(rules: ShardingRules, p, path: str = "") -> Split:
    """The one split of a def leaf ``p`` on the serving paths (the paged
    engine, which cuts one dim), or None; a leaf split on two dims (an
    FSDP weight) raises: take :func:`leaf_splits`."""
    splits = leaf_splits(rules, p, path)
    if len(splits) > 1:
        raise NotImplementedError(
            f"{path}: split on {len(splits)} dims {splits}; the paged serving engine cuts one "
            f"dim (FSDP weights run through the dense prefill and decode: leaf_splits)")
    return splits[0] if splits else None


def local_shape(rules: ShardingRules, p, path: str = "") -> Tuple[int, ...]:
    """The shape of one rank's shard of def leaf ``p``: each split dim
    divided by its mesh axes' size."""
    shape = list(p.shape)
    for dim, axes in leaf_splits(rules, p, path):
        shape[dim] //= rules.axis_size(axes)
    return tuple(shape)


def param_pspecs(defs, rules: ShardingRules):
    """Each leaf's split ``(dim, mesh axis)``, or None where it stays
    whole, as a tree matching the def tree."""
    from ..models.params import tree_map_defs

    return tree_map_defs(lambda path, p: leaf_split(rules, p, path), defs)


def coordinate(mesh, rank: int, axes: MeshAxes) -> int:
    """The index of ``rank`` along mesh ``axes`` (one axis, or several read
    as one, the first the slowest), with ranks laid out row-major over the
    mesh's axes, as ``init_device_mesh`` lays them."""
    shape = mesh_shape(mesh)
    coord = {}
    for name in reversed(list(shape)):
        coord[name] = rank % shape[name]
        rank //= shape[name]
    index = 0
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        index = index * shape[a] + coord[a]
    return index


def shard_params(params, rules: ShardingRules, rank: int, *, defs):
    """One rank's shards of a full port parameter tree (from ``init_params``,
    ``from_jax`` or :func:`~repro_torch.models.params.param_specs`): each
    split leaf cut along each split dim into ``axes size`` equal pieces,
    the piece at ``rank``'s coordinate copied out, so the full tree can be
    freed; a replicated leaf is kept as it is.  ``defs`` is the model's
    def tree, which carries the logical axes."""
    from ..models.params import tree_map_defs

    splits = tree_map_defs(lambda path, p: leaf_splits(rules, p, path), defs)

    def walk(node, split, path):
        if isinstance(node, dict):
            return {k: walk(v, split[k], f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, s, f"{path}/{i}") for i, (v, s) in enumerate(zip(node, split))]
        return shard_leaf(node, split, rules, rank)

    return walk(params, splits, "")


def shard_leaf(t: torch.Tensor, split, rules: ShardingRules, rank: int) -> torch.Tensor:
    """Rank ``rank``'s piece of one full leaf ``t`` under ``split``: one
    ``(dim, mesh axes)``, a tuple of them (:func:`leaf_splits`), or None
    (``t`` itself).  The piece is a copy, never a view that would keep the
    whole leaf alive."""
    if not split:
        return t
    for dim, axes in ((split,) if isinstance(split[0], int) else split):
        t = t.chunk(rules.axis_size(axes), dim=dim)[coordinate(rules.mesh, rank, axes)]
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# the rules active in model code
# ---------------------------------------------------------------------------
_ctx = threading.local()


def set_activation_rules(rules: Optional[ShardingRules]):
    """Context manager making ``rules`` the active rules of this thread
    (the engine enters it around each launch)."""

    class _Ctx:
        def __enter__(self):
            self.prev = getattr(_ctx, "rules", None)
            _ctx.rules = rules
            return rules

        def __exit__(self, *exc):
            _ctx.rules = self.prev

    return _Ctx()


def activation_rules() -> Optional[ShardingRules]:
    return getattr(_ctx, "rules", None)


def opt_enabled(name: str) -> bool:
    """Whether a beyond-baseline lever is on under the active rules."""
    rules = activation_rules()
    return bool(rules is not None and rules.opts.get(name))
