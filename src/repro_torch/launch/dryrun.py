"""Production dry run: count one device's program of every (arch x shape x
mesh) cell without running it (the port's ``repro.launch.dryrun``).

For a serving cell (``prefill_32k``, ``decode_32k``) of the dense and MoE
families this builds the model on PyTorch's ``meta`` device, takes one
rank's shards of its weights (:func:`~repro_torch.models.params.param_specs`
and ``shard_params``) and of the cache (``init_cache(rules=)``), and runs
``prefill`` or one ``decode`` step on them under the cell's rules inside a
counting world of the production mesh (:func:`repro_torch.sharding.comm.
counting`: 16 x 16 = 256 devices, or 2 x 16 x 16 = 512 across two pods)
and the roofline's counter (:func:`repro_torch.roofline.count.count_call`).
Meta tensors hold shapes and dtypes and no data, so nothing is allocated
on any device and no kernel runs: the kernels' wrappers pass their checks
and return the outputs and workspaces their launchers allocate.  The
counter gives the cell's FLOPs, bytes, collectives (each one's ledger
entry) and memory per device, which ``roofline_from_costs`` turns into the
reference's ``RooflineReport``; the JSON keys are the reference's, so
:mod:`repro_torch.launch.report` (or the reference's own report) renders
either package's cells.  ``chip_smoke.py`` holds these counts against the
same program run on the card, at tp 1 and on two ranks: equal FLOPs,
bytes and collectives, and ``max_memory_allocated`` against
``peak_per_device_bytes``.

Not ported yet (``status: "not_ported"``, the reason "ROADMAP item 9c"):
the train cells (the optimizer's and gradients' shardings, sequence
parallelism, ``gather_kv_once``, the backward's collectives) and the ssm,
hybrid and encdec families' cells.  A full-attention arch's ``long_500k``
cell is ``skip``, as in the reference (not applicable).  The reference's
``tpu_estimate_bytes`` is left out: it repairs an artefact of XLA on the
CPU, which materialises float32 copies of bf16 tensors; the port counts
the program it runs, in its own dtypes.

Usage::

    python -m repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k --mesh pod
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
    python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b --shape decode_32k \\
        --override '{"opts": {"moe_decode_gather": true}}' --force
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import SHAPES, ShapeSpec, get_config, list_archs, shape_applicable
from ..models.lm import build_model
from ..models.params import from_jax, param_specs
from ..roofline.count import Costs, count_call
from ..roofline.model import model_flops_for, roofline_from_costs
from ..sharding import comm
from ..sharding.specs import (
    ShardingRules,
    coordinate,
    default_rules,
    mesh_shape,
    set_activation_rules,
    shard_params,
)
from .mesh import make_host_mesh, make_production_mesh, mesh_name

SERVE_DTYPE = "bfloat16"

# Per-arch policies, the reference's (its dtypes and microbatching chosen so
# that every cell fits 16 GB a chip); fsdp shards weight embed-dims over the
# data axes (ZeRO-3); optimizer states inherit it (ZeRO-1).  The train
# policies are kept for the train cells of ROADMAP item 9c.
DEFAULT_TRAIN = dict(
    param_dtype="float32", microbatches=16, m_dtype="float32",
    v_dtype="float32", accum_dtype="float32", fsdp=True, remat=True,
)
TRAIN_POLICY: Dict[str, Dict[str, Any]] = {
    "llama4-maverick-400b-a17b": dict(
        param_dtype="bfloat16", microbatches=16, m_dtype="bfloat16",
        v_dtype="bfloat16", accum_dtype="bfloat16", fsdp=True, remat=True,
    ),
    "deepseek-67b": dict(DEFAULT_TRAIN, microbatches=32),
    "granite-20b": dict(DEFAULT_TRAIN, microbatches=32),
    "chameleon-34b": dict(DEFAULT_TRAIN, microbatches=32),
    "mamba2-130m": dict(DEFAULT_TRAIN, microbatches=8, fsdp=False),
    # whisper: 20 heads defeat 16-way TP, so weights replicate across the
    # model axis unless FSDP shards their embed dims over data
    "whisper-large-v3": dict(DEFAULT_TRAIN, microbatches=8, fsdp=True),
    "zamba2-2.7b": dict(DEFAULT_TRAIN, microbatches=16, fsdp=False),
}
SERVE_POLICY: Dict[str, Dict[str, Any]] = {
    # 400B weights exceed 16-way TP capacity -> FSDP-style sharding at serve
    "llama4-maverick-400b-a17b": dict(fsdp=True),
    # 67B bf16 = 8.4 GB/chip at TP-16; + a 6 GB 32k cache leaves no headroom
    "deepseek-67b": dict(fsdp=True),
}

# the families whose serving cells the port counts; the rest wait for 9c
PORTED_FAMILIES = ("dense", "moe")
NOT_PORTED = "ROADMAP item 9c"
# the override the port takes: the levers (the reference's backend and
# dtype overrides have no counterpart: a port model has one dtype)
_OVERRIDES = ("opts",)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def rules_for(cfg, mesh, fsdp: bool, train: bool = False, opts=None) -> ShardingRules:
    """The reference's rules of a cell: the default rules (FSDP weights over
    the batch axes with ``fsdp``), ``opts`` on, and where the kv heads do
    not divide the model axis the cache's sequence dim over "model"
    (``kv_seq``).  The train branch (sequence parallelism) is ROADMAP item
    9c and raises."""
    if train:
        raise NotImplementedError(f"the train cells' rules (sequence parallelism): {NOT_PORTED}")
    rules = default_rules(mesh, fsdp=fsdp)
    if opts:
        rules.opts.update(opts)
    model_size = mesh_shape(mesh)["model"]
    if cfg.num_kv_heads and cfg.num_kv_heads % model_size != 0:
        # KV heads can't split the model axis -> shard the cache's seq dim
        rules.rules["kv_seq"] = "model"
    return rules


def clamp_microbatches(mb: int, global_batch: int, rules: ShardingRules) -> int:
    """Largest mb <= requested s.t. each microbatch still shards the batch
    axes evenly (a microbatch smaller than the batch sharding under-shards)."""
    shards = rules.axis_size(rules.mesh_axes_for("batch", global_batch))
    mb = max(1, min(mb, global_batch // max(shards, 1)))
    while mb > 1 and (global_batch % mb or (global_batch // mb) % shards):
        mb -= 1
    return mb


def batch_specs(cfg, shape: ShapeSpec, rules: ShardingRules):
    """Meta tensors of the model inputs of one cell (the whole batch) and
    each one's split ``((dim, mesh axes),)`` over the batch axes (the
    decoder families' tokens; the encdec family's frames come with 9c)."""
    b_ax = rules.mesh_axes_for("batch", shape.global_batch)
    gb, seq = shape.global_batch, shape.seq_len
    split = ((0, b_ax),) if b_ax else ()
    tokens = torch.empty((gb,) if shape.kind == "decode" else (gb, seq), dtype=torch.int32,
                         device="meta")
    return {"tokens": tokens}, {"tokens": split}


def input_specs(arch: str, shape_name: str = "train_4k", multi_pod: bool = False):
    """Public helper: meta tensors standing in for every model input."""
    cfg = get_config(arch)
    rules = rules_for(cfg, make_production_mesh(multi_pod=multi_pod), fsdp=False)
    spec, _ = batch_specs(cfg, SHAPES[shape_name], rules)
    return spec


def local_batch(shape: ShapeSpec, rules: ShardingRules) -> int:
    """Rows of the cell's batch on one device."""
    return shape.global_batch // rules.axis_size(rules.mesh_axes_for("batch", shape.global_batch))


def serve_step(model, params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], kind: str,
               kv_bound: Optional[int] = None):
    """One serving call of a cell, counted with its memory
    (:func:`~repro_torch.roofline.count.count_call`, the cache aliased):
    ``prefill`` of ``tokens`` (b, s) into ``cache``, or one ``decode`` step
    of ``tokens`` (b,) at the cache's positions reading at most
    ``kv_bound`` keys.  The dry run (meta tensors, a counting world) and
    the card (real tensors and ranks) call this same function.  Returns
    (the logits, the :class:`~repro_torch.roofline.count.Costs`)."""
    with torch.inference_mode():
        if kind == "prefill":
            return count_call(lambda p, b, c: model.prefill(p, b, c), params,
                              {"tokens": tokens}, cache, aliased=cache)
        return count_call(lambda p, t, c: model.decode(p, t, c, kv_bound=kv_bound), params,
                          tokens, cache, aliased=cache)


def count_cell(cfg, shape: ShapeSpec, sizes: Mapping[str, int], *, fsdp: bool = False,
               opts: Optional[Dict[str, bool]] = None, dtype: torch.dtype = torch.bfloat16,
               rank: int = 0, cache_len: Optional[int] = None,
               decode_pos: Optional[int] = None) -> Tuple[Costs, ShardingRules]:
    """Count one device's serving call of ``cfg`` at ``shape`` (any
    :class:`~repro_torch.configs.ShapeSpec`, prefill or decode) on a mesh
    of axis ``sizes``, seen from ``rank``, with nothing allocated: the
    model, rank ``rank``'s weight and cache shards and the inputs on meta,
    under :func:`rules_for`'s rules in a counting world.  The cache holds
    ``cache_len`` slots (the shape's ``seq_len``); a decode step runs at
    position ``decode_pos`` (the cache's last slot), so reads ``decode_pos
    + 1`` keys a row.  Returns (its costs, memory included; the rules)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family's cells: {NOT_PORTED}")
    if shape.kind not in ("prefill", "decode"):
        raise NotImplementedError(f"{shape.name}: the train cells: {NOT_PORTED}")
    sizes = mesh_shape(sizes)
    rules = rules_for(cfg, sizes, fsdp=fsdp, opts=opts)
    S = cache_len or shape.seq_len
    pos = S - 1 if decode_pos is None else decode_pos
    model = build_model(cfg, device="meta", dtype=dtype)
    defs = model.param_defs()
    params = shard_params(param_specs(defs, dtype), rules, rank, defs=defs)
    cache = model.init_cache(shape.global_batch, S, rules=rules)
    b = local_batch(shape, rules)
    tokens = torch.empty((b, shape.seq_len) if shape.kind == "prefill" else (b,),
                         dtype=torch.int32, device="meta")
    with comm.counting(sizes, rank), set_activation_rules(rules):
        _, costs = serve_step(model, params, tokens, cache, shape.kind, kv_bound=pos + 1)
    return costs, rules


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None):
    """Count one cell on its production mesh; returns (costs, meta), or
    (None, {"skipped": reason}) for a cell that does not apply, or (None,
    {"not_ported": reason})."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": reason}
    if shape.kind == "train":
        return None, {"not_ported": f"train cells: {NOT_PORTED}"}
    if cfg.family not in PORTED_FAMILIES:
        return None, {"not_ported": f"the {cfg.family} family's cells: {NOT_PORTED}"}
    overrides = dict(overrides or {})
    unknown = sorted(set(overrides) - set(_OVERRIDES))
    if unknown:
        raise ValueError(f"overrides {unknown} not taken by the port (it takes {_OVERRIDES})")
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = 1
    for v in mesh.values():
        chips *= v
    policy = dict(SERVE_POLICY.get(arch, {"fsdp": False}))
    policy.update(overrides)
    costs, _ = count_cell(cfg, shape, mesh, fsdp=bool(policy.get("fsdp", False)),
                          opts=overrides.get("opts"), dtype=_DTYPES[SERVE_DTYPE])
    return costs, {"kind": shape.kind, "policy": policy, "chips": chips,
                   "mesh": mesh_name(mesh)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[Dict[str, Any]] = None, note: str = "") -> Dict[str, Any]:
    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    costs, meta = lower_cell(arch, shape_name, multi_pod, overrides)
    if costs is None:
        status, reason = (("skip", meta["skipped"]) if "skipped" in meta
                          else ("not_ported", meta["not_ported"]))
        return {"arch": arch, "shape": shape_name,
                "mesh": mesh_name(make_production_mesh(multi_pod=multi_pod)),
                "status": status, "reason": reason}
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = model_flops_for(cfg.param_count(active_only=True), tokens, "serve")
    report = roofline_from_costs(costs, arch=arch, shape=shape_name, mesh_name=meta["mesh"],
                                 chips=meta["chips"], model_flops=mf, note=note)
    return {
        "arch": arch, "shape": shape_name, "mesh": meta["mesh"],
        "status": "ok", "kind": meta["kind"],
        "policy": {k: str(v) for k, v in meta["policy"].items()},
        "compile_s": time.time() - t0,
        "memory": costs.memory.to_dict(),
        "roofline": report.to_dict(),
    }


# ---------------------------------------------------------------------------
# the same cells run for real, to hold the counts against
# ---------------------------------------------------------------------------
@dataclass
class CellCheck:
    """A serving cell run for real on a rank's shards: the prompts
    ``tokens`` (the whole batch, (b, s) int32) prefilled into a cache of
    ``cache_len`` slots, then ``steps`` greedy decode steps, each call
    counted.  ``tp`` is the mesh's model axis (its data axis takes the rest
    of the world); ``weights`` a seed (``init``) or a parameter tree of
    numpy arrays in the reference's layout (``from_jax``)."""

    cfg: Any
    tokens: np.ndarray
    cache_len: int
    steps: int
    weights: Union[int, Dict[str, Any]] = 0
    tp: int = 1
    fsdp: bool = False
    opts: Optional[Dict[str, bool]] = None
    dtype: str = "float32"

    def __call__(self, rank: int, device: torch.device) -> "CellResult":
        """This check on one rank of a world (every rank calls it; a job of
        ``repro_torch.launch.mesh.run_jobs``): its model, this rank's weights,
        the run, and every rank's rows, costs and peaks gathered into rank
        0's result."""
        import torch.distributed as dist

        mesh = make_host_mesh(self.tp)
        model = build_model(self.cfg, device=device, dtype=self.dtype)
        rules = rules_for(self.cfg, mesh, fsdp=self.fsdp, opts=self.opts)
        params = check_weights(self, model, rules, rank)
        got = run_check(self, model, params, mesh, rank, device)
        del model, params
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, got)
        return _assemble(self, rules, every)


@dataclass
class CellResult:
    """One rank's run of a :class:`CellCheck` (rank 0's result carries
    every rank's): the greedy tokens (b, steps + 1) and the prefill's
    logits (b, V) of the whole batch; per rank and call (the prefill, then
    each step), its counted costs (``flops``, ``bytes``, ``ledger``,
    ``by_kernel``, ``memory``) and, on the card, the device bytes the call
    added at its peak (``max_memory_allocated`` less what was allocated
    before it)."""

    tokens: np.ndarray
    logits: np.ndarray
    costs: List[List[Dict[str, Any]]] = field(default_factory=list)
    peak_added: List[List[int]] = field(default_factory=list)


def costs_dict(c: Costs) -> Dict[str, Any]:
    """The counted figures of one call, as plain values (``memory`` by
    XLA's fields, and the call's ``live_peak_bytes`` beside them)."""
    return {"flops": c.flops, "bytes": c.memory_bytes, "ledger": list(c.ledger),
            "by_kernel": dict(c.by_kernel),
            "memory": c.memory.to_dict() if c.memory is not None else None,
            "live_peak_bytes": c.memory.live_peak_bytes if c.memory is not None else None}


def run_check(check: CellCheck, model, params, mesh, rank: int, device: torch.device):
    """:class:`CellCheck` ``check`` on ``model`` with this rank's ``params``
    under :func:`rules_for`'s rules on ``mesh`` (a ``DeviceMesh`` of a real
    world, or ``{"data": 1, "model": 1}``): (this rank's rows' tokens and
    prefill logits, each call's costs, each call's added peak bytes)."""
    cfg = check.cfg
    rules = rules_for(cfg, mesh, fsdp=check.fsdp, opts=check.opts)
    gb, s = check.tokens.shape
    axes = rules.mesh_axes_for("batch", gb)
    rows = gb // rules.axis_size(axes)
    first = (coordinate(rules.mesh, rank, axes) if axes else 0) * rows
    tokens = torch.from_numpy(np.ascontiguousarray(check.tokens[first:first + rows])).to(device)
    cache = model.init_cache(gb, check.cache_len, rules=rules)
    cuda = device.type == "cuda"
    costs, added, out = [], [], []

    def call(kind, tok, kv_bound=None):
        if cuda:
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        logits, c = serve_step(model, params, tok, cache, kind, kv_bound)
        if cuda:
            torch.cuda.synchronize(device)
            added.append(int(torch.cuda.max_memory_allocated(device) - before))
        costs.append(costs_dict(c))
        out.append(logits.argmax(-1).to(torch.int32))
        return logits

    with set_activation_rules(rules):
        logits = call("prefill", tokens).float().cpu().numpy()
        for i in range(check.steps):
            call("decode", out[-1], kv_bound=s + i + 1)
    return torch.stack(out, dim=1).cpu().numpy(), logits, costs, added


def check_weights(check: CellCheck, model, rules: ShardingRules, rank: int):
    """A rank's weights for ``check``: its shards drawn from the seed, or
    cut from the numpy tree."""
    if isinstance(check.weights, int):
        return model.init(seed=check.weights, rules=rules, rank=rank)
    full = from_jax(check.weights, device=model.device, dtype=model.dtype)
    return shard_params(full, rules, rank, defs=model.param_defs())


def _assemble(check: CellCheck, rules: ShardingRules, every) -> CellResult:
    """Rank 0's :class:`CellResult` from every rank's run: the batch's rows
    in the order of their data coordinate."""
    gb = check.tokens.shape[0]
    axes = rules.mesh_axes_for("batch", gb)
    shards = rules.axis_size(axes)
    tokens, logits = [None] * shards, [None] * shards
    for r, (tok, lg, _, _) in enumerate(every):
        i = coordinate(rules.mesh, r, axes) if axes else 0
        tokens[i], logits[i] = tok, lg
    return CellResult(np.concatenate(tokens), np.concatenate(logits),
                      costs=[e[2] for e in every], peak_added=[e[3] for e in every])


def check_counts(check: CellCheck, sizes: Mapping[str, int], rank: int = 0,
                 dtype: Optional[torch.dtype] = None) -> List[Costs]:
    """The dry run's counts of each call of ``check`` (its prefill, then
    each decode step at its position) on a mesh of ``sizes`` seen from
    ``rank``."""
    gb, s = check.tokens.shape
    dtype = dtype or _DTYPES[check.dtype]
    kw = dict(fsdp=check.fsdp, opts=check.opts, dtype=dtype, rank=rank,
              cache_len=check.cache_len)
    out = [count_cell(check.cfg, ShapeSpec("check", s, gb, "prefill"), sizes, **kw)[0]]
    for i in range(check.steps):
        out.append(count_cell(check.cfg, ShapeSpec("check", s, gb, "decode"), sizes,
                              decode_pos=s + i, **kw)[0])
    return out


# ---------------------------------------------------------------------------
# CLI driver
# ---------------------------------------------------------------------------
def cell_path(out_dir: str, arch: str, shape: str, mesh_kind: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")


def _one(args, arch: str, shape: str, mesh_kind: str, overrides) -> int:
    path = cell_path(args.out, arch, shape, mesh_kind)
    if os.path.exists(path) and not args.force:
        print(f"[dryrun] cached: {path}")
        return 0
    try:
        result = run_cell(arch, shape, mesh_kind == "multipod", overrides=overrides,
                          note=args.note)
    except Exception:
        result = {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "error",
                  "traceback": traceback.format_exc()}
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        print(result["traceback"], file=sys.stderr)
        return 1
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    if result["status"] == "ok":
        r = result["roofline"]
        print(
            f"[dryrun] {arch} × {shape} × {result['mesh']}: "
            f"peak/dev={result['memory']['peak_per_device_bytes']/2**30:.2f} GiB "
            f"terms(s): compute={r['compute_term_s']:.4f} "
            f"memory={r['memory_term_s']:.4f} collective={r['collective_term_s']:.4f} "
            f"dominant={r['dominant']} frac={r['roofline_fraction']:.3f}"
        )
    else:
        print(f"[dryrun] {arch} × {shape} × {result['mesh']}: {result['status']} "
              f"({result.get('reason', '')})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true", help="sweep every cell, in this process")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--note", default="")
    ap.add_argument("--override", default="",
                    help='JSON policy overrides: "opts" (e.g. {"moe_decode_gather": true})')
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    overrides = json.loads(args.override) if args.override else None

    if args.all:
        failures = []
        for arch in list_archs():
            for shape in SHAPES:
                for mesh_kind in ("pod", "multipod"):
                    if _one(args, arch, shape, mesh_kind, overrides):
                        failures.append((arch, shape, mesh_kind))
                        print(f"[dryrun]   FAILED {arch} × {shape} × {mesh_kind}", flush=True)
        print(f"[dryrun] sweep done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    return _one(args, args.arch, args.shape, args.mesh, overrides)


if __name__ == "__main__":
    sys.exit(main())
