"""Tensor-parallel serving runs: the job each rank runs, and the call that
starts the ranks.

:func:`serve_tp` starts ``tp`` ranks (:class:`repro_torch.launch.mesh.
Ranks`) and runs its jobs on each in order (``launch.mesh.run_jobs``).  A job is
any callable ``(rank, device) -> result``; rank 0's results come back.
For a :class:`ServeJob`, a model and its runs, each rank builds the model,
takes its weight shards, opens one
:class:`~repro_torch.serve.engine.ServingEngine` under ``serve_rules``
for each :class:`TPRun` and serves its requests with ``serve_paged``; its
result is each run's ``PagedStats`` and, for a traced run, the
``tp:collective`` summary of its spans.  The weights are random
from a seed (each leaf drawn whole and cut, so every tp draws the same
model) or a parameter tree of numpy arrays in the reference's layout,
which ``from_jax`` carries across.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.analysis import tp_summary
from ..core.tracing import Tracer, TracingServer
from ..kernels import kernel_counters
from ..launch.mesh import Ranks, make_host_mesh, run_jobs
from ..models.lm import build_model
from ..models.params import from_jax
from ..sharding.specs import mesh_shape, serve_rules, tp_degree
from .engine import PagedStats, ServeRequest, ServingEngine


@dataclass
class TPRun:
    """One ``serve_paged`` run: its requests, the engine's keyword
    arguments (``max_batch``, ``max_seq``, ``page_size``, ``kv_dtype``),
    ``serve_paged``'s, the ``rs_block_outputs`` lever, and whether to
    trace it."""

    requests: List[ServeRequest]
    engine: Dict[str, Any] = field(default_factory=dict)
    serve: Dict[str, Any] = field(default_factory=dict)
    rs_block_outputs: bool = False
    trace: bool = False
    # a prompt whose last-token logits (ServingEngine.prompt_logits) the
    # rank takes before serving
    probe: Optional[np.ndarray] = None


@dataclass
class TPResult:
    """Rank 0's outcome of one :class:`TPRun`: its stats, the engine's
    effective tp, the ``tp:collective`` summary of a traced run, the
    probe's logits, and per rank (a list in rank order) the kernel launch
    counts of the serve alone, the peak device bytes (the card only) and
    the pool's pages; ``mesh`` is the mesh's axis sizes and type."""

    stats: PagedStats
    engine_tp: int
    tp_summary: Dict[str, float] = field(default_factory=dict)
    logits: Optional[torch.Tensor] = None
    launches: List[Dict[str, int]] = field(default_factory=list)
    peak_bytes: List[int] = field(default_factory=list)
    pool_pages: List[int] = field(default_factory=list)
    mesh: Dict[str, Any] = field(default_factory=dict)


def rank_params(model, weights: Union[int, Dict[str, Any]], rules, rank: int, dtype):
    """The weights a rank starts from: from a seed, its shards drawn leaf by
    leaf (``init(rules=...)``; the whole model where the heads do not
    split); from a numpy tree, the whole tree (``from_jax``), which the
    engine cuts."""
    if isinstance(weights, int):
        cfg = model.cfg
        split = tp_degree(rules, cfg.num_heads, cfg.num_kv_heads) > 1
        return model.init(seed=weights, rules=rules if split else None, rank=rank)
    return from_jax(weights, device=model.device, dtype=dtype)


@dataclass
class ServeJob:
    """One model on every rank of the world and its runs in order (see the
    module): the config, the weights (a seed or a numpy tree, see
    :func:`rank_params`), the :class:`TPRun` list, and the model's dtype
    (None: ``build_model``'s default).  Each run's launch counts, peak
    device bytes and pool pages are gathered from every rank into rank 0's
    result."""

    cfg: Any
    weights: Union[int, Dict[str, Any]]
    runs: List[TPRun]
    dtype: Optional[torch.dtype] = None

    def __call__(self, rank: int, device: torch.device) -> List[TPResult]:
        import torch.distributed as dist

        base = serve_rules(make_host_mesh(dist.get_world_size()))
        mesh = {"shape": mesh_shape(base.mesh), "type": type(base.mesh).__name__}
        counters = kernel_counters()
        model = build_model(self.cfg, device=device, dtype=self.dtype)
        params = rank_params(model, self.weights, base, rank, model.dtype)
        results = []
        for run in self.runs:
            rules = serve_rules(base.mesh, rs_block_outputs=run.rs_block_outputs)
            engine = ServingEngine(model, params, device=device, rules=rules, **run.engine)
            logits = engine.prompt_logits(run.probe) if run.probe is not None else None
            server = TracingServer() if run.trace else None
            tracer = Tracer("tp-serve", server) if run.trace else None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            for mod in counters.values():
                mod.launches = 0
            stats = engine.serve_paged(run.requests, tracer=tracer, **run.serve)
            mine = ({name: mod.launches for name, mod in counters.items()},
                    torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
                    stats.num_pages)
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            res = TPResult(stats=stats, engine_tp=engine.tp, mesh=mesh,
                           logits=None if logits is None else logits.cpu(),
                           launches=[e[0] for e in every], peak_bytes=[e[1] for e in every],
                           pool_pages=[e[2] for e in every])
            if server is not None and rank == 0:
                res.tp_summary = tp_summary(server.timeline("tp-serve"))
            results.append(res)
            del engine
        return results


def serve_tp(jobs: List[Callable], tp: int, device: Union[str, torch.device] = "cuda",
             timeout_s: float = 900.0, wait: bool = True):
    """Run ``jobs`` (each a :class:`ServeJob` or another callable ``(rank,
    device) -> result``) on ``tp`` ranks (see the module): rank 0's
    results, one a job; with ``wait=False`` the
    :class:`~repro_torch.launch.mesh.Ranks` handle, whose ``result()``
    gives them."""
    ranks = Ranks(run_jobs, tp, (jobs,), device=device, timeout_s=timeout_s)
    return ranks.result() if wait else ranks
