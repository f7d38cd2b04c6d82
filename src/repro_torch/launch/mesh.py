"""The port's host mesh and the launcher of its ranks.

:func:`make_host_mesh` gives the serving mesh ``(data, model=tp)``: a
``torch.distributed.device_mesh.DeviceMesh`` with dim names ``("data",
"model")`` over the process group of the calling rank, or, at ``tp`` 1 in
a process that is no rank of a world, the plain mapping ``{"data": 1,
"model": 1}``.  :func:`run_ranks` (and :class:`Ranks`, its handle that
does not wait) runs ``fn(rank, device, *args)`` in ``tp`` spawned
processes joined by a gloo world over ``tcp://localhost`` and returns rank
0's result; :func:`run_jobs` is such an ``fn`` that runs a list of jobs,
each a callable ``(rank, device) -> result``.  Each rank's device is its own: the CPU, or
``cuda:(rank % device_count)``; ranks that share one card run their
collectives through gloo on its tensors (NCCL takes one rank a device).
On the card the kernel library is built once, in the calling process,
before any rank starts.  :func:`make_production_mesh` gives the
reference's production meshes, 16 x 16 = 256 devices ``(data, model)``
and, across two pods, 2 x 16 x 16 = 512 ``(pod, data, model)``, as the
axis sizes alone: the sharding rules read nothing else, and the dry run
(:mod:`repro_torch.launch.dryrun`) counts one device's program on them
with no process group.
"""
from __future__ import annotations

import pickle
import queue as queue_mod
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

# (rank, world size, device) of this process, once run_ranks started it
_RANK: Optional[tuple] = None


def make_host_mesh(tp: Optional[int] = None):
    """The serving mesh ``(data=world/tp, model=tp)`` of this rank's world
    (a ``DeviceMesh``), or ``{"data": 1, "model": 1}`` at ``tp`` 1 outside
    a world.  Raises ``ValueError`` for ``tp < 1`` and for a ``tp`` the
    world's ranks cannot fill."""
    tp = 1 if tp is None else int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if tp == 1:
            return {"data": 1, "model": 1}
        raise ValueError(
            f"tp={tp} needs {tp} ranks but only 1 visible (this process is no rank of a "
            f"torch.distributed world); start the ranks with "
            f"repro_torch.launch.mesh.run_ranks(fn, {tp}, ...)")
    n = dist.get_world_size()
    if tp > n or n % tp:
        raise ValueError(f"tp={tp} needs {tp} ranks (a divisor of the world) but the world "
                         f"has {n}; start {tp} ranks with repro_torch.launch.mesh.run_ranks")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _RANK[2].type if _RANK is not None else "cpu"
    return init_device_mesh(device_type, (n // tp, tp), mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as ``{axis: size}``: ``{"data": 16,
    "model": 16}``, or with ``multi_pod`` ``{"pod": 2, "data": 16, "model":
    16}``.  Batch-like dims shard over ("pod", "data"), tensor-parallel dims
    over "model"."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def mesh_name(mesh) -> str:
    from ..sharding.specs import mesh_shape

    return "x".join(str(v) for v in mesh_shape(mesh).values())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: the card was asked for, and CUDA is not available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, world: int, port: int, device: str, timeout_s: float,
               fn: Callable, args: tuple, out) -> None:
    global _RANK
    import torch.distributed as dist

    # one intra-op thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    try:
        dev = _rank_device(torch.device(device), rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _RANK = (rank, world, dev)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        return
    try:
        result = fn(rank, dev, *args)
        # plain pickle: copied bytes, never a shared-memory handle that dies
        # with this process
        out.put((rank, True, pickle.dumps(result) if rank == 0 else None))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        try:
            dist.destroy_process_group()
        except Exception:
            pass


class Ranks:
    """``tp`` spawned ranks running ``fn(rank, device, *args)`` (``fn`` and
    ``args`` must pickle: ``fn`` a module-level function), started at
    construction; :meth:`result` waits for them and returns rank 0's
    result.  A rank that raises fails the whole run (the others are
    stopped once it has been reported); ``timeout_s`` bounds each
    collective and the wait."""

    def __init__(self, fn: Callable, tp: int, args: Sequence[Any] = (),
                 device: Union[str, torch.device] = "cpu", timeout_s: float = 600.0) -> None:
        import multiprocessing as mp

        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        dev = torch.device(device)
        if dev.type == "cuda":
            # one build, here, before any rank looks for the library
            from ..kernels import _build

            _build.library()
        ctx = mp.get_context("spawn")
        self.tp, self.timeout_s = tp, timeout_s
        self._out = ctx.Queue()
        port = _free_port()
        self._procs = [
            ctx.Process(target=_rank_main, name=f"rank{r}",
                        args=(r, tp, port, str(dev), timeout_s, fn, tuple(args), self._out))
            for r in range(tp)
        ]
        for p in self._procs:
            p.start()

    def result(self):
        reports: Dict[int, tuple] = {}
        deadline = time.monotonic() + self.timeout_s
        try:
            while len(reports) < self.tp:
                try:
                    rank, ok, payload = self._out.get(timeout=1.0)
                    reports[rank] = (ok, payload)
                    if not ok:
                        break
                except queue_mod.Empty:
                    dead = [p.name for r, p in enumerate(self._procs)
                            if r not in reports and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank processes {dead} ended without a result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{self.tp} ranks did not finish within "
                                           f"{self.timeout_s} s")
        finally:
            self._stop(grace_s=0.0 if len(reports) < self.tp else 30.0)
        failed = {r: p for r, (ok, p) in reports.items() if not ok}
        if failed:
            rank, tb = sorted(failed.items())[0]
            raise RuntimeError(f"rank {rank} of {self.tp} failed:\n{tb}")
        return pickle.loads(reports[0][1])

    def _stop(self, grace_s: float) -> None:
        for p in self._procs:
            p.join(timeout=grace_s if p.exitcode is None else None)
        for p in self._procs:
            if p.exitcode is None:
                p.terminate()
                p.join(timeout=10.0)
            if p.exitcode is None:
                p.kill()
                p.join()
        self._out.close()


def run_jobs(rank: int, device: torch.device, jobs: List[Callable]) -> List[Any]:
    """A rank function for :class:`Ranks`: each of ``jobs`` (a callable
    ``(rank, device) -> result``, such as ``repro_torch.serve.tp.ServeJob``
    or ``repro_torch.launch.dryrun.CellCheck``) in order, the device's
    cache emptied after each; their results."""
    out = []
    for job in jobs:
        out.append(job(rank, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_ranks(fn: Callable, tp: int, *args, device: Union[str, torch.device] = "cpu",
              timeout_s: float = 600.0):
    """Run ``fn(rank, device, *args)`` in ``tp`` spawned ranks of one gloo
    world and return rank 0's result (see :class:`Ranks`)."""
    return Ranks(fn, tp, args, device=device, timeout_s=timeout_s).result()
