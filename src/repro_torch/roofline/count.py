"""The roofline's counter: FLOPs and bytes of what a function runs, counted
while it runs (the port's counterpart of ``repro.roofline.hlo``).

The reference parses a compiled HLO module; the port has no module to
parse, so :func:`count_costs` sits under PyTorch's dispatcher (a
``TorchDispatchMode``) and counts each aten op as it is dispatched, by
the rules ``hlo.py`` applies to HLO instructions (a composite op is
counted as what it decomposes into, as XLA counts the lowered program):

* ``flops`` — matrix products and convolutions (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``mv``, ``dot``, ``convolution`` and its backward):
  2 · output elements · contraction; every other op adds none;
* ``memory_bytes`` — per op, its tensor operands' bytes plus its outputs'
  bytes, once each, with the reference's two refinements: a gather
  (``embedding``, ``index_select``, ``gather``, ``index``) reads the rows it
  selects, not its whole source (``hlo.py``'s dynamic slice: twice the
  output, plus the indices), and an indexed write (``index_put_``,
  ``index_copy_``, ``index_add_``, ``scatter_``) touches the update, not the
  whole destination (its dynamic update slice: twice the update, plus the
  indices).  Views, metadata ops and factory ops that write no data
  (``empty*``) count nothing (``hlo.py``'s ``_NO_TRAFFIC``);
* kernel-backed ops — each op of :mod:`repro_torch.kernels.ops` that stands
  for a TPU kernel (the seven forwards, and the flash, rmsnorm and ssd
  backwards inside their ``autograd.Function``) counts its work once, from
  :mod:`.work`, and the aten ops it dispatches inside (its plain version on
  the CPU, its wrapper's workspaces on the card) count nothing.  So a call
  counts the same on the CPU and on the card;
* ``collective_bytes`` — 0: the port has no collectives yet.

The counter is process-wide: one module global, checked once per
kernel-backed op.  With no counter active nothing else happens: no
allocation, no host sync.  While one is active the decode family and
``varlen_prefill`` read their lengths to the host to count live keys, so
never count a pass that is being timed.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten


@dataclass
class Costs:
    flops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    # kernel name -> (calls, flops, bytes) of the kernel-backed ops counted
    by_kernel: Dict[str, Tuple[int, float, float]] = field(default_factory=dict)

    def __iadd__(self, other: "Costs") -> "Costs":
        self.flops += other.flops
        self.memory_bytes += other.memory_bytes
        self.collective_bytes += other.collective_bytes
        for k, v in other.by_collective.items():
            self.by_collective[k] = self.by_collective.get(k, 0.0) + v
        for k, v in other.collective_count.items():
            self.collective_count[k] = self.collective_count.get(k, 0) + v
        for k, (n, f, b) in other.by_kernel.items():
            n0, f0, b0 = self.by_kernel.get(k, (0, 0.0, 0.0))
            self.by_kernel[k] = (n0 + n, f0 + f, b0 + b)
        return self

    def scaled(self, factor: float) -> "Costs":
        return Costs(
            flops=self.flops * factor,
            memory_bytes=self.memory_bytes * factor,
            collective_bytes=self.collective_bytes * factor,
            by_collective={k: v * factor for k, v in self.by_collective.items()},
            collective_count={k: int(v * factor) for k, v in self.collective_count.items()},
            by_kernel={k: (int(n * factor), f * factor, b * factor)
                       for k, (n, f, b) in self.by_kernel.items()},
        )


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _leaves_bytes(tree) -> int:
    return sum(_bytes(t) for t in tree_leaves(tree))


def _mm_flops(a: torch.Tensor, out: torch.Tensor) -> float:
    """2 · output elements · contraction (the last axis of the left operand)."""
    return 2.0 * out.numel() * (a.shape[-1] if a.dim() else 1)


def _conv_flops(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, transposed: bool) -> float:
    """2 · output elements · (input channels a group × kernel elements); a
    transposed convolution contracts over the output side instead, so it
    counts from its input."""
    if transposed:
        return 2.0 * x.numel() * (w.numel() // w.shape[0])
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


_PRODUCTS = {
    aten.mm.default: lambda a, k, o: _mm_flops(a[0], o),
    aten.addmm.default: lambda a, k, o: _mm_flops(a[1], o),
    aten.bmm.default: lambda a, k, o: _mm_flops(a[0], o),
    aten.baddbmm.default: lambda a, k, o: _mm_flops(a[1], o),
    aten.mv.default: lambda a, k, o: _mm_flops(a[0], o),
    aten.addmv.default: lambda a, k, o: _mm_flops(a[1], o),
    aten.dot.default: lambda a, k, o: 2.0 * a[0].numel(),
    aten.convolution.default: lambda a, k, o: _conv_flops(a[0], a[1], o, a[6]),
}

# gathers: the rows read are the output's (and the indices)
_GATHERS = {
    aten.embedding.default: 1,              # (weight, indices)
    aten.index_select.default: 2,           # (self, dim, index)
    aten.gather.default: 2,                 # (self, dim, index)
    aten.index.Tensor: 1,                   # (self, indices)
}
# indexed writes: (position of the update, positions of the indices)
_UPDATES = {
    aten.index_put_.default: (2, (1,)),     # (self, indices, values)
    aten._index_put_impl_.default: (2, (1,)),
    aten.index_copy_.default: (3, (2,)),    # (self, dim, index, source)
    aten.index_add_.default: (3, (2,)),
    aten.scatter_.src: (3, (2,)),           # (self, dim, index, src)
    aten.scatter_add_.default: (3, (2,)),
}
_COUNTED = set(_PRODUCTS) | set(_GATHERS) | set(_UPDATES) | {aten.convolution_backward.default}
_NO_TRAFFIC_NAMES = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                     "_unsafe_view", "lift_fresh", "lift_fresh_copy", "resize_", "set_",
                     "record_stream", "sym_size", "sym_stride", "sym_numel",
                     "sym_storage_offset", "is_same_size", "_local_scalar_dense")


def _conv_backward_flops(args, outs) -> float:
    """Each gradient of ``convolution_backward(grad, input, weight, ...)``
    it computes: the forward's products again."""
    grad, x, w, transposed = args[0], args[1], args[2], args[6]
    fwd = _conv_flops(x, w, grad, transposed)
    return fwd * sum(1 for o in outs[:2] if isinstance(o, torch.Tensor))


class _Counter(TorchDispatchMode):
    def __init__(self, costs: Costs) -> None:
        super().__init__()
        self.costs = costs
        self.inside = 0             # depth of the kernel-backed ops running

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.inside:
            return func(*args, **kwargs)
        if func not in _COUNTED:
            # a composite op (inference mode dispatches conv2d, linear,
            # matmul, to, ... whole): count what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.costs
        if func in _PRODUCTS:
            c.flops += _PRODUCTS[func](args, kwargs, out)
        elif func is aten.convolution_backward.default:
            c.flops += _conv_backward_flops(args, out)
        elif func in _GATHERS:
            idx = args[_GATHERS[func]]
            c.memory_bytes += 2 * _leaves_bytes(out) + _leaves_bytes(idx)
            return
        elif func in _UPDATES:
            upd, idx = _UPDATES[func]
            c.memory_bytes += 2 * _bytes(args[upd]) + sum(_leaves_bytes(args[i]) for i in idx)
            return
        elif func.is_view or func._opname in _NO_TRAFFIC_NAMES or func.namespace != "aten":
            return
        c.memory_bytes += _leaves_bytes(args) + _leaves_bytes(kwargs) + _leaves_bytes(out)

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.costs
        c.flops += flops
        c.memory_bytes += nbytes
        n0, f0, b0 = c.by_kernel.get(name, (0, 0.0, 0.0))
        c.by_kernel[name] = (n0 + 1, f0 + flops, b0 + nbytes)


_active: Optional[_Counter] = None


def counting() -> bool:
    """Whether a :func:`count_costs` is active."""
    return _active is not None


@contextlib.contextmanager
def count_costs() -> Iterator[Costs]:
    """Count the FLOPs and bytes of everything run inside, on any device;
    yields the :class:`Costs` it fills.  Not reentrant."""
    global _active
    if _active is not None:
        raise RuntimeError("count_costs is already active")
    costs = Costs()
    counter = _Counter(costs)
    _active = counter
    try:
        with counter:
            yield costs
    finally:
        _active = None


@contextlib.contextmanager
def kernel_scope(name: str, work: Callable[[], Tuple[float, float]]) -> Iterator[None]:
    """Inside a kernel-backed op: count ``work()`` (flops, bytes) once under
    ``name`` and nothing that runs inside.  Used where an op is not a plain
    call (the backwards of the autograd functions); :func:`counted`
    wraps the rest."""
    counter = _active
    if counter is None or counter.inside:
        yield
        return
    counter.inside += 1
    try:
        counter.kernel(name, *work())
        yield
    finally:
        counter.inside -= 1


def counted(name: str, work: Callable[..., Tuple[float, float]]):
    """Decorate a kernel-backed op: with a counter active, count ``work`` of
    the call's arguments (flops, bytes) once and nothing the op runs
    inside; without one, call the op."""
    def wrap(op):
        @functools.wraps(op)
        def call(*args, **kwargs):
            counter = _active
            if counter is None or counter.inside:
                return op(*args, **kwargs)
            counter.inside += 1
            try:
                counter.kernel(name, *work(*args, **kwargs))
                return op(*args, **kwargs)
            finally:
                counter.inside -= 1
        return call
    return wrap
