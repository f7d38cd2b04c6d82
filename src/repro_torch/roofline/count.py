"""The roofline's counter: FLOPs and bytes of what a function runs, counted
while it runs (the port's counterpart of ``repro.roofline.hlo``).

The reference parses a compiled HLO module; the port has no module to
parse, so :func:`count_costs` sits under PyTorch's dispatcher (a
``TorchDispatchMode``) and counts each aten op as it is dispatched, by
the rules ``hlo.py`` applies to HLO instructions (a composite op is
counted as what it decomposes into, as XLA counts the lowered program):

* ``flops`` — matrix products and convolutions (``mm``, ``addmm``,
  ``bmm``, ``baddbmm`` in every overload, ``mv``, ``dot``, ``convolution``
  and its backward): 2 · output elements · contraction; every other op adds
  none (the ``.dtype`` and ``.out`` overloads were once missed: the
  card's bf16 LM head with its float32 result, and the experts'
  down-projection written into its buffer, added no FLOPs);
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
* ``collective_bytes`` — each collective of
  :mod:`repro_torch.sharding.comm` (a real gloo world's or the counting
  world's) adds its entry to the ``ledger`` (op, group, group size,
  payload bytes, ring factor, bytes moved a device) by ``hlo.py``'s rules:
  an all-reduce moves 2(g-1)/g of its payload, an all-gather (g-1)/g of
  its result, a reduce-scatter (g-1)/g of its input; ``by_collective`` and
  ``collective_count`` sum them by op under the reference's names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``).

Memory (:func:`count_call`): the storages the call makes and frees are
tracked while it runs (on the CPU the storages that a kernel-backed op's
plain version makes inside stand for no kernel's and are skipped; its
outputs count), and reported as XLA's ``memory_analysis()`` reports them:
``argument_bytes`` (what the call's arguments hold), ``output_bytes``
(what it returns, and the arguments it updates in place), ``alias_bytes``
(those arguments), ``temp_bytes`` (the peak of everything else) and
``peak_per_device_bytes`` = argument + output + temp - alias (the
reference dry run's formula, a bound: it holds the outputs and the peak
of the temporaries at once), and beside them ``live_peak_bytes``, the
most the call's own storages held at one point of the timeline.  The same
program on meta tensors and on the card makes the same storages in the
same order, so the two read the same; the card's ``max_memory_allocated``
less what was allocated before the call reads ``live_peak_bytes`` plus
the allocator's rounding and what libraries allocate below the
dispatcher.

The counter is process-wide: one module global, checked once per
kernel-backed op.  With no counter active nothing else happens: no
allocation, no host sync.  While one is active the decode family and
``varlen_prefill`` read their lengths to the host to count live keys (on
meta tensors, which hold no lengths, the decode kernel counts every row at
its host-known bound), so never count a pass that is being timed.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten
# how long a collective under count_call waits for the backend to let go
# of its buffers
RELEASE_S = 10.0


@dataclass
class Costs:
    flops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    # kernel name -> (calls, flops, bytes) of the kernel-backed ops counted
    by_kernel: Dict[str, Tuple[int, float, float]] = field(default_factory=dict)
    # one entry a collective, in the order they ran (see the module)
    ledger: List[Dict[str, Any]] = field(default_factory=list)
    # the call's memory (count_call only)
    memory: Optional["MemoryAnalysis"] = None

    def __iadd__(self, other: "Costs") -> "Costs":
        self.flops += other.flops
        self.memory_bytes += other.memory_bytes
        self.collective_bytes += other.collective_bytes
        self.ledger += other.ledger
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


@dataclass(frozen=True)
class MemoryAnalysis:
    """One call's memory, by XLA's ``memory_analysis()`` fields (see the
    module)."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    # the most the call's own storages, outputs and temporaries together,
    # held at one point of its timeline: what the card's
    # max_memory_allocated adds over the call (not one of XLA's fields)
    live_peak_bytes: int = 0

    @property
    def peak_per_device_bytes(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes - self.alias_bytes

    def to_dict(self) -> Dict[str, int]:
        return {"argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes, "alias_bytes": self.alias_bytes,
                "peak_per_device_bytes": self.peak_per_device_bytes}


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the tensors of ``tree``, each storage once."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


class _Memory:
    """The storages made while a call runs, each with an allocation id,
    and the timeline of their allocations and frees (a finalizer on each
    storage), beside the argument storages the call started with."""

    def __init__(self, arguments) -> None:
        self.arguments = _storages(arguments)
        self.live: Dict[int, int] = {}              # storage key -> allocation id
        self.timeline: List[Tuple[int, int]] = []    # (allocation id, +bytes or -bytes)
        self.open = True

    def track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.arguments or key in self.live:
                continue
            nbytes = st.nbytes()
            if not nbytes:
                continue
            aid = len(self.timeline)
            self.live[key] = aid
            self.timeline.append((aid, nbytes))
            weakref.finalize(st, self._free, key, aid, nbytes)

    def _free(self, key: int, aid: int, nbytes: int) -> None:
        if not self.open:
            return
        if self.live.get(key) == aid:
            del self.live[key]
        self.timeline.append((aid, -nbytes))

    def analysis(self, outputs, aliased) -> MemoryAnalysis:
        self.open = False
        outs = {self.live[k] for k in _storages(outputs) if k in self.live}
        new_out = sum(n for aid, n in self.timeline if aid in outs and n > 0)
        temp = peak = live = live_peak = 0
        for aid, n in self.timeline:
            live += n
            live_peak = max(live_peak, live)
            if aid not in outs:
                temp += n
                peak = max(peak, temp)
        alias = sum(_storages(aliased).values())
        return MemoryAnalysis(argument_bytes=sum(self.arguments.values()),
                              output_bytes=new_out + alias, temp_bytes=peak, alias_bytes=alias,
                              live_peak_bytes=live_peak)


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
    # every overload: ``.dtype`` is the card's bf16 product with a float32
    # result (the LM head, the row-parallel partials), ``.out`` a product
    # written into a given buffer (the experts' down-projection)
    **{getattr(aten.mm, o): (lambda a, k, r: _mm_flops(a[0], r))
       for o in ("default", "out", "dtype", "dtype_out")},
    **{getattr(aten.addmm, o): (lambda a, k, r: _mm_flops(a[1], r))
       for o in ("default", "out", "dtype", "dtype_out")},
    **{getattr(aten.bmm, o): (lambda a, k, r: _mm_flops(a[0], r))
       for o in ("default", "out", "dtype", "dtype_out")},
    **{getattr(aten.baddbmm, o): (lambda a, k, r: _mm_flops(a[1], r))
       for o in ("default", "out", "dtype", "dtype_out")},
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
    def __init__(self, costs: Costs, memory: Optional[_Memory] = None) -> None:
        super().__init__()
        self.costs = costs
        self.memory = memory
        self.inside = 0             # depth of the kernel-backed ops running

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.inside:
            out = func(*args, **kwargs)
            # a kernel's own outputs and workspaces (the card, meta); not the
            # storages of the plain version that stands in for it on the CPU
            if self.memory is not None and not _on_cpu(out):
                self.memory.track(out)
            return out
        if func not in _COUNTED:
            # a composite op (inference mode dispatches conv2d, linear,
            # matmul, to, ... whole): count what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        if self.memory is not None:
            self.memory.track(out)
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
        # an ``out=`` buffer is the op's output: counted once
        ins = {k: v for k, v in kwargs.items() if k != "out"}
        c.memory_bytes += _leaves_bytes(args) + _leaves_bytes(ins) + _leaves_bytes(out)

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.costs
        c.flops += flops
        c.memory_bytes += nbytes
        n0, f0, b0 = c.by_kernel.get(name, (0, 0.0, 0.0))
        c.by_kernel[name] = (n0 + 1, f0 + flops, b0 + nbytes)


def _on_cpu(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in tree_leaves(tree))


_active: Optional[_Counter] = None


def counting() -> bool:
    """Whether a :func:`count_costs` is active."""
    return _active is not None


@contextlib.contextmanager
def count_costs(_memory: Optional[_Memory] = None) -> Iterator[Costs]:
    """Count the FLOPs, bytes and collectives of everything run inside, on
    any device; yields the :class:`Costs` it fills.  Not reentrant."""
    global _active
    if _active is not None:
        raise RuntimeError("count_costs is already active")
    costs = Costs()
    counter = _Counter(costs, _memory)
    _active = counter
    try:
        with counter:
            yield costs
    finally:
        _active = None


_warmed = False


def _warm() -> None:
    """Once a process: a first dispatch through a mode imports PyTorch's
    compiler stack, and the import leaves reference cycles that hold that
    call's tensors until the collector runs; take it on meta tensors here,
    then collect."""
    global _warmed
    if _warmed:
        return
    _warmed = True
    with count_costs():
        x = torch.empty(2, 3, device="meta")
        (x.long() + 1).float() @ torch.empty(3, 2, device="meta")
    gc.collect()


def count_call(fn: Callable, *args, aliased=(), **kwargs) -> Tuple[Any, Costs]:
    """``fn(*args, **kwargs)`` under the counter: (its result, its
    :class:`Costs` with ``memory`` filled).  ``aliased``: the arguments the
    call updates in place (the serving cache), which XLA would donate and
    alias to an output."""
    _warm()
    memory = _Memory((args, kwargs))
    # the storages are freed by reference counting; the collector, whose
    # runs depend on everything else the process does, is held off so that
    # every run of the call frees them at the same points
    collecting = gc.isenabled()
    gc.disable()
    try:
        with count_costs(memory) as costs:
            out = fn(*args, **kwargs)
            costs.memory = memory.analysis(out, aliased)
    finally:
        if collecting:
            gc.enable()
    return out, costs


@contextlib.contextmanager
def collective(op: str, group: str, size: int, payload_bytes: int,
               buffers: Tuple[torch.Tensor, ...] = ()) -> Iterator[None]:
    """Around one collective's exchange: add it to the active counter's
    ledger (a no-op without one): ``op`` in the reference's names, its
    group's name and size, and its payload (an all-reduce's tensor, an
    all-gather's result, a reduce-scatter's input); bytes moved a device by
    ``hlo.py``'s ring factors.  Under :func:`count_call` the exchange is
    followed by a wait until the backend has let go of the ``buffers``
    handed to it: gloo's worker thread can hold them a moment past a
    synchronous call's return, which would move their frees, and so the
    call's counted memory, from run to run."""
    counter = _active
    if counter is None:
        yield
        return
    _ledger(counter.costs, op, group, size, payload_bytes)
    held = [b._use_count() for b in buffers] if counter.memory is not None else []
    yield
    deadline = time.monotonic() + RELEASE_S
    while any(b._use_count() > n for b, n in zip(buffers, held)):
        if time.monotonic() > deadline:
            raise RuntimeError(f"{op}: the backend still holds its buffers {RELEASE_S} s "
                               f"after the exchange")
        time.sleep(0)


def _ledger(c: Costs, op: str, group: str, size: int, payload_bytes: int) -> None:
    factor = (size - 1) / size * (2.0 if op == "all-reduce" else 1.0)
    moved = payload_bytes * factor
    c.collective_bytes += moved
    c.by_collective[op] = c.by_collective.get(op, 0.0) + moved
    c.collective_count[op] = c.collective_count.get(op, 0) + 1
    c.ledger.append({"op": op, "group": group, "size": size, "payload_bytes": payload_bytes,
                     "ring_factor": factor, "moved_bytes": moved})


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
                out = op(*args, **kwargs)
            finally:
                counter.inside -= 1
            if counter.memory is not None:
                counter.memory.track(out)
            return out
        return call
    return wrap
