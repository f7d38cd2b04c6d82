"""Streaming evaluation pipeline (paper F6, §4.4.2).

The agent's model-evaluation pipeline is a chain of *pipeline operators*
mapped onto light-weight threads, each pair connected by a bounded queue so
operators form producer/consumer relationships and I/O overlaps compute.
Pre-processing, model inference, and post-processing are all operators.

Built-in operators mirror the manifest's built-in processing steps
(§4.1.1): decode / resize / normalize / tokenize for pre-processing,
argsort / top-k / detokenize for post-processing. Arbitrary-callable
operators are supported (the paper's custom Python functions).

The port's copy of ``repro.core.pipeline``.  Every module of ``repro_torch``
keeps its own copy of what it needs so that it never imports ``repro``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .manifest import ProcessingStep
from .tracing import Tracer, TraceLevel

_END = object()  # stream terminator sentinel


@dataclass
class Item:
    """One element flowing through the pipeline."""

    index: int
    data: Any
    meta: Dict[str, Any]


OpFn = Callable[[Any, Dict[str, Any]], Any]


class Pipeline:
    """A chain of operators executed on threads with bounded channels."""

    def __init__(
        self,
        operators: Sequence[tuple],
        tracer: Optional[Tracer] = None,
        channel_capacity: int = 8,
    ) -> None:
        """``operators`` is a sequence of (name, fn) pairs; fn(data, meta)."""
        if not operators:
            raise ValueError("pipeline requires at least one operator")
        self.operators = list(operators)
        self.tracer = tracer
        self.capacity = channel_capacity

    def run(self, inputs: Iterable[Any]) -> List[Any]:
        """Stream ``inputs`` through all operators; return ordered outputs."""
        return list(self.stream(inputs))

    def stream(self, inputs: Iterable[Any]) -> Iterator[Any]:
        n_ops = len(self.operators)
        channels: List["queue.Queue"] = [
            queue.Queue(maxsize=self.capacity) for _ in range(n_ops + 1)
        ]
        errors: List[BaseException] = []

        def feed() -> None:
            try:
                for i, x in enumerate(inputs):
                    channels[0].put(Item(index=i, data=x, meta={}))
            except BaseException as e:  # noqa: BLE001 - propagated below
                errors.append(e)
            finally:
                channels[0].put(_END)

        def stage(op_idx: int) -> None:
            name, fn = self.operators[op_idx]
            src, dst = channels[op_idx], channels[op_idx + 1]
            try:
                while True:
                    item = src.get()
                    if item is _END:
                        break
                    if self.tracer is not None:
                        with self.tracer.span(
                            f"op:{name}", TraceLevel.MODEL, index=item.index
                        ):
                            item.data = fn(item.data, item.meta)
                    else:
                        item.data = fn(item.data, item.meta)
                    dst.put(item)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
            finally:
                dst.put(_END)

        threads = [threading.Thread(target=feed, daemon=True)]
        threads += [
            threading.Thread(target=stage, args=(i,), daemon=True)
            for i in range(n_ops)
        ]
        for t in threads:
            t.start()
        out = channels[-1]
        while True:
            item = out.get()
            if item is _END:
                break
            yield item.data
        for t in threads:
            t.join()
        if errors:
            raise errors[0]


# --------------------------------------------------------------------------
# Built-in operators (manifest `steps` -> callables)
# --------------------------------------------------------------------------
def _op_decode(params: Dict[str, Any]) -> OpFn:
    """Decode raw bytes/lists to an ndarray with the given layout."""
    dtype = np.dtype(params.get("element_type", "float32"))

    def fn(data: Any, meta: Dict[str, Any]) -> np.ndarray:
        arr = np.asarray(data, dtype=dtype)
        meta["decoded_shape"] = arr.shape
        return arr

    return fn


def _op_resize(params: Dict[str, Any]) -> OpFn:
    """Nearest-neighbour resize of an HWC image to `dimensions` [C,H,W]."""
    dims = params.get("dimensions")
    if not dims or len(dims) != 3:
        raise ValueError("resize requires dimensions: [C, H, W]")
    c, h, w = dims

    def fn(data: Any, meta: Dict[str, Any]) -> np.ndarray:
        img = np.asarray(data)
        if img.ndim == 2:
            img = img[..., None].repeat(c, axis=-1)
        ih, iw = img.shape[:2]
        ys = np.clip((np.arange(h) * ih / h).astype(int), 0, ih - 1)
        xs = np.clip((np.arange(w) * iw / w).astype(int), 0, iw - 1)
        return img[np.ix_(ys, xs)]

    return fn


def _op_normalize(params: Dict[str, Any]) -> OpFn:
    mean = np.asarray(params.get("mean", 0.0), dtype=np.float32)
    rescale = float(params.get("rescale", 1.0))
    std = np.asarray(params.get("std", 1.0), dtype=np.float32)

    def fn(data: Any, meta: Dict[str, Any]) -> np.ndarray:
        return (np.asarray(data, dtype=np.float32) - mean) / std / rescale

    return fn


def _op_tokenize(params: Dict[str, Any]) -> OpFn:
    """Toy byte-level tokenizer for LM workloads (vocab-mod folding)."""
    vocab = int(params.get("vocab_size", 256))
    max_len = int(params.get("max_len", 128))
    pad_id = int(params.get("pad_id", 0))

    def fn(data: Any, meta: Dict[str, Any]) -> np.ndarray:
        if isinstance(data, str):
            ids = np.frombuffer(data.encode("utf-8"), dtype=np.uint8).astype(np.int32)
            ids = ids % vocab
        else:
            ids = np.asarray(data, dtype=np.int32) % vocab
        out = np.full((max_len,), pad_id, dtype=np.int32)
        n = min(len(ids), max_len)
        out[:n] = ids[:n]
        meta["num_tokens"] = int(n)
        return out

    return fn


def _op_argsort(params: Dict[str, Any]) -> OpFn:
    """Post-process logits/probabilities to top-K (label, score) pairs."""
    k = int(params.get("k", 5))
    labels = params.get("labels")

    def fn(data: Any, meta: Dict[str, Any]) -> List[tuple]:
        probs = np.asarray(data)
        flat = probs.reshape(-1)
        idx = np.argsort(-flat)[:k]
        return [
            (labels[i] if labels and i < len(labels) else int(i), float(flat[i]))
            for i in idx
        ]

    return fn


def _op_topk_tokens(params: Dict[str, Any]) -> OpFn:
    k = int(params.get("k", 1))

    def fn(data: Any, meta: Dict[str, Any]) -> np.ndarray:
        logits = np.asarray(data)
        return np.argsort(-logits, axis=-1)[..., :k]

    return fn


def _op_identity(params: Dict[str, Any]) -> OpFn:
    return lambda data, meta: data


_BUILTIN_OPS: Dict[str, Callable[[Dict[str, Any]], OpFn]] = {
    "decode": _op_decode,
    "resize": _op_resize,
    "normalize": _op_normalize,
    "tokenize": _op_tokenize,
    "argsort": _op_argsort,
    "topk_tokens": _op_topk_tokens,
    "identity": _op_identity,
}


def register_op(name: str, factory: Callable[[Dict[str, Any]], OpFn]) -> None:
    """Extensibility hook (§4.6): add custom pipeline operators."""
    _BUILTIN_OPS[name] = factory


def build_steps(steps: Sequence[ProcessingStep]) -> List[tuple]:
    """Compile manifest processing steps into (name, fn) operator pairs,
    executed in the order they appear in the manifest (§4.1.1)."""
    ops = []
    for s in steps:
        try:
            factory = _BUILTIN_OPS[s.op]
        except KeyError:
            raise KeyError(f"unknown processing op {s.op!r}; have {sorted(_BUILTIN_OPS)}")
        ops.append((s.op, factory(s.params)))
    return ops
