"""Predictor interface (paper F2/F3, §4.4.3, Listing 3).

The paper wraps each framework's C API behind three functions::

    ModelHandle   ModelLoad(OpenRequest)
    Error         ModelUnload(ModelHandle)
    PredictResponse Predict(ModelHandle, PredictRequest, PredictOptions)

Anything implementing the 3-function interface is a valid predictor — the
paper exposes FPGAs this way.  The port's copy of ``repro.core.predictor``:
its built-in backend is ``torch`` (:class:`repro_torch.models.predictor.
TorchModelPredictor`, the model zoo on the hand-written CUDA kernels), where
the reference registers the JAX ``ref`` and ``pallas`` backends.  A
predictor owns materialized weights and hides everything else from the
agent, keeping the agent code backend-agnostic.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from .manifest import ModelManifest
from .tracing import NullTracer, Tracer, TraceLevel

_handles = itertools.count(1)


@dataclass
class OpenRequest:
    """Listing 4's OpenRequest: everything needed to load one predictor."""

    manifest: ModelManifest
    backend: str = "torch"
    batch_size: int = 1
    seq_len: int = 128
    mode: str = "serve"          # "serve" | "train"
    options: Dict[str, Any] = field(default_factory=dict)
    device: Optional[str] = None  # the agent's device (None: the predictor's default)


@dataclass
class PredictorHandle:
    handle_id: int
    backend: str
    model_key: str
    state: Any = None            # backend-private (weights, compiled fns, caches)


class Predictor:
    """Abstract 3-function predictor. Subclass and register a factory."""

    name = "abstract"
    version = "1.0.0"

    def open(self, req: OpenRequest, tracer: Tracer) -> PredictorHandle:
        raise NotImplementedError

    def predict(
        self, handle: PredictorHandle, batch: Any, tracer: Tracer
    ) -> Any:
        raise NotImplementedError

    def close(self, handle: PredictorHandle) -> None:
        raise NotImplementedError


class CallablePredictor(Predictor):
    """Wrap plain callables as a predictor (the FPGA/ASIC story of §4.4.3:
    implementing the 3 functions is sufficient — no framework needed)."""

    def __init__(
        self,
        name: str,
        load_fn: Callable[[OpenRequest], Any],
        predict_fn: Callable[[Any, Any], Any],
        unload_fn: Optional[Callable[[Any], None]] = None,
        version: str = "1.0.0",
    ) -> None:
        self.name = name
        self.version = version
        self._load = load_fn
        self._predict = predict_fn
        self._unload = unload_fn

    def open(self, req: OpenRequest, tracer: Tracer) -> PredictorHandle:
        with tracer.span("model_load", TraceLevel.MODEL, backend=self.name):
            state = self._load(req)
        return PredictorHandle(
            handle_id=next(_handles),
            backend=self.name,
            model_key=req.manifest.key,
            state=state,
        )

    def predict(self, handle: PredictorHandle, batch: Any, tracer: Tracer) -> Any:
        with tracer.span("inference", TraceLevel.MODEL, backend=self.name):
            return self._predict(handle.state, batch)

    def close(self, handle: PredictorHandle) -> None:
        if self._unload is not None:
            self._unload(handle.state)
        handle.state = None


# --------------------------------------------------------------------------
# Predictor registry (the "adding frameworks" extension point, §4.6)
# --------------------------------------------------------------------------
_FACTORIES: Dict[str, Callable[[], Predictor]] = {}
_lock = threading.Lock()


def register_predictor(name: str, factory: Callable[[], Predictor]) -> None:
    with _lock:
        _FACTORIES[name] = factory


def make_predictor(name: str) -> Predictor:
    with _lock:
        try:
            factory = _FACTORIES[name]
        except KeyError:
            raise KeyError(
                f"no predictor backend {name!r}; registered: {sorted(_FACTORIES)}"
            )
    return factory()


def available_backends() -> list:
    with _lock:
        return sorted(_FACTORIES)


def _torch_predictor() -> Predictor:
    """The port's model-zoo predictor, imported when an agent first makes
    one (the models import the kernels, and ``models.predictor`` imports
    this module)."""
    from ..models.predictor import TorchModelPredictor  # noqa: WPS433

    return TorchModelPredictor()


register_predictor("torch", _torch_predictor)
