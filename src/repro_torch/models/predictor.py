"""The port's model-zoo predictor: the platform's ``torch`` framework
predictor (the counterpart of ``repro.models.predictor.JaxModelPredictor``).

Implements the 3-function predictor interface (:mod:`repro_torch.core.
predictor`) over the port's architectures.  ``open`` builds the
manifest's model through ``build_model`` (a :class:`DecoderLM`, or the
enc-dec family's :class:`EncDecLM`) at the manifest's width on the agent's
device (bf16 on the card, float32 on the CPU) with random weights from the
manifest's seed; ``predict`` turns int32 tokens into ``forward``'s
float32 logits, returned as numpy like the reference's ``np.asarray(out)``,
so the timed predict of a scenario includes the logits' copy to the host.
An enc-dec model's forward takes zero encoder frames ``(b, encoder_seq,
d_model)``, as the reference's predictor gives it (the audio front end is
a stub).  ResNet-50 (``arch`` ``resnet*``; :class:`~repro_torch.models.
resnet.ResNet`, full or reduced as the manifest says) turns float32
images ``(b, H, W, 3)`` (one image ``(H, W, 3)`` gets a batch axis) into
float32 logits ``(b, num_classes)``.

Trace levels:

* MODEL     — ``model_load``/``weight_init``/``inference`` spans; on the card
              the ``inference`` span closes after ``torch.cuda.synchronize``,
              so it times the device work
* FRAMEWORK — per-layer spans through the model's ``forward_instrumented``,
              each layer synchronized with the device (the reference's
              ``jax.block_until_ready`` per layer): more visibility, more
              overhead.  ResNet-50 opens no layer span, as in the
              reference: only ``inference``
* SYSTEM    — on the card one ``system:cuda`` event per predict: the
              forward's device busy time (``device_ms``: the durations of
              the device's kernels, copies and sets that torch.profiler
              records during the forward, summed), the launches of each
              hand-written kernel during the predict (the change of each
              ``repro_torch.kernels`` wrapper's ``launches`` counter) and
              ``torch.cuda.max_memory_allocated``; ResNet-50's launches are
              empty (cuDNN runs its convolutions, no hand-written kernel).
              On the CPU there is no such event.  (The reference reads
              FLOPs and bytes from XLA's cost analysis; the port's counters
              of those wait for its roofline.)
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Union

import numpy as np
import torch

from ..configs import get_config
from ..core.predictor import OpenRequest, Predictor, PredictorHandle, _handles
from ..core.tracing import Tracer, TraceLevel
from ..device import resolve_device
from ..kernels import kernel_counters
from .lm import DecoderLM, EncDecLM, build_model
from .resnet import ResNet, ResNetConfig


class TorchModelPredictor(Predictor):
    name = "torch"
    version = "1.0.0"

    # -- ModelLoad ---------------------------------------------------------------
    def open(self, req: OpenRequest, tracer: Tracer) -> PredictorHandle:
        manifest = req.manifest
        arch = manifest.arch or manifest.name
        with tracer.span("model_load", TraceLevel.MODEL, arch=arch, backend=self.name):
            if arch.startswith("resnet"):
                state = self._open_resnet(req, tracer)
            else:
                state = self._open_lm(req, tracer, arch)
        return PredictorHandle(
            handle_id=next(_handles),
            backend=self.name,
            model_key=manifest.key,
            state=state,
        )

    def _open_lm(self, req: OpenRequest, tracer: Tracer, arch: str) -> Dict[str, Any]:
        cfg = get_config(arch, reduced=req.manifest.reduced)
        model = build_model(cfg, device=resolve_device(req.device))
        with tracer.span("weight_init", TraceLevel.MODEL):
            params = model.init(_seed(req))
            _sync(model.device)
        return {"kind": "lm", "cfg": cfg, "model": model, "params": params,
                "seq_len": req.seq_len}

    def _open_resnet(self, req: OpenRequest, tracer: Tracer) -> Dict[str, Any]:
        cfg = ResNetConfig()
        if req.manifest.reduced:
            cfg = cfg.reduced()
        model = ResNet(cfg, device=resolve_device(req.device))
        with tracer.span("weight_init", TraceLevel.MODEL):
            params = model.init(_seed(req))
            _sync(model.device)
        return {"kind": "resnet", "cfg": cfg, "model": model, "params": params}

    # -- Predict ------------------------------------------------------------------
    def predict(self, handle: PredictorHandle, batch: Any, tracer: Tracer) -> Any:
        state = handle.state
        model, params = state["model"], state["params"]
        if state["kind"] == "resnet":
            images = torch.from_numpy(np.asarray(batch, dtype=np.float32))
            if images.ndim == 3:
                images = images[None]
            images = images.to(model.device)
            with _system_event(model.device, tracer), torch.inference_mode():
                out = self._inference(model, tracer, images.shape[0],
                                      lambda: model.forward(params, images))
            return out.cpu().numpy()

        tokens = torch.from_numpy(np.asarray(batch, dtype=np.int32))
        if tokens.ndim == 1:
            tokens = tokens[None]
        model_batch = {"tokens": tokens.to(model.device)}
        cfg = state["cfg"]
        if cfg.family == "encdec":
            model_batch["frames"] = torch.zeros(
                (tokens.shape[0], cfg.encoder_seq, cfg.d_model), dtype=model.dtype,
                device=model.device)
        with _system_event(model.device, tracer), torch.inference_mode():
            if tracer.enabled(TraceLevel.FRAMEWORK):
                out = self._predict_instrumented(model, params, model_batch, tracer)
            else:
                out = self._inference(model, tracer, tokens.shape[0],
                                      lambda: model.forward(params, model_batch)[0])
        return out.cpu().numpy()

    @staticmethod
    def _inference(model, tracer: Tracer, batch: int, forward) -> torch.Tensor:
        """The MODEL ``inference`` span: the forward and the device sync."""
        with tracer.span("inference", TraceLevel.MODEL, batch=int(batch)):
            out = forward()
            _sync(model.device)
        return out

    def _predict_instrumented(self, model: Union[DecoderLM, EncDecLM], params, model_batch,
                              tracer: Tracer) -> torch.Tensor:
        def hook(name: str, thunk):
            with tracer.span(name, TraceLevel.FRAMEWORK):
                out = thunk()
                _sync(model.device)
                return out

        with tracer.span("inference", TraceLevel.MODEL, instrumented=True):
            return model.forward_instrumented(params, model_batch, hook)

    # -- ModelUnload ----------------------------------------------------------------
    def close(self, handle: PredictorHandle) -> None:
        handle.state = None


def _seed(req: OpenRequest) -> int:
    return int(req.manifest.model_assets.get("seed", 0))


@contextlib.contextmanager
def _system_event(device: torch.device, tracer: Tracer):
    """At SYSTEM level on the card, one ``system:cuda`` event for the work
    inside: its device busy ms (torch.profiler), the launches of each
    hand-written kernel (the change of each wrapper's counter) and the
    peak memory.  Elsewhere a no-op."""
    if not (tracer.enabled(TraceLevel.SYSTEM) and device.type == "cuda"):
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    counters = kernel_counters()
    before = {name: mod.launches for name, mod in counters.items()}
    torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    launches = {name: mod.launches - before[name] for name, mod in counters.items()}
    tracer.event(
        "system:cuda",
        0.0,
        0.0,
        TraceLevel.SYSTEM,
        device_ms=_device_ms(prof),
        launches={k: v for k, v in sorted(launches.items()) if v},
        max_memory_allocated=int(torch.cuda.max_memory_allocated(device)),
    )


def _device_ms(prof) -> float:
    """The device's busy ms in a profile: the durations of its kernels,
    copies and sets, summed (one stream: they do not overlap).  Read from
    the profiler's raw results: its per-op tables cost ~1 s a predict to
    build."""
    from torch.autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
