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
* SYSTEM    — one ``system:cost`` event per predict, on any device: the
              forward's FLOPs and bytes (``flops``, ``bytes_accessed``, the
              reference's tags) as the roofline's counter counts them
              (:func:`repro_torch.roofline.count_costs`: aten products and
              traffic, each hand-written kernel's work from
              :mod:`repro_torch.roofline.work`), with their roofline terms
              on an H100 (``compute_term_s``, ``memory_term_s``,
              ``step_time_bound_s``, ``dominant``).  Counted once per batch
              shape by a forward of its own, cached in the handle as the
              reference caches its cost analysis, and run after the
              ``inference`` span and outside the profile below, so neither
              times it; ``counted`` says whether this predict ran it (that
              forward launches the kernels once more).  On the card also
              one ``system:cuda`` event per predict: the forward's device
              busy time (``device_ms``: the durations of the device's
              kernels, copies and sets that torch.profiler records for the
              forward's launches, summed; ``device_records``; the forward
              starts ``WINDOW_GUARD_S`` after the profiler's window opens,
              behind ``PROLOGUE`` tiny kernels that take the profiler's
              losses at a window's start (``prologue_lost`` of them lost
              theirs), and ``lost_records`` counts the forward's launches
              whose device record is missing), the
              launches of each hand-written kernel during the predict (the
              change of each ``repro_torch.kernels`` wrapper's
              ``launches`` counter) and
              ``torch.cuda.max_memory_allocated``; ResNet-50's launches are
              empty (cuDNN runs its convolutions, no hand-written kernel).
              On the CPU there is no such event.
"""
from __future__ import annotations

import contextlib
import re
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import get_config
from ..core.predictor import OpenRequest, Predictor, PredictorHandle, _handles
from ..core.tracing import Tracer, TraceLevel
from ..device import resolve_device
from ..kernels import kernel_counters
from ..roofline import count_costs, roofline_from_costs
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
                "seq_len": req.seq_len, "costs": {}}

    def _open_resnet(self, req: OpenRequest, tracer: Tracer) -> Dict[str, Any]:
        cfg = ResNetConfig()
        if req.manifest.reduced:
            cfg = cfg.reduced()
        model = ResNet(cfg, device=resolve_device(req.device))
        with tracer.span("weight_init", TraceLevel.MODEL):
            params = model.init(_seed(req))
            _sync(model.device)
        return {"kind": "resnet", "cfg": cfg, "model": model, "params": params, "costs": {}}

    # -- Predict ------------------------------------------------------------------
    def predict(self, handle: PredictorHandle, batch: Any, tracer: Tracer) -> Any:
        state = handle.state
        model, params = state["model"], state["params"]
        if state["kind"] == "resnet":
            images = torch.from_numpy(np.asarray(batch, dtype=np.float32))
            if images.ndim == 3:
                images = images[None]
            images = images.to(model.device)
            forward = lambda: model.forward(params, images)
            with _system_event(model.device, tracer), torch.inference_mode():
                out = self._inference(model, tracer, images.shape[0], forward)
            self._cost_event(state, tracer, {"images": images}, forward)
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
        forward = lambda: model.forward(params, model_batch)[0]
        with _system_event(model.device, tracer), torch.inference_mode():
            if tracer.enabled(TraceLevel.FRAMEWORK):
                out = self._predict_instrumented(model, params, model_batch, tracer)
            else:
                out = self._inference(model, tracer, tokens.shape[0], forward)
        self._cost_event(state, tracer, model_batch, forward)
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

    @staticmethod
    def _cost_event(state: Dict[str, Any], tracer: Tracer, model_batch: Dict[str, torch.Tensor],
                    forward) -> None:
        """At SYSTEM level, one ``system:cost`` event: the costs of this
        batch shape, counted by a forward of their own on the first predict
        of the shape and cached in the handle's state."""
        if not tracer.enabled(TraceLevel.SYSTEM):
            return
        key = tuple((k, tuple(v.shape)) for k, v in sorted(model_batch.items()))
        costs = state["costs"].get(key)
        counted = costs is None
        if counted:
            with count_costs() as costs, torch.inference_mode():
                forward()
            _sync(state["model"].device)
            state["costs"][key] = costs
        r = roofline_from_costs(costs, arch=state["cfg"].name, shape=str(key), mesh_name="1",
                                chips=1)
        tracer.event(
            "system:cost",
            0.0,
            0.0,
            TraceLevel.SYSTEM,
            flops=costs.flops,
            bytes_accessed=costs.memory_bytes,
            compute_term_s=r.compute_term_s,
            memory_term_s=r.memory_term_s,
            step_time_bound_s=r.step_time_bound_s,
            dominant=r.dominant,
            counted=counted,
        )

    # -- ModelUnload ----------------------------------------------------------------
    def close(self, handle: PredictorHandle) -> None:
        handle.state = None


def _seed(req: OpenRequest) -> int:
    return int(req.manifest.model_assets.get("seed", 0))


# torch.profiler loses device records at the start of a short window, in
# two ways.  Its conversion of the device's timestamps to the host's clock
# can run milliseconds early (up to 7.6 ms in a process alone on the card,
# 22.7 ms once after other processes had used it), and the records of the
# first launches then fall before the window and are dropped (a predict
# read 0.0 device ms, or part of its time); and every window loses the
# records of its first launches, once the port's kernel library is loaded
# or another process has used the card (1 to 10 in a short process, dozens
# in a long one).  So the work starts WINDOW_GUARD_S after the window opens,
# behind PROLOGUE tiny kernels that take those losses; only the launches
# made inside the work's range count, each matched to its device record.
WINDOW_GUARD_S = 0.1
PROLOGUE = 256
_WORK = "system:work"
_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy|Memset)")


@contextlib.contextmanager
def _system_event(device: torch.device, tracer: Tracer):
    """At SYSTEM level on the card, one ``system:cuda`` event for the work
    inside: its device busy ms (torch.profiler), its launches' device
    records and the launches whose device record the profiler lost (0
    unless it failed), whether the work's range was found in the profile,
    the launches of each hand-written kernel (the change of each wrapper's
    counter) and the peak memory.  ``device_ms`` is None, not a partial
    sum, where the range was not found or a launch inside it lost its
    record.  The work starts ``WINDOW_GUARD_S`` after the profiler's window
    opens, the device idle, behind ``PROLOGUE`` tiny kernels outside the
    count.  Elsewhere a no-op."""
    if not (tracer.enabled(TraceLevel.SYSTEM) and device.type == "cuda"):
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    counters = kernel_counters()
    before = {name: mod.launches for name, mod in counters.items()}
    torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        time.sleep(WINDOW_GUARD_S)
        with torch.cuda.device(device):
            for _ in range(PROLOGUE):
                torch.cuda._sleep(1)
        torch.cuda.synchronize(device)
        with record_function(_WORK):
            yield
    launches = {name: mod.launches - before[name] for name, mod in counters.items()}
    device_ms, records, lost, prologue_lost, found = _device_records(
        prof.profiler.kineto_results.events())
    tracer.event(
        "system:cuda",
        0.0,
        0.0,
        TraceLevel.SYSTEM,
        device_ms=device_ms,
        device_records=records,
        lost_records=lost,
        work_range_found=found,
        prologue_lost=prologue_lost,
        launches={k: v for k, v in sorted(launches.items()) if v},
        max_memory_allocated=int(torch.cuda.max_memory_allocated(device)),
    )


def _device_records(events) -> Tuple[Optional[float], int, int, int, bool]:
    """(the work's device busy ms, its device records, its launches with no
    device record, the prologue's launches with none, whether the
    ``system:work`` range was found) in a profile's raw events: each
    runtime or driver launch, copy or set made inside the range, matched to
    its device record by correlation id; the records' durations summed (one
    stream: they do not overlap).  The busy ms is None where the range is
    missing or a launch inside it has no record: a window that lost work
    gives no device time, never a partial one.  Read from the raw results:
    the profiler's per-op tables cost ~1 s a predict to build."""
    from torch.autograd import DeviceType

    device, host = {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device[e.correlation_id()] = e
        else:
            host.append(e)
    work = next((e for e in host if e.name() == _WORK), None)
    if work is None:
        return None, 0, 0, 0, False
    launches = [e for e in host if _LAUNCH.match(e.name())]
    inside = [e for e in launches if work.start_ns() <= e.start_ns() <= work.end_ns()]
    found = [device[e.correlation_id()] for e in inside if e.correlation_id() in device]
    lost = len(inside) - len(found)
    prologue_lost = sum(1 for e in launches
                        if e.start_ns() < work.start_ns() and e.correlation_id() not in device)
    busy = None if lost else sum(e.duration_ns() for e in found) / 1e6
    return busy, len(found), lost, prologue_lost, True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
