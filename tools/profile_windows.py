"""The SYSTEM-level predictor's profiler windows on the card, before and
after other work in the same process.

    python3 tools/profile_windows.py [--evaluations N]
        [--between phase7|ranks|serve|cuda-ranks|cpu-ranks|cuda-procs|none]
        [--out PATH]

Runs N evaluations (default 40) of ResNet-50 batched at SYSTEM level, the
evaluation that ends ``chip_smoke.py``'s phase 6 (batches 1, 8 and 32,
four predicts each after one warm-up: 15 profiler windows each); then,
by ``--between``: ``chip_smoke.py``'s phase 7 (two ranks on the card,
spawned from this process, after its tp-1 runs here; its bf16 limits are
off, since E is phase 4's and is not measured here, and its float32
checks bind); ``ranks``, phase 7's first world alone (glm4-9b at full
width on two ranks serving the mix, nothing served here); ``serve``,
phase 7's first tp-1 run alone (the same serve in this process, no
ranks); ``cuda-ranks``, two spawned ranks of a gloo world on the card
that only all-reduce a small tensor; ``cpu-ranks``, the same on the CPU;
``cuda-procs``, two plain subprocesses that each touch the card; or
nothing; then the same N evaluations again.

For each window it keeps the predictor's ``system:cuda`` figures (device
ms, device records, lost records, the prologue's losses) and, read from
the same profile, whether the work's range was found, the launches
inside it, the device records in the whole profile, and the least and
most device start minus host launch time (ms) over the work's matched
launches.  Prints one summary line for each half and writes every window
to ``--out`` (default ``build/profile_windows_<between>.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def _probe(predictor):
    """Wrap ``predictor._device_records`` so that each window's raw
    figures are kept beside the predictor's own (in call order)."""
    from torch.autograd import DeviceType

    real = predictor._device_records
    seen = []

    def wrapped(events):
        events = list(events)
        device, host = {}, []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                device[e.correlation_id()] = e
            else:
                host.append(e)
        work = next((e for e in host if e.name() == predictor._WORK), None)
        inside = [] if work is None else [
            e for e in host if predictor._LAUNCH.match(e.name())
            and work.start_ns() <= e.start_ns() <= work.end_ns()]
        lag = [(device[e.correlation_id()].start_ns() - e.start_ns()) / 1e6
               for e in inside if e.correlation_id() in device]
        seen.append({"work_found": work is not None, "launches_inside": len(inside),
                     "device_records_all": len(device),
                     "lag_ms": [min(lag), max(lag)] if lag else None})
        return real(events)

    predictor._device_records = wrapped
    return seen


def _evaluations(torch, platform, n, seen):
    """N batched SYSTEM evaluations of ResNet-50: one dict a window."""
    from repro_torch.core import EvaluationRequest, ScenarioSpec

    rows = []
    for _ in range(n):
        req = EvaluationRequest(
            model=chip_smoke.RESNET,
            scenario=ScenarioSpec(seed=chip_smoke.SEED, kind="batched", num_requests=4,
                                  batch_sizes=chip_smoke.RESNET_BATCHES, warmup=1),
            trace_level="SYSTEM", seq_len=chip_smoke.PLATFORM_SEQ)
        del seen[:]
        res = platform.evaluate(req)[0]
        spans = platform.evaldb.spans(res["eval_id"])
        events = [s["tags"] for s in spans if s["name"] == "system:cuda"]
        batches = [s["tags"].get("batch", 1) for s in spans if s["name"] == "inference"]
        # one window a predict, the warm-ups' included, in order
        if len(seen) != len(events):
            raise SystemExit(f"{len(seen)} profiles for {len(events)} system:cuda events")
        for b, e, r in zip(batches, events, seen):
            rows.append({"batch": b, "device_ms": e["device_ms"],
                         "device_records": e["device_records"],
                         "lost_records": e["lost_records"],
                         "prologue_lost": e["prologue_lost"], **r})
    return rows


def _summary(label, rows):
    zero = [r for r in rows if not r["device_ms"]]
    lost = [r for r in rows if r["lost_records"]]
    lags = [r["lag_ms"] for r in rows if r["lag_ms"]]
    losses = {}
    for r in rows:
        losses[r["prologue_lost"]] = losses.get(r["prologue_lost"], 0) + 1
    print(f"{label}: {len(rows)} windows, {len(zero)} read no device ms (0.0 or None), {len(lost)} lost "
          f"records; prologue losses (lost: windows) {dict(sorted(losses.items()))}; device "
          f"start - host launch {min(l[0] for l in lags):.3f} to {max(l[1] for l in lags):.3f} "
          f"ms" if lags else f"{label}: {len(rows)} windows, none with a matched launch")
    for r in zero + [r for r in lost if r not in zero]:
        print(f"   {r}")


def _touch(rank, device):
    """A rank that all-reduces one small tensor on its device."""
    import torch
    import torch.distributed as dist

    x = torch.ones(1024, device=device)
    dist.all_reduce(x)
    return float(x[0])


def _between(torch, dev, what):
    """The work between the two halves (see the module)."""
    if what == "phase7":
        chip_smoke.tp_serve_phase(torch, dev, float("inf"))
        return
    if what == "none":
        return
    if what in ("cuda-ranks", "cpu-ranks"):
        from repro_torch.launch.mesh import run_ranks

        run_ranks(_touch, chip_smoke.TP, device=dev if what == "cuda-ranks" else "cpu")
        return
    if what == "cuda-procs":
        code = "import torch; torch.ones(1024, device='cuda').sum().item()"
        procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(chip_smoke.TP)]
        if any(p.wait(timeout=300) for p in procs):
            raise SystemExit("a subprocess on the card failed")
        return
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.tp import ServeJob, TPRun, serve_tp

    cs = chip_smoke
    cfg = get_config("glm4-9b")
    reqs = make_requests(cs.REQUESTS, cs.PROMPT_MIN, cs.PROMPT_MAX, cs.NEW_TOKENS,
                         cfg.vocab_size, cs.SEED)
    eng = dict(max_batch=cs.SLOTS, max_seq=cs.MAX_SEQ, page_size=cs.PAGE)
    kw = dict(num_slots=cs.SLOTS, page_size=cs.PAGE, prefill_budget=cs.BUDGET)
    if what == "ranks":
        serve_tp([ServeJob(cfg, cs.SEED, [TPRun(reqs, engine=eng, serve=kw)], torch.bfloat16)], cs.TP,
                 device=dev, timeout_s=600.0)
        return
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    params = model.init(seed=cs.SEED)
    ServingEngine(model, params, device=dev, **eng).serve_paged(reqs, **kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--evaluations", type=int, default=40)
    ap.add_argument("--between", choices=("phase7", "ranks", "serve", "cuda-ranks",
                                          "cpu-ranks", "cuda-procs", "none"),
                    default="phase7")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_windows: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    from repro_torch.core.platform import LocalPlatform
    from repro_torch.kernels import _build
    from repro_torch.models import predictor

    _build.build_info()
    seen = _probe(predictor)
    out = {}
    platform = LocalPlatform(backends=("torch",), reduced_models=False)
    try:
        t0 = time.perf_counter()
        out["before"] = _evaluations(torch, platform, args.evaluations, seen)
        _summary(f"before ({time.perf_counter() - t0:.1f} s)", out["before"])
        t0 = time.perf_counter()
        _between(torch, dev, args.between)
        print(f"{args.between}: {time.perf_counter() - t0:.1f} s")
        chip_smoke._release(torch)
        t0 = time.perf_counter()
        out["after"] = _evaluations(torch, platform, args.evaluations, seen)
        _summary(f"after ({time.perf_counter() - t0:.1f} s)", out["after"])
    finally:
        platform.shutdown()
    path = args.out or ROOT / "build" / f"profile_windows_{args.between}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
