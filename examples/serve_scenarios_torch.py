"""End-to-end serving driver example on the PyTorch port.  The torch twin of
``examples/serve_scenarios.py``: the same model, scenarios and driver runs
over the port's engine and driver, on the card unless ``--device cpu``
asks for the plain PyTorch path.

Part 1 sweeps all six benchmarking scenario kinds (online / batched / trace
/ single_stream / server / offline) over an engine-backed predict function
through `run_scenario` — every kind flows scenario -> RequestScheduler ->
ServingEngine -> tracer.  Part 2 runs the serving driver in both executor
modes (static micro-batching and slot-based continuous batching).

    PYTHONPATH=src python examples/serve_scenarios_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.scenarios import ScenarioSpec, run_scenario, scenario_kinds
from repro_torch.core.tracing import Tracer, TracingServer
from repro_torch.launch.serve import main
from repro_torch.models import build_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.scheduler import SchedulerConfig

ARCH = "glm4-9b"
PROMPT_LEN = 8

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cpu, or the card when left out")
args = ap.parse_args()

# -- part 1: the six scenario kinds over one engine-backed predict fn --------
cfg = get_config(ARCH, reduced=True)
model = build_model(cfg, device=args.device)
params = model.init(0)
engine = ServingEngine(model, params, max_batch=8, max_seq=32, device=args.device)
rng = np.random.default_rng(0)


def predict(batch_size: int) -> None:
    prompts = [
        rng.integers(0, cfg.vocab_size, (PROMPT_LEN,)).astype(np.int32)
        for _ in range(batch_size)
    ]
    engine.generate(prompts, max_new_tokens=2)


server = TracingServer()
specs = {
    "online": ScenarioSpec(kind="online", num_requests=4, rate_hz=50.0, warmup=1),
    "batched": ScenarioSpec(kind="batched", num_requests=3, batch_sizes=[1, 4], warmup=1),
    "trace": ScenarioSpec(kind="trace", num_requests=3, arrivals=[0.0, 0.05, 0.1], warmup=0),
    "single_stream": ScenarioSpec(kind="single_stream", num_requests=4, warmup=1),
    "server": ScenarioSpec(kind="server", num_requests=6, rate_hz=40.0, warmup=1, slo_ms=250.0),
    "offline": ScenarioSpec(kind="offline", num_requests=8, warmup=1),
}
assert sorted(specs) == scenario_kinds()
for kind, spec in specs.items():
    tracer = Tracer(f"demo-{kind}", server)
    m = run_scenario(
        spec, predict, tracer,
        scheduler=SchedulerConfig(max_batch=4, batch_timeout_ms=5.0)
        if kind in ("server", "offline") else None,
    )
    keys = [
        k for k in (
            "trimmed_mean_ms", "p90_ms", "p99_ms", "max_throughput_ips",
            "throughput_ips", "achieved_qps", "slo_attainment",
            "sched_mean_batch_occupancy",
        ) if k in m
    ]
    print(f"[scenario:{kind:13s}] " + "  ".join(f"{k}={m[k]:.2f}" for k in keys))

# -- part 2: the serving driver, both executor modes -------------------------
device = ["--device", args.device] if args.device else []
for mode in ("static", "continuous"):
    print(f"\n--- serve driver mode={mode} ---")
    rc = main([
        "--arch", ARCH,
        "--mode", mode,
        "--requests", "8",
        "--rate-hz", "50",
        "--engine-batch", "4",
        "--prompt-len", "12",
        "--max-new-tokens", "6",
        "--max-seq", "32",
        *device,
    ])
    assert rc == 0
raise SystemExit(0)
