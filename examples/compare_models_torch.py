"""Model comparison on the PyTorch port (the paper's Table-2 use case).  The
torch twin of ``examples/compare_models.py``: the same models, scenarios
and table over the port's platform, on the card unless ``--device cpu``
asks for the plain PyTorch path.

Evaluates several zoo models under the same scenarios and renders the
accuracy/latency/throughput-style comparison table from the evaluation
database — the "which model should I deploy?" workflow.

    PYTHONPATH=src python examples/compare_models_torch.py --device cpu
"""
import argparse

from repro_torch.core import EvaluationRequest, ScenarioSpec
from repro_torch.core.analysis import comparison_table
from repro_torch.core.platform import LocalPlatform

MODELS = ["mamba2-130m", "zamba2-2.7b", "glm4-9b", "gemma2-27b"]

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cpu, or the card when left out")
args = ap.parse_args()

platform = LocalPlatform(backends=("torch",), device=args.device)
try:
    rows = []
    for model in MODELS:
        online = platform.evaluate(
            EvaluationRequest(
                model=model, backend="torch",
                scenario=ScenarioSpec(kind="online", num_requests=4, rate_hz=1000.0, warmup=1),
                trace_level="NONE", seq_len=32,
            )
        )[0]["metrics"]
        batched = platform.evaluate(
            EvaluationRequest(
                model=model, backend="torch",
                scenario=ScenarioSpec(kind="batched", num_requests=2, batch_sizes=[1, 4], warmup=1),
                trace_level="NONE", seq_len=32,
            )
        )[0]["metrics"]
        rows.append(
            {
                "model": model,
                "online_tm_ms": online["trimmed_mean_ms"],
                "online_p90_ms": online["p90_ms"],
                "max_tput_ips": batched["max_throughput_ips"],
                "opt_batch": batched["optimal_batch_size"],
            }
        )
    print(
        comparison_table(
            rows,
            ["model", "online_tm_ms", "online_p90_ms", "max_tput_ips", "opt_batch"],
            sort_by="max_tput_ips",
        )
    )
finally:
    platform.shutdown()
