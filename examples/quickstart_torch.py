"""Quickstart on the PyTorch port: evaluate a model through the platform in
~20 lines.  The torch twin of ``examples/quickstart.py``: the same model,
scenario and report over the port's platform, on the card unless
``--device cpu`` asks for the plain PyTorch path.

The paper's evaluation workflow end to end: start a local MLModelScope
instance (registry + server + agent + middleware), submit an online
benchmarking scenario for a built-in model, and print the automated report.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core import EvaluationRequest, ScenarioSpec
from repro_torch.core.platform import LocalPlatform

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cpu, or the card when left out")
args = ap.parse_args()

platform = LocalPlatform(backends=("torch",), device=args.device)
try:
    request = EvaluationRequest(
        model="glm4-9b",                 # any of the 10 assigned archs (+resnet50)
        backend="torch",
        scenario=ScenarioSpec(kind="online", num_requests=5, rate_hz=100.0, warmup=2),
        trace_level="MODEL",
        seq_len=32,
    )
    (result,) = platform.evaluate(request)
    print(f"evaluated on agent {result['agent_id']}")
    for key, value in sorted(result["metrics"].items()):
        if isinstance(value, (int, float)):
            print(f"  {key:24s} {value:.3f}")
    print()
    print(platform.report(model="glm4-9b"))
finally:
    platform.shutdown()
