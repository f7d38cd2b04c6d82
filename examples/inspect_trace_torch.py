"""Model-execution inspection on the PyTorch port (the paper's Figure-8
"zoom-in" case study).  The torch twin of ``examples/inspect_trace.py``:
the same model, scenario and sections over the port's platform, on the
card unless ``--device cpu`` asks for the plain PyTorch path.

Runs a FRAMEWORK+SYSTEM traced evaluation, then walks the aggregated
timeline: per-level time, the top-5 layers (Table 3), and the critical
path from the evaluation span down to the hottest layer.  At SYSTEM level
each predict carries a ``system:cost`` event (the FLOPs and bytes that the
port's roofline counter counts, and their roofline terms on an H100) where
the reference has XLA's cost analysis, and on the card a ``system:cuda``
event (the device's busy ms by torch.profiler, kernel launches, peak
memory).

    PYTHONPATH=src python examples/inspect_trace_torch.py --device cpu
"""
import argparse

from repro_torch.core import EvaluationRequest, ScenarioSpec, Span
from repro_torch.core.analysis import critical_path, level_breakdown, top_layers
from repro_torch.core.platform import LocalPlatform

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cpu, or the card when left out")
args = ap.parse_args()

platform = LocalPlatform(backends=("torch",), device=args.device)
try:
    (result,) = platform.evaluate(
        EvaluationRequest(
            model="zamba2-2.7b",           # hybrid: mamba + shared-attention layers
            backend="torch",
            scenario=ScenarioSpec(kind="online", num_requests=2, rate_hz=1000.0, warmup=1),
            trace_level="FULL",
            seq_len=32,
        )
    )
    spans = [Span.from_dict(d) for d in platform.evaldb.spans(result["eval_id"])]
    print(f"{len(spans)} spans in the aggregated timeline\n")

    print("== time per stack level ==")
    for level, seconds in sorted(level_breakdown(spans).items()):
        print(f"  {level:12s} {seconds * 1e3:9.2f} ms")

    print("\n== top-5 layers (Table 3 style) ==")
    for stat in top_layers(spans, k=5):
        print(f"  {stat.name:28s} count={stat.count:3d} total={stat.total_s*1e3:8.2f} ms")

    print("\n== critical path (Figure 8 zoom-in) ==")
    for depth, span in enumerate(critical_path(spans)):
        print(f"  {'  ' * depth}{span.name}  ({span.duration * 1e3:.2f} ms)")

    print("\n== SYSTEM-level events (the roofline counter's costs; torch.profiler on the card) ==")
    for s in spans:
        if s.name == "system:cost":
            print(f"  flops={s.tags.get('flops', 0):.3g} bytes={s.tags.get('bytes_accessed', 0):.3g}"
                  f" bound={s.tags.get('step_time_bound_s', 0) * 1e3:.3g} ms"
                  f" ({s.tags.get('dominant', '')})")
        elif s.name == "system:cuda":
            # None: the window's work range was not found or it lost records
            ms = s.tags.get("device_ms")
            print(f"  device_ms={'None' if ms is None else f'{ms:.3f}'} "
                  f"lost_records={s.tags.get('lost_records', 0)} "
                  f"work_range_found={s.tags.get('work_range_found', True)} "
                  f"launches={s.tags.get('launches', {})} "
                  f"max_memory_allocated={s.tags.get('max_memory_allocated', 0)}")
finally:
    platform.shutdown()
