"""Command-line client (paper F10, §4.2).

The CLI mirrors the paper's command-line interface: users specify the model,
backend ("framework"), benchmarking scenario, and trace level; results go to
the evaluation database and a human-readable report is printed. Usable in
shell scripts for combinational evaluations.

The port's copy of ``repro.core.client``: the same flags, with the
``torch`` backend by default, plus ``--device`` (``cuda`` unless given) and
``--full`` (the models at published width and depth; reduced otherwise).
It keeps its own copy so that it never imports ``repro``.

Examples::

    python -m repro_torch.core.client evaluate --model glm4-9b --scenario online \
        --num-requests 16 --rate-hz 20 --trace-level MODEL --full
    python -m repro_torch.core.client evaluate --device cpu --model mamba2-130m \
        --scenario server --num-requests 6 --rate-hz 50 --seq-len 16 --warmup 1
    python -m repro_torch.core.client list-models
    python -m repro_torch.core.client report --model glm4-9b
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .agent import EvaluationRequest
from .platform import LocalPlatform
from .scenarios import ScenarioSpec


def _parse_int_list(text: str) -> List[int]:
    return [int(x) for x in text.split(",") if x]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mlms", description="MLModelScope client (PyTorch port)")
    p.add_argument("--evaldb", default=":memory:", help="evaluation database path")
    p.add_argument(
        "--backends", default="torch", help="comma-separated agent backends to start"
    )
    sub = p.add_subparsers(dest="command", required=True)

    ev = sub.add_parser("evaluate", help="run a model evaluation")
    ev.add_argument("--model", required=True)
    ev.add_argument("--model-version", default="")
    ev.add_argument("--backend", default="torch")
    ev.add_argument(
        "--scenario",
        default="online",
        choices=["online", "batched", "trace", "single_stream", "server", "offline"],
    )
    ev.add_argument("--num-requests", type=int, default=8)
    ev.add_argument("--rate-hz", type=float, default=50.0)
    ev.add_argument("--batch-size", type=int, default=1)
    ev.add_argument("--batch-sizes", type=_parse_int_list, default=None)
    ev.add_argument("--seq-len", type=int, default=64)
    ev.add_argument("--warmup", type=int, default=2)
    ev.add_argument("--slo-ms", type=float, default=100.0, help="server scenario SLO")
    ev.add_argument(
        "--sched-max-batch", type=int, default=0,
        help="run through the scheduler-backed executor coalescing up to N requests",
    )
    ev.add_argument("--sched-timeout-ms", type=float, default=2.0)
    ev.add_argument("--sched-queue-depth", type=int, default=1024)
    ev.add_argument(
        "--trace-level", default="MODEL", choices=["NONE", "MODEL", "FRAMEWORK", "SYSTEM", "FULL"]
    )
    ev.add_argument("--all-agents", action="store_true", help="fan out to all capable agents")
    ev.add_argument("--json", action="store_true", help="print raw JSON metrics")

    lm = sub.add_parser("list-models", help="list registered model manifests")
    la = sub.add_parser("list-agents", help="list running agents")

    rp = sub.add_parser("report", help="analysis report over past evaluations")
    for cmd in (ev, lm, la, rp):
        cmd.add_argument("--device", default="cuda",
                         help="the agents' device (cuda unless given; cpu runs the plain path)")
        cmd.add_argument("--full", action="store_true",
                         help="models at published width and depth (reduced otherwise)")
    rp.add_argument("--model", default="")
    rp.add_argument("--backend", default="")
    rp.add_argument("--scenario", default="")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    platform = LocalPlatform(
        backends=args.backends.split(","), evaldb_path=args.evaldb,
        reduced_models=not args.full, device=args.device,
    )
    try:
        if args.command == "list-models":
            for m in platform.registry.manifests():
                print(f"{m.key:40s} {m.description}")
            return 0
        if args.command == "list-agents":
            for a in platform.registry.agents():
                print(f"{a.agent_id:24s} backend={a.backend:8s} models={len(a.models)}")
            return 0
        if args.command == "report":
            print(
                platform.report(
                    model=args.model, backend=args.backend, scenario=args.scenario
                )
            )
            return 0
        # evaluate
        spec = ScenarioSpec(
            kind=args.scenario,
            num_requests=args.num_requests,
            batch_size=args.batch_size,
            rate_hz=args.rate_hz,
            warmup=args.warmup,
            batch_sizes=args.batch_sizes,
            slo_ms=args.slo_ms,
        )
        scheduler = None
        if args.sched_max_batch > 0:
            from ..serve.scheduler import SchedulerConfig

            scheduler = SchedulerConfig(
                max_batch=args.sched_max_batch,
                batch_timeout_ms=args.sched_timeout_ms,
                queue_depth=args.sched_queue_depth,
            )
        req = EvaluationRequest(
            model=args.model,
            model_version=args.model_version,
            backend=args.backend,
            scenario=spec,
            trace_level=args.trace_level,
            batch_size=args.batch_size,
            seq_len=args.seq_len,
            scheduler=scheduler,
        )
        from .server import DispatchPolicy

        results = platform.evaluate(
            req, policy=DispatchPolicy(all_agents=args.all_agents)
        )
        for res in results:
            if args.json:
                print(json.dumps(res, indent=2, default=str))
            else:
                print(f"agent={res['agent_id']} model={res['model']}")
                for k, v in sorted(res["metrics"].items()):
                    if isinstance(v, float):
                        print(f"  {k:24s} {v:.4f}")
                    elif not isinstance(v, dict):
                        print(f"  {k:24s} {v}")
        print()
        print(platform.report(model=args.model))
        return 0
    finally:
        platform.shutdown()


if __name__ == "__main__":
    sys.exit(main())
