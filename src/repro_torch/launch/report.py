"""The dry run's tables (§Dry-run, §Roofline) from a directory of cell
JSON files: the port's (:mod:`repro_torch.launch.dryrun`) or the
reference's, whose keys are the same (the port's copy of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report --results results/dryrun_torch

A ``not_ported`` cell shows its reason; a ``skip`` cell, the reference's
not-applicable long-context cells, shows as the reference shows it.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List

from ..configs import SHAPES, list_archs

GB = 2 ** 30


def load_cells(results_dir: str) -> List[Dict[str, Any]]:
    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def _fmt_bytes(b) -> str:
    return f"{b / GB:.2f}"


def _order(c: Dict[str, Any]):
    order = {a: i for i, a in enumerate(list_archs())}
    shapes = list(SHAPES)
    return (order.get(c["arch"], 99), shapes.index(c["shape"]) if c["shape"] in shapes else 99)


def _dash(n: int) -> str:
    return " | ".join(["–"] * n)


def dryrun_table(cells: List[Dict[str, Any]], mesh: str) -> str:
    rows = [
        "| arch | shape | status | peak GiB/dev | TPU-est GiB | HLO GFLOPs/dev | HBM GB/dev | coll GB/dev | collectives |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in sorted((c for c in cells if c.get("mesh") == mesh), key=_order):
        if c["status"] == "skip":
            rows.append(f"| {c['arch']} | {c['shape']} | SKIP (full-attn @500k) | {_dash(6)} |")
            continue
        if c["status"] == "not_ported":
            rows.append(f"| {c['arch']} | {c['shape']} | NOT PORTED ({c.get('reason', '')}) "
                        f"| {_dash(6)} |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ERROR | {_dash(6)} |")
            continue
        r = c["roofline"]
        m = c["memory"]
        est = m.get("tpu_estimate_bytes")
        colls = ", ".join(
            f"{k}×{v}" for k, v in sorted(r["collective_count"].items())
        ) or "none"
        rows.append(
            f"| {c['arch']} | {c['shape']} | ok | {_fmt_bytes(m['peak_per_device_bytes'])} "
            f"| {_fmt_bytes(est) if est else '–'} "
            f"| {r['flops_per_device'] / 1e9:.1f} | {r['memory_bytes_per_device'] / 1e9:.1f} "
            f"| {r['collective_bytes_per_device'] / 1e9:.2f} | {colls} |"
        )
    return "\n".join(rows)


def roofline_table(cells: List[Dict[str, Any]]) -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | MODEL_FLOPS | useful ratio | roofline frac | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in sorted((c for c in cells if c.get("mesh") == "16x16"), key=_order):
        if c["status"] == "skip":
            rows.append(f"| {c['arch']} | {c['shape']} | – | – | – | SKIP | – | – | – | "
                        f"full-attention arch at 500k decode |")
            continue
        if c["status"] == "not_ported":
            rows.append(f"| {c['arch']} | {c['shape']} | – | – | – | NOT PORTED | – | – | – | "
                        f"{c.get('reason', '')} |")
            continue
        if c["status"] != "ok":
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_term_s']:.4f} | {r['memory_term_s']:.4f} "
            f"| {r['collective_term_s']:.4f} | **{r['dominant']}** | {r['model_flops']:.3g} "
            f"| {r['model_flops_ratio']:.3f} | {r['roofline_fraction']:.4f} | {_bottleneck_hint(c)} |"
        )
    return "\n".join(rows)


def _bottleneck_hint(c: Dict[str, Any]) -> str:
    """What would move the dominant term, in the card's terms."""
    r = c["roofline"]
    dom = r["dominant"]
    kind = c.get("kind", "")
    if dom == "collective":
        big = max(r["by_collective"], key=r["by_collective"].get) if r["by_collective"] else "?"
        return f"cut {big} volume (sharding/overlap); biggest contributor {big}"
    if dom == "memory":
        if kind == "decode":
            return "decode is KV-cache-bandwidth bound; shrink cache dtype/window or raise batch"
        return ("keep attention's tiles in shared memory and registers (no HBM round trip "
                "of scores); fuse the elementwise passes around the matmuls")
    return "raise the tensor cores' utilization (larger tiles and batches, less recompute)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default="results/dryrun_torch")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cells = load_cells(args.results)
    parts = [
        "## §Dry-run — single-pod mesh 16x16 (256 devices)",
        "",
        dryrun_table(cells, "16x16"),
        "",
        "## §Dry-run — multi-pod mesh 2x16x16 (512 devices)",
        "",
        dryrun_table(cells, "2x16x16"),
        "",
        "## §Roofline — per (arch × shape), single-pod",
        "",
        roofline_table(cells),
    ]
    text = "\n".join(parts)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
