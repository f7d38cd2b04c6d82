"""The four serving examples' torch twins (``examples/*_torch.py``) run on
the CPU with ``--device cpu`` and print the reference examples' sections
and keys: quickstart's metric names and report, compare_models' columns
and four model rows, inspect_trace's three headings and a ``system:cost``
line with FLOPs above 0, serve_scenarios' six scenario lines and both
driver modes."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def _quickstart(out):
    assert out.startswith("evaluated on agent torch-")
    names = re.findall(r"^  (\w+)\s+-?[\d.]+$", out, re.M)
    assert names == sorted(["max_ms", "mean_queue_s", "min_ms", "num_requests", "p90_ms",
                            "trimmed_mean_ms"])
    assert "# MLModelScope report: glm4-9b" in out and "## Evaluations" in out


def _compare_models(out):
    lines = out.strip().splitlines()
    assert lines[0].split() == ["model", "online_tm_ms", "online_p90_ms", "max_tput_ips",
                                "opt_batch"]
    rows = [l.split()[0] for l in lines[2:]]
    assert sorted(rows) == sorted(["mamba2-130m", "zamba2-2.7b", "glm4-9b", "gemma2-27b"])


def _inspect_trace(out):
    for heading in ("== time per stack level ==", "== top-5 layers (Table 3 style) ==",
                    "== critical path (Figure 8 zoom-in) =="):
        assert heading in out
    flops = [float(x) for x in re.findall(r"^  flops=(\S+) bytes=", out, re.M)]
    assert flops and all(f > 0 for f in flops)
    assert re.search(r"^\s+layer_\d{3}_(mamba|shared_attn)\s+count=", out, re.M)


def _serve_scenarios(out):
    kinds = re.findall(r"^\[scenario:(\w+)\s*\] ", out, re.M)
    assert sorted(kinds) == ["batched", "offline", "online", "server", "single_stream", "trace"]
    for mode in ("static", "continuous"):
        assert f"--- serve driver mode={mode} ---" in out
        assert f"[serve] engine={mode}" in out


@pytest.mark.parametrize("name,check", [("quickstart", _quickstart),
                                        ("compare_models", _compare_models),
                                        ("inspect_trace", _inspect_trace),
                                        ("serve_scenarios", _serve_scenarios)],
                         ids=lambda x: x if isinstance(x, str) else "")
def test_torch_example_runs_on_the_cpu(name, check):
    check(_run(name))
