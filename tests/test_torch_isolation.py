"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the example
twins (``examples/*_torch.py``) import neither ``jax`` nor anything of
``repro``.

The import check runs in a subprocess, because other test files in the same
worker import JAX.  A second test scans the sources for such imports.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_the_import_check_covers_every_entry_point():
    """The module list walks the package: the models, the drivers, the
    out-of-process agent, the fleet, the training path, the sharding rules,
    the collectives, the rank launcher and the dry run and its report are
    all imported by the check below."""
    mods = _modules()
    for m in ("repro_torch.models.resnet", "repro_torch.models.predictor",
              "repro_torch.launch.serve", "repro_torch.launch.agent_main",
              "repro_torch.core.client", "repro_torch.core.platform",
              "repro_torch.serve.faults", "repro_torch.serve.fleet",
              "repro_torch.train", "repro_torch.train.data", "repro_torch.train.optimizer",
              "repro_torch.train.checkpoint", "repro_torch.train.step",
              "repro_torch.launch.train", "repro_torch.kernels.flash_attention_bwd",
              "repro_torch.kernels.rmsnorm_bwd", "repro_torch.kernels.ssd_bwd",
              "repro_torch.roofline", "repro_torch.roofline.count",
              "repro_torch.roofline.work", "repro_torch.roofline.model",
              "repro_torch.sharding", "repro_torch.sharding.specs",
              "repro_torch.sharding.comm", "repro_torch.launch.mesh",
              "repro_torch.serve.tp", "repro_torch.launch.dryrun",
              "repro_torch.launch.report"):
        assert m in mods, m


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)(\.|\s))", re.M
)


def test_port_sources_do_not_import_jax_or_repro():
    twins = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {f.name for f in twins} >= {"quickstart_torch.py", "compare_models_torch.py",
                                       "inspect_trace_torch.py", "serve_scenarios_torch.py",
                                       "train_lm_torch.py"}
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + twins
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders
