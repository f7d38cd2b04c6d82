"""The port's serve driver writes the reference's evaluation record.

The JAX driver (``repro.launch.serve``) and the port's (``--device cpu``)
on reduced glm4-9b with ``--evaldb``: the same ``[serve] engine=...``
knobs header, records equal in model, scenario, batch size, trace level,
agent and ``engine_knobs``, and the reference's ``EvalDB`` reads the port's
file.
"""
import pytest

from repro.core.evaldb import EvalDB as RefEvalDB
from repro.launch import serve as ref_serve
from repro_torch.core.evaldb import EvalDB
from repro_torch.launch import serve

COMMON = ["--requests", "3", "--prompt-len", "8", "--max-new-tokens", "3",
          "--engine-batch", "2", "--max-seq", "32", "--rate-hz", "500"]
CASES = {
    "paged": ["--engine", "paged"],
    "static": ["--engine", "static"],
    "continuous": ["--engine", "continuous"],
    # a MoE summary holds one string entry (the reference's EvalDB stores
    # metrics as JSON)
    "static-moe": ["--engine", "static", "--arch", "qwen3-moe-30b-a3b"],
    "paged-int8-spec": ["--engine", "paged", "--kv-dtype", "int8", "--spec-k", "2",
                        "--prefix-cache", "off", "--page-size", "8"],
}


def _header(out: str) -> str:
    (line,) = [l for l in out.splitlines() if l.startswith("[serve] engine=")]
    return line


def _record(path: str, db_cls):
    db = db_cls(path)
    try:
        (rec,) = db.query()
        return rec
    finally:
        db.close()


@pytest.mark.parametrize("case", list(CASES))
def test_driver_record_matches_the_reference(case, tmp_path, capsys):
    ref_path, port_path = str(tmp_path / "ref.sqlite"), str(tmp_path / "port.sqlite")
    assert ref_serve.main(COMMON + CASES[case] + ["--evaldb", ref_path]) == 0
    ref_out = capsys.readouterr().out
    assert serve.main(COMMON + CASES[case] + ["--device", "cpu", "--evaldb", port_path]) == 0
    port_out = capsys.readouterr().out
    assert _header(port_out) == _header(ref_out)
    want = _record(ref_path, RefEvalDB)
    got = _record(port_path, RefEvalDB)            # the reference reads the port's file
    for field in ("model", "model_version", "backend_version", "system", "scenario",
                  "batch_size", "trace_level", "agent_id"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.metrics["engine_knobs"] == want.metrics["engine_knobs"]
    assert got.backend == "torch" and want.backend == "flash"
    assert got.scenario == f"serve-{CASES[case][1]}"
    # the port's own EvalDB reads it too, the summary beside the knobs
    own = _record(port_path, EvalDB)
    assert own.metrics == got.metrics and own.metrics["ttft_p50_ms"] > 0
    if "--arch" in CASES[case]:
        assert own.metrics["moe"].startswith("moe: ")


def test_driver_writes_no_record_without_evaldb(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert serve.main(COMMON + ["--engine", "static", "--device", "cpu"]) == 0
    assert _header(capsys.readouterr().out) == (
        "[serve] engine=static kv_dtype=float32 page_size=0 spec_k=0 prefix_cache=off tp=1")
    assert list(tmp_path.iterdir()) == []
