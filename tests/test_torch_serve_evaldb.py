"""The port's serve driver writes the reference's evaluation record.

The JAX driver (``repro.launch.serve``) and the port's (``--device cpu``)
on reduced glm4-9b with ``--evaldb``: the same ``[serve] engine=...``
knobs header, records equal in model, scenario, batch size, trace level,
agent and ``engine_knobs``, and the reference's ``EvalDB`` reads the port's
file.  With ``--fleet 2`` and a crash both write scenario ``serve-fleet2``
with the flags' recovery knobs, and the same request outcomes and counters.
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


FLEET = ["--engine", "paged", "--fleet", "2", "--recovery", "migrate", "--checkpoint-every", "2",
         "--fault-plan", "crash@1:3", "--max-new-tokens", "6", "--requests", "5"]


def test_fleet_record_matches_the_reference(tmp_path, capsys):
    """Both drivers' fleets of two: scenario ``serve-fleet2``, the knobs'
    recovery and checkpoint cadence from the flags, the same header, the
    same request outcomes and fleet counters."""
    ref_path, port_path = str(tmp_path / "ref.sqlite"), str(tmp_path / "port.sqlite")
    assert ref_serve.main(COMMON + FLEET + ["--evaldb", ref_path]) == 0
    ref_out = capsys.readouterr().out
    assert serve.main(COMMON + FLEET + ["--device", "cpu", "--evaldb", port_path]) == 0
    port_out = capsys.readouterr().out
    assert _header(port_out) == _header(ref_out)
    assert "recovery=migrate checkpoint_every=2" in _header(port_out)
    lines = lambda out, start: [l for l in out.splitlines() if l.startswith(start)]
    for start in ("[serve] fault plan:", "[serve] req "):
        assert lines(port_out, start) == lines(ref_out, start), start
    for title in ("[serve] fleet robustness:", "[serve] KV-migration recovery:"):
        assert title in port_out and title in ref_out
    want, got = _record(ref_path, RefEvalDB), _record(port_path, RefEvalDB)
    assert got.scenario == want.scenario == "serve-fleet2"
    assert got.metrics["engine_knobs"] == want.metrics["engine_knobs"]
    assert got.metrics["engine_knobs"]["recovery"] == "migrate"
    assert got.metrics["engine_knobs"]["checkpoint_every"] == 2
    for key in ("fleet_workers", "rounds", "completed", "failed", "rejected", "deaths",
                "requeued", "migrated", "migrated_tokens", "recomputed_prefill_tokens",
                "bytes_moved", "checkpoints_saved", "checksum_failures", "drains", "joins"):
        assert got.metrics[key] == want.metrics[key], key
    assert got.metrics["deaths"] == 1.0 and got.metrics["migrated"] > 0


@pytest.mark.parametrize("bad, message", [
    (["--fleet", "2", "--engine", "static"], "--fleet requires --engine paged"),
    (["--fleet", "2", "--drain-at", "1"], "bad --drain-at item"),
    (["--fleet", "2", "--fault-plan", "explode@0:1"], "bad fault-plan item"),
])
def test_fleet_flags_are_checked(bad, message, capsys):
    with pytest.raises(SystemExit):
        serve.main(COMMON + bad + ["--device", "cpu"])
    assert message in capsys.readouterr().err
