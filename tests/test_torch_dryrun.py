"""The port's production dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), and what it stands on:

* (a) every leaf's split of every dense and MoE arch's weights and cache,
  under the cells' rules (``rules_for``, ``SERVE_POLICY``'s FSDP, the
  ``kv_seq`` override) on both production meshes, equals the reference's
  ``PartitionSpec`` (over a ``jax.sharding.AbstractMesh``: no devices);
* (b) the reference's reduced glm4-9b and qwen3-moe prefill and decode
  lowered on a (data 2, model 2) mesh of forced host devices, in one
  subprocess: the port's ``argument_bytes`` equal XLA's
  ``memory_analysis()`` exactly, and its counted FLOPs, less attention
  and rmsnorm's elementwise FLOPs (which the HLO model does not count:
  1.4-1.8% at d_model 64), equal ``HloCostModel``'s exactly;
* (c) the counting world on meta tensors gives exactly the ledger, FLOPs,
  bytes, kernel counts and memory that two real gloo ranks give on the
  same reduced cells (one world started once for the module);
* (d) on those ranks, dense ``prefill`` + ``decode`` with heads split (tp
  2), with the cache's sequence split (``kv_seq``: 1 kv head at tp 2),
  with FSDP (``{"data": 2, "model": 1}``) and on ``E / tp`` experts give
  tp 1's greedy tokens, and prefill logits within 1e-5 + 1e-4 |x| of tp
  1's and of JAX's tp 1;
* (e) ``moe_decode_gather`` equals the reference's on a 1-device mesh in
  float32 and the port's default path at one token, and a reduced
  qwen3-moe decode gives the same tokens with it on or off;
* (f) ``main`` writes a full-width glm4-9b ``decode_32k`` cell on meta, the
  port's report renders it and the reference's ``dryrun_table`` reads it;
* (g) the predictor's repaired SYSTEM reading: no device time for a window
  whose work range or work record was lost.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices on import,
so (a) restores the environment after importing it and (b) runs in a
subprocess of its own.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.launch import report as jreport
from repro.models import build_model as jax_build_model
from repro.models import modules as jmodules
from repro.sharding import specs as jspecs
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import Ranks, make_production_mesh, mesh_name, run_jobs
from repro_torch.models import build_model, from_jax
from repro_torch.models import modules as tmodules
from repro_torch.sharding.specs import default_rules, leaf_splits, set_activation_rules

ROOT = Path(__file__).resolve().parents[1]
SERVE_ARCHS = ["glm4-9b", "gemma2-27b", "granite-20b", "chameleon-34b", "deepseek-67b",
               "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"]
MESHES = {"pod": False, "multipod": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process (the ranks take one each): the
    suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _import_reference_dryrun():
    """``repro.launch.dryrun``, with the ``XLA_FLAGS`` its first lines set
    restored, so that later JAX subprocesses of this worker do not inherit
    512 host devices."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


# ---------------------------------------------------------------------------
# (b) the reference's lowering, one subprocess started at once
# ---------------------------------------------------------------------------
B_GB, B_SEQ, B_CACHE = 4, 16, 32
B_ARCHS = ["glm4-9b", "qwen3-moe-30b-a3b"]

_LOWER = textwrap.dedent("""
    import json
    import jax
    from repro.configs import ShapeSpec, get_config
    from repro.launch import dryrun as jd
    from repro.launch.mesh import _make_mesh
    from repro.models import build_model
    from repro.models.params import param_specs
    from repro.roofline.hlo import HloCostModel
    from repro.sharding.specs import param_pspecs, set_activation_rules

    gb, seq, cache = {gb}, {seq}, {cache}
    mesh = _make_mesh((2, 2), ("data", "model"))
    out = {{}}
    for arch in {archs!r}:
        cfg = get_config(arch, reduced=True)
        for kind, S in (("prefill", seq), ("decode", cache)):
            shape = ShapeSpec("t", seq, gb, kind)
            rules = jd.rules_for(cfg, mesh, fsdp=False)
            model = build_model(cfg, backend="ref", compute_dtype="bfloat16")
            defs = model.param_defs()
            cdefs = model.cache_defs(gb, S, dtype="bfloat16")
            b_specs, b_ps = jd.batch_specs(cfg, shape, rules)
            if kind == "prefill":
                fn = lambda p, b, c: model.prefill(p, b, c)
            else:
                fn = lambda p, t, c: model.decode(p, t["tokens"], c)
            shard = (jd.named(mesh, param_pspecs(defs, rules)), jd.named(mesh, b_ps),
                     jd.named(mesh, param_pspecs(cdefs, rules)))
            # keep_unused: the prefill never reads the cache's pos, which jit
            # would drop from the arguments; the port's prefill holds it (and
            # writes it in place), as XLA's would with it kept
            with set_activation_rules(rules):
                compiled = jax.jit(fn, in_shardings=shard, out_shardings=(None, shard[2]),
                                   donate_argnums=(2,), keep_unused=True).lower(
                    param_specs(defs, dtype="bfloat16"), b_specs,
                    param_specs(cdefs)).compile()
            mem = compiled.memory_analysis()
            out[arch + ":" + kind] = {{
                "argument_bytes": int(mem.argument_size_in_bytes),
                "flops": HloCostModel(compiled.as_text()).entry_costs().flops}}
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_lowering():
    """The reference's reduced cells on a (2, 2) mesh: {arch:kind:
    {argument_bytes, flops}}; the subprocess starts at once and the world
    of (c)/(d) runs beside it."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    code = _LOWER.format(gb=B_GB, seq=B_SEQ, cache=B_CACHE, archs=B_ARCHS)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def lowered(reference_lowering, world):
    out, err = reference_lowering.communicate(timeout=300)
    assert reference_lowering.returncode == 0, err[-3000:]
    line = next(l for l in out.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


# ---------------------------------------------------------------------------
# (c), (d): one world of two ranks for the module
# ---------------------------------------------------------------------------
W_GB, W_SEQ, W_CACHE, W_STEPS = 4, 10, 16, 3
# (label, arch, tp, fsdp): heads split; the cache's sequence split (1 kv
# head on 2 ranks); FSDP over a data axis of 2; E / tp experts
WORLD = [("heads", "glm4-9b", 2, False), ("kv_seq", "granite-20b", 2, False),
         ("fsdp", "deepseek-67b", 1, True), ("moe", "qwen3-moe-30b-a3b", 2, False)]


def _jax_params(arch):
    jmodel = jax_build_model(jax_get_config(arch, reduced=True), backend="ref")
    params = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jax.tree.map(np.asarray, params)


def _checks():
    rng = np.random.default_rng(0)
    out = []
    for _, arch, tp, fsdp in WORLD:
        cfg = get_config(arch, reduced=True)
        tokens = rng.integers(0, cfg.vocab_size, (W_GB, W_SEQ)).astype(np.int32)
        out.append(dryrun.CellCheck(cfg, tokens, W_CACHE, W_STEPS, weights=_jax_params(arch)[1],
                                    tp=tp, fsdp=fsdp))
    return out


@pytest.fixture(scope="module")
def world(reference_lowering):
    checks = _checks()
    ranks = Ranks(run_jobs, 2, (checks,), device="cpu", timeout_s=300.0)
    results = ranks.result()
    return dict(zip([w[0] for w in WORLD], zip(checks, results)))


# ---------------------------------------------------------------------------
# (a) the splits against the reference's on the production meshes
# ---------------------------------------------------------------------------
def _pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) of two trees: the port's per-layer
    lists against the reference's stacked subtrees."""
    if isinstance(port, dict):
        for k, v in port.items():
            yield from _pairs(v, ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        for i, v in enumerate(port):
            yield from _pairs(v, ref, f"{path}/{i}")
    else:
        yield path, port, ref


def _norm(a):
    return tuple(a) if isinstance(a, (tuple, list)) else a


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_splits_equal_the_reference_on_the_production_meshes(arch, mesh_kind):
    jd = _import_reference_dryrun()
    assert dryrun.SERVE_POLICY == jd.SERVE_POLICY
    assert dryrun.TRAIN_POLICY == jd.TRAIN_POLICY and dryrun.DEFAULT_TRAIN == jd.DEFAULT_TRAIN
    multi = MESHES[mesh_kind]
    sizes = make_production_mesh(multi_pod=multi)
    jmesh = jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))
    assert mesh_name(sizes) == ("2x16x16" if multi else "16x16")
    fsdp = dryrun.SERVE_POLICY.get(arch, {}).get("fsdp", False)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rules = dryrun.rules_for(cfg, sizes, fsdp=fsdp)
    jrules = jd.rules_for(jcfg, jmesh, fsdp=fsdp)
    assert rules.rules == {k: _norm(v) for k, v in jrules.rules.items()}
    model, jmodel = build_model(cfg, device="meta"), jax_build_model(jcfg)
    trees = [(model.param_defs(), jmodel.param_defs())]
    for name in ("prefill_32k", "decode_32k"):
        shape = SHAPES[name]
        trees.append((model.cache_defs(shape.global_batch, shape.seq_len),
                      jmodel.cache_defs(shape.global_batch, shape.seq_len)))
    n = 0
    for tdefs, jdefs in trees:
        jspec = jspecs.param_pspecs(jdefs, jrules)
        for (path, p, jp), (_, _, spec) in zip(_pairs(tdefs, jdefs), _pairs(tdefs, jspec)):
            lead = len(jp.shape) - len(p.shape)
            assert tuple(jp.shape[lead:]) == tuple(p.shape), path
            want = [(i - lead, _norm(a)) for i, a in enumerate(tuple(spec)) if a is not None]
            assert all(i >= 0 for i, _ in want), path
            got = [(i, _norm(a)) for i, a in leaf_splits(rules, p, path)]
            assert got == want, path
            n += 1
    assert n > 0


# ---------------------------------------------------------------------------
# (b) memory and FLOPs against XLA's own analysis
# ---------------------------------------------------------------------------
def _attention_flops(cfg, kind, b, S):
    """The reference's plain-route attention dots on one device (half the
    heads): the full score square in a prefill, every cache slot in a
    decode step."""
    h, d = cfg.num_heads // 2, cfg.resolved_head_dim
    keys = B_SEQ * B_SEQ if kind == "prefill" else S
    return cfg.num_layers * 4 * b * h * keys * d


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", B_ARCHS)
def test_argument_bytes_and_flops_equal_xla_on_a_2x2_mesh(lowered, arch, kind):
    want = lowered[f"{arch}:{kind}"]
    cfg = get_config(arch, reduced=True)
    S = B_SEQ if kind == "prefill" else B_CACHE
    costs, _ = dryrun.count_cell(cfg, ShapeSpec("t", B_SEQ, B_GB, kind),
                                 {"data": 2, "model": 2}, dtype=torch.bfloat16, cache_len=S)
    assert costs.memory.argument_bytes == want["argument_bytes"]
    attn = sum(f for k, (_, f, _) in costs.by_kernel.items()
               if k in ("flash_attention", "decode_attention"))
    products = want["flops"] - _attention_flops(cfg, kind, B_GB // 2, S)
    # the rest is rmsnorm's 4 FLOPs an element (QK-norm's too), which the
    # HLO model (products only) does not count: 1.4-1.8% at these reduced
    # widths (d_model 64); less those, exactly equal
    assert costs.flops - attn - costs.by_kernel["rmsnorm"][1] == products


# ---------------------------------------------------------------------------
# (c) the counting world against a real one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", [w[0] for w in WORLD])
def test_counting_world_equals_a_real_gloo_world(world, label):
    check, res = world[label]
    sizes = {"data": 2 // check.tp, "model": check.tp}
    for rank in range(2):
        counted = dryrun.check_counts(check, sizes, rank=rank)
        assert len(counted) == len(res.costs[rank]) == 1 + W_STEPS
        for call, (real, cnt) in enumerate(zip(res.costs[rank], counted)):
            assert real == dryrun.costs_dict(cnt), (label, rank, call)
    ledger = res.costs[0][1]["ledger"]
    assert ledger and all(e["ring_factor"] == (1.0 if e["op"] == "all-reduce" else 0.5)
                          for e in ledger)


# ---------------------------------------------------------------------------
# (d) tokens and logits against tp 1 and JAX
# ---------------------------------------------------------------------------
def _jax_prefill_logits(arch, tokens):
    jmodel, params = _jax_params(arch)
    cache = jmodel.init_cache(tokens.shape[0], W_CACHE, dtype="float32")
    logits, _ = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)}, cache)
    return np.asarray(logits, dtype=np.float32)


@pytest.mark.parametrize("label", [w[0] for w in WORLD])
def test_sharded_prefill_and_decode_equal_tp1_and_jax(world, label):
    check, res = world[label]
    cfg = check.cfg
    model = build_model(cfg, device="cpu")
    params = from_jax(check.weights)
    tokens, logits, _, _ = dryrun.run_check(check, model, params, {"data": 1, "model": 1}, 0,
                                            torch.device("cpu"))
    assert np.array_equal(res.tokens, tokens)
    np.testing.assert_allclose(res.logits, logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.logits, _jax_prefill_logits(check.cfg.name.replace(
        "-reduced", ""), check.tokens), rtol=1e-4, atol=1e-5)


def test_kv_seq_gathers_the_cache_once_a_layer(world):
    """granite's one kv head on two ranks: the cache's sequence dim is
    split, and each decode step gathers each layer's K and V once."""
    check, res = world["kv_seq"]
    rules = dryrun.rules_for(check.cfg, {"data": 1, "model": 2}, fsdp=False)
    assert rules.rules["kv_seq"] == "model"
    gathers = [e for e in res.costs[0][1]["ledger"] if e["op"] == "all-gather"]
    assert len(gathers) == 2 * check.cfg.num_layers + 1          # K, V a layer; the logits
    cache = build_model(check.cfg, device="meta").init_cache(W_GB, W_CACHE, rules=rules)
    assert cache["k"].shape[2] == W_CACHE // 2


# ---------------------------------------------------------------------------
# (e) moe_decode_gather
# ---------------------------------------------------------------------------
def _moe_inputs(cfg, b):
    rng = np.random.default_rng(3)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.normal(0, 0.5, (D, E)), "w_gate": rng.normal(0, 0.1, (E, D, F)),
         "w_up": rng.normal(0, 0.1, (E, D, F)), "w_down": rng.normal(0, 0.1, (E, F, D))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.normal(0, 1, (b, 1, D)).astype(np.float32)


def _gather_rules(on=True):
    rules = default_rules({"data": 1, "model": 1})
    rules.opts["moe_decode_gather"] = on
    return rules


@pytest.mark.parametrize("b", [1, 8])
def test_moe_decode_gather_equals_the_reference_and_the_default_path(b):
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    p, x = _moe_inputs(cfg, b)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jrules = jspecs.default_rules(jmesh)
    jrules.opts["moe_decode_gather"] = True
    with jspecs.set_activation_rules(jrules):
        want, _ = jmodules.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                     jax_get_config("qwen3-moe-30b-a3b", reduced=True))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with set_activation_rules(_gather_rules()):
        got, _ = tmodules.moe_apply(tp, torch.from_numpy(x), cfg, need_aux=False)
    default, _ = tmodules.moe_apply(tp, torch.from_numpy(x), cfg, need_aux=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # one token a row: each expert of a row gets one slot, none is dropped
    np.testing.assert_allclose(got.numpy(), default.numpy(), rtol=1e-5, atol=1e-6)


def test_moe_decode_gather_keeps_the_tokens_of_a_decode():
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=1)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    check = dryrun.CellCheck(cfg, tokens, 16, 4)
    off = dryrun.run_check(check, model, params, {"data": 1, "model": 1}, 0, torch.device("cpu"))
    on_check = dryrun.CellCheck(cfg, tokens, 16, 4, opts={"moe_decode_gather": True})
    on = dryrun.run_check(on_check, model, params, {"data": 1, "model": 1}, 0,
                          torch.device("cpu"))
    assert np.array_equal(off[0], on[0])
    # the decode steps' expert products: K experts a row's weights, no buffer
    assert on[2][1]["flops"] < off[2][1]["flops"]


# ---------------------------------------------------------------------------
# (f) the CLI and the report
# ---------------------------------------------------------------------------
def test_main_writes_a_full_width_cell_the_reports_render(tmp_path, capsys):
    assert dryrun.main(["--arch", "glm4-9b", "--shape", "decode_32k", "--out", str(tmp_path),
                        "--force"]) == 0
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "glm4-9b", "--shape", "long_500k", "--out",
                        str(tmp_path)]) == 0
    cell = json.loads((tmp_path / "glm4-9b__decode_32k__pod.json").read_text())
    assert cell["status"] == "ok" and cell["mesh"] == "16x16"
    m = cell["memory"]
    assert m["peak_per_device_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                                          + m["temp_bytes"] - m["alias_bytes"])
    # the cache slice: 40 layers x K/V x 8 rows x 2048 slots x 2 kv heads x 128 x 2 bytes
    assert m["alias_bytes"] == 40 * 2 * 8 * 2048 * 2 * 128 * 2 + 8 * 4
    r = cell["roofline"]
    assert r["argument_bytes"] == m["argument_bytes"] and r["dominant"] == "collective"
    assert r["collective_count"] == {"all-gather": 81, "all-reduce": 81}
    ssm = json.loads((tmp_path / "mamba2-130m__decode_32k__pod.json").read_text())
    assert ssm["status"] == "not_ported" and "ROADMAP item 9c" in ssm["reason"]
    skip = json.loads((tmp_path / "glm4-9b__long_500k__pod.json").read_text())
    assert skip["status"] == "skip"
    cells = report.load_cells(str(tmp_path))
    text = report.dryrun_table(cells, "16x16")
    assert "| glm4-9b | decode_32k | ok | 2.06 |" in text
    assert "NOT PORTED (the ssm family's cells: ROADMAP item 9c)" in text
    assert "glm4-9b | decode_32k" in report.roofline_table(cells)
    assert report.main(["--results", str(tmp_path)]) == 0
    assert "## §Dry-run — multi-pod mesh 2x16x16" in capsys.readouterr().out
    jtext = jreport.dryrun_table([c for c in cells if c["status"] == "ok"], "16x16")
    assert "| glm4-9b | decode_32k | ok | 2.06 |" in jtext


def test_report_hints_are_in_the_cards_terms():
    cell = {"kind": "prefill", "roofline": {"dominant": "memory", "by_collective": {}}}
    hint = report._bottleneck_hint(cell)
    assert "shared memory" in hint and "VMEM" not in hint and "Pallas" not in hint


def test_dryrun_refuses_what_it_does_not_port():
    assert dryrun.lower_cell("glm4-9b", "train_4k", False)[1] == {
        "not_ported": "train cells: ROADMAP item 9c"}
    with pytest.raises(NotImplementedError, match="9c"):
        dryrun.rules_for(get_config("glm4-9b"), make_production_mesh(), fsdp=True, train=True)
    with pytest.raises(ValueError, match="not taken by the port"):
        dryrun.lower_cell("glm4-9b", "decode_32k", False, {"backend": "ref"})
    # the counting world takes meta tensors only
    from repro_torch.sharding import comm
    rules = dryrun.rules_for(get_config("glm4-9b"), {"data": 1, "model": 2}, fsdp=False)
    with comm.counting({"data": 1, "model": 2}), set_activation_rules(rules):
        with pytest.raises(comm.CollectiveError, match="meta tensors only"):
            comm.all_reduce(torch.zeros(4))


# ---------------------------------------------------------------------------
# (g) the predictor's SYSTEM reading
# ---------------------------------------------------------------------------
class _Event:
    def __init__(self, on_device, corr, name, dur=0, start=0, end=0):
        self.on_device, self.corr, self._name = on_device, corr, name
        self.dur, self.start, self.end = dur, start, end

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.on_device else DeviceType.CPU

    def correlation_id(self):
        return self.corr

    def name(self):
        return self._name

    def duration_ns(self):
        return self.dur

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


@pytest.mark.parametrize("case", ["range_missing", "record_lost", "whole"])
def test_a_window_that_lost_work_reads_no_device_time(case):
    from repro_torch.models.predictor import _device_records

    work = [_Event(False, 0, "system:work", start=10, end=20),
            _Event(False, 3, "cudaLaunchKernel", start=11), _Event(True, 3, "k", 2_000_000),
            _Event(False, 4, "cudaLaunchKernel", start=12), _Event(True, 4, "k", 1_000_000)]
    if case == "range_missing":
        events, want = work[1:], (None, 0, 0, 0, False)
    elif case == "record_lost":
        events, want = work[:-1], (None, 1, 1, 0, True)
    else:
        events, want = work, (3.0, 2, 0, 0, True)
    assert _device_records(events) == want
