"""The port's copies of the platform's pure-Python core (tracing, manifest,
registry, evaldb, pipeline, workload, analysis) against ``repro.core``.

The behavioural tests of ``tests/test_tracing.py``, ``test_manifest.py``,
``test_registry.py``, ``test_pipeline.py`` and ``test_analysis.py`` run as
cases on both packages (ids ``repro`` and ``repro_torch``); the parity
tests feed both the same inputs and compare the outputs exactly (the
modules are pure Python and numpy, so the tolerance is zero: ``==``).
"""
import importlib
import json
import math
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

MODULES = ("tracing", "manifest", "registry", "evaldb", "pipeline", "workload", "analysis")
PKGS = ("repro", "repro_torch")


def _core(pkg):
    return SimpleNamespace(pkg=pkg, **{m: importlib.import_module(f"{pkg}.core.{m}")
                                       for m in MODULES})


REF, PORT = _core("repro"), _core("repro_torch")
both = pytest.mark.parametrize("core", [REF, PORT], ids=PKGS)


class FakeClock:
    """Advances one unit a reading (tracing) or holds ``t`` (registry)."""

    def __init__(self, step=0.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# tracing (mirrors tests/test_tracing.py)
# ---------------------------------------------------------------------------
@both
def test_span_nesting_and_timeline(core):
    tr_ = core.tracing
    server = tr_.TracingServer()
    tr = tr_.Tracer("t1", server, tr_.TraceLevel.FULL, clock=FakeClock(1.0))
    with tr.span("outer", tr_.TraceLevel.MODEL):
        with tr.span("inner", tr_.TraceLevel.FRAMEWORK):
            pass
    tl = server.timeline("t1")
    assert [s.name for s in tl] == ["outer", "inner"]
    assert tl[1].parent_id == tl[0].span_id
    assert tl[0].duration >= tl[1].duration > 0


@both
@pytest.mark.parametrize("level,want", [
    ("NONE", []),
    ("MODEL", ["model"]),
    ("FRAMEWORK", ["model", "framework"]),
    ("SYSTEM", ["model", "framework", "system"]),
    ("FULL", ["model", "framework", "system"]),
])
def test_trace_levels_filter(core, level, want):
    tr_ = core.tracing
    server = tr_.TracingServer()
    tr = tr_.Tracer("t1", server, tr_.TraceLevel.parse(level), clock=FakeClock(1.0))
    with tr.span("model", tr_.TraceLevel.MODEL):
        with tr.span("framework", tr_.TraceLevel.FRAMEWORK):
            with tr.span("system", tr_.TraceLevel.SYSTEM):
                pass
    assert [s.name for s in server.timeline("t1")] == want
    with tr_.NullTracer().span("y"):
        pass


@both
def test_out_of_order_publish_and_event_summary(core):
    tr_ = core.tracing
    server = tr_.TracingServer()
    server.publish(tr_.Span("late", tr_.TraceLevel.MODEL, "t", begin=5.0, end=6.0))
    server.publish(tr_.Span("early", tr_.TraceLevel.MODEL, "t", begin=1.0, end=2.0))
    assert [s.name for s in server.timeline("t")] == ["early", "late"]
    tr = tr_.Tracer("e", server, tr_.TraceLevel.FULL)
    tr.event("ext", 0.0, 2.5, tr_.TraceLevel.SYSTEM, flops=100)
    tr.event("ext", 3.0, 4.0, tr_.TraceLevel.SYSTEM)
    agg = tr_.summarize(server.timeline("e"))
    assert agg["ext"]["count"] == 2 and agg["ext"]["total_s"] == pytest.approx(3.5)


@both
@settings(max_examples=20, deadline=None)
@given(depth=st.integers(1, 8))
def test_nesting_depth_property(core, depth):
    tr_ = core.tracing
    server = tr_.TracingServer()
    tr = tr_.Tracer("t", server, tr_.TraceLevel.FULL)

    def rec(d):
        if d:
            with tr.span(f"d{d}"):
                rec(d - 1)

    rec(depth)
    spans = {s.span_id: s for s in server.timeline("t")}
    assert len(spans) == depth
    assert len([s for s in spans.values() if s.parent_id is None]) == 1


def _spans(tr_):
    """The same trace in either package: spans with fixed ids and times."""
    lv = tr_.TraceLevel
    return [
        tr_.Span("evaluation", lv.MODEL, "t", span_id=1, begin=0.0, end=9.0, tags={"agent": "a"}),
        tr_.Span("inference", lv.MODEL, "t", span_id=2, parent_id=1, begin=1.0, end=3.5,
                 tags={"batch": 2}),
        tr_.Span("layer_000_attn", lv.FRAMEWORK, "t", span_id=3, parent_id=2, begin=1.5,
                 end=2.0),
        tr_.Span("system:cuda", lv.SYSTEM, "t", span_id=4, parent_id=2,
                 tags={"device_ms": 1.25, "launches": {"rmsnorm": 7}}),
    ]


def test_span_json_matches_the_reference(tmp_path):
    ref, port = _spans(REF.tracing), _spans(PORT.tracing)
    assert [s.to_dict() for s in port] == [s.to_dict() for s in ref]
    paths = {}
    for name, core, spans in (("ref", REF, ref), ("port", PORT, port)):
        server = core.tracing.TracingServer()
        for s in spans:
            server.publish(s)
        paths[name] = tmp_path / f"{name}.json"
        server.dump("t", str(paths[name]))
    assert paths["port"].read_text() == paths["ref"].read_text()
    # each package loads the other's file into the same spans, in timeline order
    want = [s.to_dict() for s in sorted(ref, key=lambda s: (s.begin, s.span_id))]
    for reader, path in ((REF, paths["port"]), (PORT, paths["ref"])):
        assert [s.to_dict() for s in reader.tracing.TracingServer.load(str(path))] == want
    assert PORT.tracing.summarize(port) == REF.tracing.summarize(ref)


# ---------------------------------------------------------------------------
# manifest (mirrors tests/test_manifest.py; PyYAML is present here)
# ---------------------------------------------------------------------------
PAPER_MANIFEST = """
name: MLPerf_ResNet50_v1.5
version: 1.0.0
description: resnet50 v1.5 from MLPerf
framework:
  name: ref
  version: '>=1.0.0 <2.0'
inputs:
  - type: image
    layer_name: input_tensor
    element_type: float32
    steps:
      - decode:
          element_type: float32
      - resize:
          dimensions: [3, 224, 224]
      - normalize:
          mean: [123.68, 116.78, 103.94]
          rescale: 1.0
outputs:
  - type: probability
    layer_name: prob
    element_type: float32
    steps:
      - argsort:
          k: 5
model:
  base_path: /tmp/does-not-matter
  checksum: 7b94a2da05d
attributes:
  training_dataset: ImageNet
"""


@both
def test_paper_listing1_roundtrip(core):
    m = core.manifest.ModelManifest.from_yaml(PAPER_MANIFEST)
    assert m.name == "MLPerf_ResNet50_v1.5"
    assert m.backend_constraint == ">=1.0.0 <2.0"
    assert [s.op for s in m.inputs[0].steps] == ["decode", "resize", "normalize"]
    assert m.outputs[0].steps[0].params["k"] == 5
    again = core.manifest.ModelManifest.from_dict(m.to_dict())
    assert again.to_dict() == m.to_dict()
    assert m.key == "MLPerf_ResNet50_v1.5:1.0.0" and len(m.checksum()) == 16


def test_listing1_matches_the_reference_across_packages():
    ref = REF.manifest.ModelManifest.from_yaml(PAPER_MANIFEST)
    port = PORT.manifest.ModelManifest.from_yaml(PAPER_MANIFEST)
    assert port.to_dict() == ref.to_dict()
    assert port.to_yaml() == ref.to_yaml() and port.checksum() == ref.checksum()
    # each package reads the other's YAML back to the same manifest
    assert REF.manifest.ModelManifest.from_yaml(port.to_yaml()).to_dict() == ref.to_dict()
    assert PORT.manifest.ModelManifest.from_yaml(ref.to_yaml()).to_dict() == ref.to_dict()
    text = "name: pallas\nversion: 1.0.0\nmeshes:\n  pod: {shape: [16, 16]}\n"
    b_ref, b_port = (c.manifest.BackendManifest.from_yaml(text) for c in (REF, PORT))
    assert b_port.to_dict() == b_ref.to_dict() and b_port.key == "pallas:1.0.0"
    knobs = {"engine": "paged", "kv_dtype": "int8", "page_size": 16, "prefix_cache": True}
    assert PORT.manifest.EngineKnobs.from_dict(knobs).describe() == \
        REF.manifest.EngineKnobs.from_dict(knobs).describe()


def test_port_imports_yaml_only_when_asked():
    """PyYAML is not known to be on the card's machine: no module of the
    port (nor ``chip_smoke.py``) imports it at module level."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    offenders = []
    for f in files:
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{f.name}: {n}" for n in names if n.split(".")[0] == "yaml"]
    assert len(files) > 30 and not offenders, offenders
    assert "yaml" not in vars(PORT.manifest)


@both
@pytest.mark.parametrize(
    "spec,version,ok",
    [
        (">=1.12.0 <2.0", "1.15.0", True),
        (">=1.12.0 <2.0", "2.0.0", False),
        (">=1.12.0 <2.0", "1.11.9", False),
        ("", "0.0.1", True),
        ("==1.2.3", "1.2.3", True),
        ("~1.2", "1.2.9", True),
        ("~1.2", "1.3.0", False),
        (">1.0", "1.0.0", False),
    ],
)
def test_version_constraints(core, spec, version, ok):
    assert core.manifest.VersionConstraint(spec).satisfied_by(version) is ok


ver = st.tuples(st.integers(0, 20), st.integers(0, 20), st.integers(0, 20)).map(
    lambda t: f"{t[0]}.{t[1]}.{t[2]}")


@settings(max_examples=40, deadline=None)
@given(a=ver, b=ver)
def test_constraint_ordering_matches_the_reference(a, b):
    for spec in (f">={b}", f"<{b}", f"=={b}", f"~{b}", f">{b} <=20.0"):
        assert PORT.manifest.VersionConstraint(spec).satisfied_by(a) == \
            REF.manifest.VersionConstraint(spec).satisfied_by(a)
    assert PORT.manifest.parse_version(a) == REF.manifest.parse_version(a)


@both
def test_invalid_version_and_system_requirements(core):
    with pytest.raises(ValueError):
        core.manifest.parse_version("not-a-version")
    with pytest.raises(ValueError):
        core.manifest.ModelManifest.from_dict({"name": "x", "version": "bogus"})
    sr = core.manifest.SystemRequirements
    info = {"platform": "gpu", "num_devices": 4, "memory_bytes": 1 << 30, "mesh": "host"}
    assert sr().satisfied_by(info)
    assert sr(platform="gpu", min_devices=4).satisfied_by(info)
    assert not sr(min_devices=8).satisfied_by(info)
    assert not sr(platform="tpu").satisfied_by(info)
    assert not sr(mesh="pod").satisfied_by(info)


# ---------------------------------------------------------------------------
# registry (mirrors tests/test_registry.py)
# ---------------------------------------------------------------------------
def _agent(core, aid, models, backend="ref", load=0, system=None):
    return core.registry.AgentRecord(
        agent_id=aid, backend=backend, backend_version="1.0.0",
        system=system or {"platform": "cpu", "num_devices": 1, "mesh": "host"},
        models=models, load=load,
    )


@both
def test_ttl_heartbeat_and_expiry(core):
    clock = FakeClock()
    reg = core.registry.Registry(store=core.registry.KVStore(clock=clock))
    reg.register_agent(_agent(core, "a1", ["m:1.0.0"]))
    ttl = core.registry.Registry.AGENT_TTL
    for _ in range(5):
        clock.t += ttl / 2
        assert reg.heartbeat("a1")
    assert len(reg.agents()) == 1
    clock.t += ttl + 1
    assert not reg.heartbeat("a1") and reg.agents() == []


@both
def test_resolution_filters_orders_and_constrains(core):
    reg = core.registry.Registry(store=core.registry.KVStore(clock=FakeClock()))
    reg.register_agent(_agent(core, "busy", ["m:1.0.0"], load=5))
    reg.register_agent(_agent(core, "idle", ["m:1.0.0"], load=0))
    reg.register_agent(_agent(core, "other", ["x:1.0.0"], load=0))
    reg.register_agent(_agent(core, "card", ["m:1.0.0"], backend="torch", load=9,
                              system={"platform": "gpu", "num_devices": 1, "mesh": "host"}))
    assert [r.agent_id for r in reg.resolve("m:1.0.0")] == ["idle", "busy", "card"]
    assert [r.agent_id for r in reg.resolve("m:1.0.0", backend_name="torch")] == ["card"]
    req = core.manifest.SystemRequirements(platform="gpu")
    assert [r.agent_id for r in reg.resolve("m:1.0.0", requirements=req)] == ["card"]
    reg.update_load("idle", +7)
    assert [r.agent_id for r in reg.resolve("m:1.0.0", backend_name="ref")] == ["busy", "idle"]
    reg.update_load("idle", -20)
    assert {a.agent_id: a.load for a in reg.agents()}["idle"] == 0   # clamped


@both
def test_manifest_versions_and_dynamic_add_delete(core):
    reg = core.registry.Registry(store=core.registry.KVStore(clock=FakeClock()))
    for v in ("1.0.0", "1.2.0", "2.0.0"):
        reg.register_manifest(core.manifest.ModelManifest(name="m", version=v,
                                                          backend_constraint=""))
    assert reg.find_manifest("m", ">=1.0 <2.0").version == "1.2.0"
    assert reg.find_manifest("m").version == "2.0.0"
    assert reg.find_manifest("missing") is None
    assert reg.unregister_manifest("m:2.0.0")
    assert [m.version for m in reg.manifests("m")] == ["1.0.0", "1.2.0"]


@both
def test_kvstore_leases_and_copies(core, tmp_path):
    clock = FakeClock()
    store = core.registry.KVStore(clock=clock)
    store.put("lease", {"v": 1}, ttl=10)
    store.put("counter", {"n": 0})
    clock.t = 5
    assert store.renew("lease", ttl=10)
    for _ in range(3):
        assert store.mutate("counter", lambda rec: {"n": rec["n"] + 1})
    store.get("counter")["n"] = 99
    assert store.get("counter") == {"n": 3}
    path = str(tmp_path / "reg.json")
    store.dump(path)
    clock.t = 16
    assert not store.renew("lease", ttl=10) and store.get("lease") is None
    again = core.registry.KVStore(clock=clock)
    again.load(path)
    assert again.get("lease") is None and again.get("counter") == {"n": 3}


def test_registry_file_and_records_match_the_reference(tmp_path):
    """A registry dumped by either package loads in the other to the same
    agents, manifests and resolution order."""
    dumps = {}
    for core in (REF, PORT):
        reg = core.registry.Registry(store=core.registry.KVStore(clock=FakeClock()))
        reg.register_manifest(core.manifest.ModelManifest(name="m", version="1.2.0"))
        for aid, load in (("a", 3), ("b", 1)):
            reg.register_agent(_agent(core, aid, ["m:1.2.0"], load=load), ttl=100.0)
        path = tmp_path / f"{core.pkg}.json"
        reg.store.dump(str(path))
        dumps[core.pkg] = path
    assert json.loads(dumps["repro"].read_text()) == json.loads(dumps["repro_torch"].read_text())
    for reader, writer in ((REF, "repro_torch"), (PORT, "repro")):
        store = reader.registry.KVStore(clock=FakeClock())
        store.load(str(dumps[writer]))
        reg = reader.registry.Registry(store=store)
        assert [r.to_dict() for r in reg.resolve("m:1.2.0")] == \
            [_agent(REF, aid, ["m:1.2.0"], load=load).to_dict() for aid, load in (("b", 1), ("a", 3))]
        assert reg.find_manifest("m").to_dict() == \
            REF.manifest.ModelManifest(name="m", version="1.2.0").to_dict()


# ---------------------------------------------------------------------------
# evaldb: one file, either package
# ---------------------------------------------------------------------------
def _record(core, backend, **metrics):
    return core.evaldb.EvaluationRecord(
        model="glm4-9b", model_version="1.0.0", backend=backend, backend_version="1.0.0",
        system="host", scenario="online", batch_size=1, trace_level="MODEL",
        agent_id=f"{backend}-0", metrics=metrics, user_input={"model": "glm4-9b"},
        created_at=1.5,
    )


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)], ids=["ref-to-port",
                                                                            "port-to-ref"])
def test_evaldb_file_reads_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "eval.sqlite")
    db = writer.evaldb.EvalDB(path)
    spans = [s.to_dict() for s in _spans(writer.tracing)]
    eid = db.insert(_record(writer, "ref", trimmed_mean_ms=3.0), spans)
    db.insert(_record(writer, "torch", trimmed_mean_ms=2.0), [])
    db.close()
    other = reader.evaldb.EvalDB(path)
    eid2 = other.insert(_record(reader, "torch", trimmed_mean_ms=1.0), [])
    recs = other.query(model="glm4-9b")
    assert [(r.backend, r.metrics["trimmed_mean_ms"]) for r in recs] == \
        [("ref", 3.0), ("torch", 2.0), ("torch", 1.0)]
    assert other.spans(eid) == spans and other.spans(eid2) == []
    assert [r.eval_id for r in other.query(backend="torch")] == [eid + 1, eid2]
    assert other.best_version("glm4-9b", "trimmed_mean_ms", maximize=False) == "1.0.0"
    other.close()


# ---------------------------------------------------------------------------
# pipeline (mirrors tests/test_pipeline.py)
# ---------------------------------------------------------------------------
@both
def test_pipeline_order_errors_and_tracing(core):
    pipe = core.pipeline.Pipeline([("double", lambda x, m: x * 2), ("inc", lambda x, m: x + 1)])
    assert pipe.run(range(10)) == [2 * i + 1 for i in range(10)]

    def boom(x, m):
        if x == 3:
            raise ValueError("boom")
        return x

    with pytest.raises(ValueError, match="boom"):
        core.pipeline.Pipeline([("boom", boom)]).run(range(5))
    server = core.tracing.TracingServer()
    tr = core.tracing.Tracer("t", server, core.tracing.TraceLevel.MODEL)
    core.pipeline.Pipeline([("op1", lambda x, m: x)], tracer=tr).run([1, 2])
    assert len([s for s in server.timeline("t") if s.name == "op:op1"]) == 2
    with pytest.raises(KeyError):
        core.pipeline.build_steps([core.manifest.ProcessingStep("nonexistent-op")])


@both
def test_stages_overlap_on_threads(core):
    active = {"a": 0, "b": 0}
    overlap = []
    lock = threading.Lock()

    def stage(name):
        def fn(x, m):
            with lock:
                active[name] += 1
                overlap.append(sum(active.values()))
            time.sleep(0.005)
            with lock:
                active[name] -= 1
            return x

        return fn

    core.pipeline.Pipeline([("a", stage("a")), ("b", stage("b"))], channel_capacity=4).run(
        range(16))
    assert max(overlap) >= 2


@pytest.mark.parametrize("steps,inputs", [
    ([("decode", {"element_type": "uint8"}), ("resize", {"dimensions": [3, 8, 8]}),
      ("normalize", {"mean": 127.0, "rescale": 1.0})],
     [np.arange(16 * 16 * 3, dtype=np.uint8).reshape(16, 16, 3),
      np.arange(12 * 20 * 3, dtype=np.uint8).reshape(12, 20, 3)[::-1]]),
    ([("decode", {"element_type": "float32"}), ("resize", {"dimensions": [3, 32, 32]}),
      ("normalize", {"mean": [123.68, 116.78, 103.94], "rescale": 255.0})],
     [np.random.default_rng(0).integers(0, 255, (40, 24, 3)).astype(np.uint8)]),
    ([("tokenize", {"vocab_size": 50, "max_len": 8})], ["hello world", "a b c d e f g h i j"]),
    ([("argsort", {"k": 3})], [np.array([0.1, 0.5, 0.2, 0.9]), np.array([3.0, 1.0, 2.0])]),
    ([("topk_tokens", {"k": 2})], [np.array([[0.1, 0.7, 0.2], [0.9, 0.05, 0.05]])]),
    ([("identity", {})], [np.array([1, 2, 3])]),
], ids=["image-uint8", "image-resnet50", "tokenize", "argsort", "topk", "identity"])
def test_builtin_ops_match_the_reference(steps, inputs):
    outs = []
    for core in (REF, PORT):
        ops = core.pipeline.build_steps([core.manifest.ProcessingStep(op, dict(p))
                                         for op, p in steps])
        outs.append(core.pipeline.Pipeline(ops).run(list(inputs)))
    ref, port = outs
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b


# ---------------------------------------------------------------------------
# workload: every generator, output for output
# ---------------------------------------------------------------------------
TENANTS = [
    {"name": "chat", "rate_hz": 30.0, "priority": 2, "slo_ms": 80.0, "prompt_len": 64,
     "gen_tokens": 16},
    {"name": "batch", "rate_hz": 10.0, "priority": 0, "prompt_len": 512, "gen_tokens": 128,
     "num_requests": 5},
]
GENERATORS = [
    ("batched", dict(num_requests=5, batch_size=8)),
    ("poisson", dict(num_requests=40, rate_hz=20.0, seed=3)),
    ("server", dict(num_requests=16, rate_hz=20.0)),
    ("uniform", dict(num_requests=4, interval_s=0.25, batch_size=2)),
    ("trace", dict(arrivals=[0.1, 0.4, 0.45], batch_sizes=[2, 3, 1])),
    ("single_stream", dict(num_requests=6)),
    ("shared_prefix", dict(num_requests=20, rate_hz=40.0, prefix_len=32, suffix_len=8,
                           share_ratio=0.6, num_groups=3, seed=2)),
    ("shared_prefix", dict(num_requests=6, prefix_len=16)),
    ("bursty", dict(num_requests=50, rate_hz=30.0, burst_factor=4.0, on_s=0.5, off_s=1.0,
                    seed=1)),
    ("diurnal", dict(num_requests=50, rate_hz=30.0, period_s=2.0, amplitude=0.5, seed=4)),
    ("multi_tenant", dict(num_requests=12, tenants=TENANTS, seed=5)),
]


def _reqs(core, name, kw):
    return [(r.request_id, r.arrival_s, r.batch_size, r.tags)
            for r in core.workload.make_generator(name, **kw).requests()]


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GENERATORS)])
def test_generators_match_the_reference(name, kw):
    want = _reqs(REF, name, kw)
    assert want and _reqs(PORT, name, kw) == want


@pytest.mark.parametrize("seed", [0, 7])
def test_shared_prefix_prompts_match_the_reference(seed):
    kw = dict(num_requests=12, prefix_len=24, suffix_len=6, share_ratio=0.5, num_groups=2,
              seed=seed)
    prompts = [c.workload.shared_prefix_prompts(list(c.workload.SharedPrefixLoad(**kw).requests()),
                                                 vocab_size=1000, seed=seed)
               for c in (REF, PORT)]
    assert len(prompts[0]) == len(prompts[1]) == 12
    for a, b in zip(*prompts):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@both
def test_generator_registry_and_validation(core):
    wl = core.workload
    wl.register_generator("fixed3", lambda: wl.BatchedLoad(3, 1))
    assert len(list(wl.make_generator("fixed3").requests())) == 3
    with pytest.raises(KeyError):
        wl.make_generator("unknown-gen")
    with pytest.raises(ValueError):
        wl.TraceReplayLoad([0.1], [1, 2])
    with pytest.raises(ValueError):
        wl.PoissonLoad(3, 0.0)
    with pytest.raises(ValueError):
        wl.MultiTenantLoad(3, [{"name": "x"}])


# ---------------------------------------------------------------------------
# analysis (mirrors tests/test_analysis.py)
# ---------------------------------------------------------------------------
@both
def test_trimmed_mean_percentile_and_summary(core):
    an = core.analysis
    data = [100.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 0.0]
    s = sorted(data)
    k = math.floor(0.2 * len(s))
    assert an.trimmed_mean(data) == pytest.approx(np.mean(s[k:-k]))
    xs = list(range(1, 101))
    assert (an.percentile(xs, 90), an.percentile(xs, 100), an.percentile(xs, 1)) == (90, 100, 1)
    out = an.latency_summary([0.001, 0.002, 0.003])
    assert set(out) == {"trimmed_mean_ms", "p90_ms", "min_ms", "max_ms"}
    with pytest.raises(ValueError):
        an.trimmed_mean([])
    with pytest.raises(ValueError):
        an.percentile([], 50)
    assert an.throughput_scalability({1: 100.0, 2: 180.0, 4: 300.0})[4] == pytest.approx(3.0)


@settings(max_examples=40, deadline=None)
@given(xs=st.lists(st.floats(0, 1e6, allow_nan=False), min_size=1, max_size=50),
       pct=st.floats(0, 100), slo=st.floats(0, 2e3))
def test_metrics_match_the_reference(xs, pct, slo):
    ref, port = REF.analysis, PORT.analysis
    assert port.trimmed_mean(xs) == ref.trimmed_mean(xs)
    assert port.percentile(xs, pct) == ref.percentile(xs, pct)
    assert port.latency_summary(xs) == ref.latency_summary(xs)
    assert port.slo_attainment(xs, slo) == ref.slo_attainment(xs, slo)
    assert port.jain_index(xs) == ref.jain_index(xs)
    per_batch = {2 ** i: x + 1.0 for i, x in enumerate(xs[:6])}   # throughputs > 0
    assert port.throughput_scalability(per_batch) == ref.throughput_scalability(per_batch)


def _trace(core):
    tr_ = core.tracing
    lv = tr_.TraceLevel
    spans = [
        tr_.Span("evaluation", lv.MODEL, "t", span_id=1, begin=0.0, end=100.0),
        tr_.Span("inference", lv.MODEL, "t", span_id=2, parent_id=1, begin=10.0, end=90.0),
        tr_.Span("preprocess", lv.MODEL, "t", span_id=3, parent_id=1, begin=0.0, end=5.0),
        tr_.Span("conv2d_48", lv.FRAMEWORK, "t", span_id=4, parent_id=2, begin=10, end=17.59),
        tr_.Span("conv2d_48", lv.FRAMEWORK, "t", span_id=5, parent_id=2, begin=18, end=25.57),
        tr_.Span("conv2d_45", lv.FRAMEWORK, "t", span_id=6, parent_id=2, begin=26, end=31.67),
        tr_.Span("fc6", lv.FRAMEWORK, "t", span_id=7, parent_id=2, begin=32, end=80.0),
        tr_.Span("system:cuda", lv.SYSTEM, "t", span_id=8, parent_id=2, tags={"device_ms": 1.0}),
    ]
    for i, (occ, depth) in enumerate(((4, 3), (2, 0), (1, 5))):
        spans.append(tr_.Span("scheduler:batch", lv.MODEL, "t", span_id=20 + i, begin=i,
                              end=i + 0.5, tags={"occupancy": occ, "queue_depth": depth,
                                                 "inputs": occ}))
    return spans


def test_trace_analysis_matches_the_reference():
    ref, port = _trace(REF), _trace(PORT)
    ra, pa = REF.analysis, PORT.analysis
    as_tuples = lambda stats: [(s.name, s.count, s.total_s, s.mean_s) for s in stats]
    assert as_tuples(pa.layer_breakdown(port)) == as_tuples(ra.layer_breakdown(ref))
    assert as_tuples(pa.top_layers(port, k=2)) == as_tuples(ra.top_layers(ref, k=2))
    assert pa.top_layers(port, k=1)[0].name == "fc6"
    assert [s.name for s in pa.critical_path(port)] == [s.name for s in ra.critical_path(ref)] \
        == ["evaluation", "inference", "fc6"]
    assert pa.level_breakdown(port) == ra.level_breakdown(ref)
    assert pa.scheduler_summary(port) == ra.scheduler_summary(ref)
    rows = [{"model": "a", "ms": 1.25, "ok": True}, {"model": "b", "ms": 0.5, "ok": False}]
    assert pa.comparison_table(rows, ["model", "ms", "ok"], sort_by="ms") == \
        ra.comparison_table(rows, ["model", "ms", "ok"], sort_by="ms")
    sections = [("Evaluations", ra.comparison_table(rows, ["model", "ms"])), ("Notes", "- x")]
    assert pa.markdown_report("title", sections) == ra.markdown_report("title", sections)
