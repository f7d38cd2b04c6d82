"""The port's evaluation platform end to end on the CPU, against the JAX one.

``tests/test_system.py`` mirrored on ``LocalPlatform(backends=("torch",),
device="cpu")``; the paper's claim that one evaluation spec runs unchanged
on different framework predictors: a JAX platform and the port evaluate the
same request into one sqlite file, which the reference reads; the torch
predictor's logits against the JAX predictor's on the JAX weights (bridged
with ``repro_torch.models.from_jax``), within ``LOGIT_TOL`` of
``tests/test_torch_model.py`` (1e-4 relative and absolute, float32: the
summation order differs); the FRAMEWORK trace's layer spans named as the
reference names them, and ``forward_instrumented`` bit-equal to
``forward``.
"""
import numpy as np
import pytest
import torch

from repro.core import EvalDB as RefEvalDB
from repro.core import EvaluationRequest as RefRequest
from repro.core import OpenRequest as RefOpenRequest
from repro.core import ScenarioSpec as RefSpec
from repro.core import make_predictor as ref_make_predictor
from repro.core import NullTracer as RefNullTracer
from repro.core.platform import LocalPlatform as RefPlatform
from repro.core.platform import builtin_manifests as ref_manifests
from repro_torch.configs import get_config
from repro_torch.core import (
    DispatchError,
    DispatchPolicy,
    EvaluationRequest,
    NullTracer,
    OpenRequest,
    ScenarioSpec,
    SchedulerConfig,
    Span,
    SystemRequirements,
    Tracer,
    TraceLevel,
    TracingServer,
    make_predictor,
    scheduler_summary,
)
from repro_torch.core import client
from repro_torch.core.platform import LocalPlatform, builtin_manifests
from repro_torch.models import build_model, from_jax

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# the port's architectures, in the reference's order
ARCHS = ("zamba2-2.7b", "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "deepseek-67b",
         "granite-20b", "glm4-9b", "gemma2-27b", "chameleon-34b", "mamba2-130m",
         "whisper-large-v3")
# the built-in manifests: the architectures, then the paper's ResNet-50
MODELS = ARCHS + ("resnet50",)


@pytest.fixture(scope="module")
def platform():
    p = LocalPlatform(backends=("torch",), device="cpu")
    yield p
    p.shutdown()


def _online(model, level="NONE", n=1, seq_len=8, backend="torch", cls=EvaluationRequest,
            spec=ScenarioSpec):
    return cls(model=model, backend=backend,
               scenario=spec(kind="online", num_requests=n, rate_hz=1000.0, warmup=0),
               trace_level=level, seq_len=seq_len)


# ---------------------------------------------------------------------------
# tests/test_system.py on the port
# ---------------------------------------------------------------------------
def test_initialization_workflow_registers_models_and_agents(platform):
    assert sorted(m.name for m in platform.registry.manifests()) == sorted(MODELS)
    (agent,) = platform.registry.agents()
    assert agent.backend == "torch" and agent.system["platform"] == "cpu"
    assert sorted(agent.models) == sorted([f"{arch}:1.0.0" for arch in ARCHS]
                                          + ["resnet50:1.5.0"])


@pytest.mark.parametrize("reduced", [True, False])
def test_builtin_manifests_equal_the_reference_entries(reduced):
    ref = {m.name: m.to_dict() for m in ref_manifests(reduced=reduced)}
    port = builtin_manifests(reduced=reduced)
    assert [m.name for m in port] == list(ref) == list(MODELS)
    for m in port:
        assert m.to_dict() == ref[m.name]


def test_evaluation_workflow_end_to_end(platform):
    req = _online("glm4-9b", "MODEL", n=3, seq_len=16)
    req.scenario.warmup = 1
    (res,) = platform.evaluate(req)
    metrics = res["metrics"]
    assert metrics["trimmed_mean_ms"] > 0 and metrics["p90_ms"] >= metrics["min_ms"]
    recs = platform.evaldb.query(model="glm4-9b", backend="torch")
    assert recs and recs[-1].metrics["trimmed_mean_ms"] > 0
    names = {s["name"] for s in platform.evaldb.spans(recs[-1].eval_id)}
    assert {"evaluation", "model_load", "weight_init", "inference"} <= names


def test_batched_scenario_reports_optimal_batch(platform):
    req = EvaluationRequest(
        model="mamba2-130m", backend="torch",
        scenario=ScenarioSpec(kind="batched", num_requests=2, batch_sizes=[1, 2], warmup=1),
        trace_level="NONE", seq_len=16)
    m = platform.evaluate(req)[0]["metrics"]
    assert m["optimal_batch_size"] in (1, 2) and m["max_throughput_ips"] > 0


def test_scheduler_backed_offline_evaluation(platform):
    req = EvaluationRequest(model="mamba2-130m", backend="torch",
                            scenario=ScenarioSpec(kind="offline", num_requests=8, warmup=1),
                            trace_level="MODEL", seq_len=16)
    assert EvaluationRequest.from_dict(req.to_dict()).scheduler is None
    m = platform.evaluate(req, scheduler=SchedulerConfig(max_batch=4,
                                                         batch_timeout_ms=0.0))[0]["metrics"]
    assert m["scenario"] == "offline" and m["throughput_ips"] > 0
    assert m["sched_mean_batch_occupancy"] == pytest.approx(4.0)
    assert EvaluationRequest.from_dict(req.to_dict()).scheduler.max_batch == 4
    recs = platform.evaldb.query(model="mamba2-130m", scenario="offline")
    spans = [Span.from_dict(d) for d in platform.evaldb.spans(recs[-1].eval_id)]
    assert scheduler_summary(spans)["batches"] == 2.0
    assert scheduler_summary(spans)["total_inputs"] == 8.0
    assert "Scheduler (queueing + micro-batching)" in platform.report(model="mamba2-130m",
                                                                       scenario="offline")


def test_server_scenario_evaluation(platform):
    req = EvaluationRequest(
        model="mamba2-130m", backend="torch",
        scenario=ScenarioSpec(kind="server", num_requests=4, rate_hz=200.0, warmup=1,
                              slo_ms=10_000.0),
        trace_level="NONE", seq_len=16)
    m = platform.evaluate(req)[0]["metrics"]
    assert m["scenario"] == "server" and m["achieved_qps"] > 0
    assert 0.0 <= m["slo_attainment"] <= 1.0


def test_analysis_workflow_report(platform):
    report = platform.report(model="glm4-9b")
    assert "MLModelScope report" in report and "glm4-9b" in report


def test_dispatch_errors_and_requirements(platform):
    with pytest.raises(DispatchError):
        platform.evaluate(EvaluationRequest(model="nonexistent-model"))
    with pytest.raises(DispatchError):
        platform.evaluate(_online("glm4-9b"), requirements=SystemRequirements(platform="gpu"))
    res = platform.evaluate(_online("glm4-9b"), requirements=SystemRequirements(platform="cpu"))
    assert res[0]["metrics"]["num_requests"] == 1


def test_agent_failure_failover():
    p = LocalPlatform(backends=("torch", "torch"), device="cpu")
    try:
        for agent in p.agents.values():
            agent.fail_next = 1
            break
        res = p.evaluate(_online("mamba2-130m"), policy=DispatchPolicy(max_attempts=3))
        assert res and res[0]["metrics"]["trimmed_mean_ms"] > 0
    finally:
        p.shutdown()


def test_all_agents_fanout():
    p = LocalPlatform(backends=("torch", "torch"), device="cpu")
    try:
        res = p.evaluate(_online("mamba2-130m"), policy=DispatchPolicy(all_agents=True))
        assert len(res) == 2 and len({r["agent_id"] for r in res}) == 2
    finally:
        p.shutdown()


def test_lease_expiry_counts_as_node_failure():
    p = LocalPlatform(backends=("torch",), device="cpu")
    try:
        p.registry.deregister_agent(next(iter(p.agents)))
        with pytest.raises(DispatchError):
            p.evaluate(_online("mamba2-130m"))
    finally:
        p.shutdown()


def test_platform_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalPlatform(backends=("torch",))


def test_resnet_is_not_ported():
    """The reference's ResNet-50 manifest opens on the torch predictor (the
    test's name predates the port of ResNet-50): the reduced model, float32
    on the CPU, its image logits from the manifest's seed."""
    manifest = ref_manifests(reduced=True)[-1]
    assert manifest.name == "resnet50"
    from repro_torch.core.manifest import ModelManifest

    port_manifest = ModelManifest.from_dict(manifest.to_dict())
    pred = make_predictor("torch")
    handle = pred.open(OpenRequest(manifest=port_manifest, device="cpu"), NullTracer())
    assert handle.state["kind"] == "resnet" and handle.model_key == "resnet50:1.5.0"
    cfg = handle.state["cfg"]
    assert (cfg.stage_sizes, cfg.width, cfg.num_classes, cfg.img_size) == ((1, 1, 1, 1), 16,
                                                                            64, 32)
    images = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    logits = pred.predict(handle, images, NullTracer())
    assert logits.shape == (2, 64) and logits.dtype == np.float32 and np.isfinite(logits).all()
    pred.close(handle)


def test_predictor_refuses_weights_past_the_card(monkeypatch):
    """The platform's model load holds the rule the serve driver does:
    weights that exceed the card's memory are refused before allocating."""
    from repro_torch.models import lm

    monkeypatch.setattr(lm, "_device_memory", lambda device: 1024)
    manifest = next(m for m in builtin_manifests(reduced=True) if m.name == "deepseek-67b")
    with pytest.raises(MemoryError, match="runs reduced only"):
        make_predictor("torch").open(OpenRequest(manifest=manifest, device="cpu"), NullTracer())


# ---------------------------------------------------------------------------
# trace levels
# ---------------------------------------------------------------------------
def _span_names(spans, level):
    return [s["name"] for s in spans if s["level"] == int(level)]


@pytest.mark.parametrize("arch", ARCHS)
def test_framework_spans_are_named_as_the_reference_names_them(arch):
    port, ref = LocalPlatform(backends=("torch",), device="cpu"), RefPlatform(backends=("ref",))
    try:
        got = port.evaluate(_online(arch, "FRAMEWORK", n=2))[0]
        want = ref.evaluate(_online(arch, "FRAMEWORK", n=2, backend="ref", cls=RefRequest,
                                    spec=RefSpec))[0]
        got_spans, want_spans = port.evaldb.spans(got["eval_id"]), ref.evaldb.spans(want["eval_id"])
        layers = _span_names(got_spans, TraceLevel.FRAMEWORK)
        assert layers == _span_names(want_spans, TraceLevel.FRAMEWORK)
        cfg = get_config(arch, reduced=True)
        # llama4's interleaved pairs: a dense layer, then a MoE layer
        kind = (lambda l: "mamba") if cfg.family in ("ssm", "hybrid") else \
            (lambda l: ("dense", "moe")[l % 2]) if cfg.moe_every == 2 else (lambda l: "attn")
        # gemma2's alternating windows: the reference's values in the names
        suffix = (lambda l: f"_w{1 << 30 if l % 2 else 8}") if arch == "gemma2-27b" else \
            (lambda l: "")
        # zamba2's shared block after each group of hybrid_attn_every layers
        E = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        shared = lambda l: ([f"layer_{l // E:03d}_shared_attn"] if E and l % E == E - 1
                            else [])
        if cfg.family == "encdec":      # whisper: the encoder's layers, then the decoder's
            want = (["enc_embed"] + [f"enc_layer_{l:03d}" for l in range(cfg.encoder_layers)]
                    + ["enc_norm", "dec_embed"]
                    + [f"dec_layer_{l:03d}" for l in range(cfg.num_layers)] + ["logits"])
        else:
            want = (["embed"] + [n for l in range(cfg.num_layers)
                                 for n in [f"layer_{l:03d}_{kind(l)}{suffix(l)}"] + shared(l)]
                    + ["logits"])
        assert layers == 2 * want
        assert sorted(set(_span_names(got_spans, TraceLevel.MODEL))) == \
            sorted(set(_span_names(want_spans, TraceLevel.MODEL)))
    finally:
        port.shutdown()
        ref.shutdown()


def test_system_level_on_the_cpu_has_no_cuda_event(platform):
    res = platform.evaluate(_online("mamba2-130m", "SYSTEM", n=2))[0]
    names = [s["name"] for s in platform.evaldb.spans(res["eval_id"])]
    assert "system:host_counters" in names and "system:cuda" not in names
    assert names.count("layer_000_mamba") == 2          # SYSTEM includes FRAMEWORK


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_instrumented_equals_forward(arch):
    model = build_model(get_config(arch, reduced=True), device="cpu")
    params = model.init(seed=1)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 11)).astype(np.int32))}
    cfg = model.cfg
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    seen = []

    def hook(name, thunk):
        seen.append(name)
        return thunk()

    with torch.inference_mode():
        want = model.forward(params, batch)[0]
        got = model.forward_instrumented(params, batch, hook)
    assert torch.equal(got, want) and got.dtype == torch.float32
    # a hybrid model adds its shared block after each group; an enc-dec
    # model runs its encoder's layers and norm and the decoder's embedding
    groups = cfg.num_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    if cfg.family == "encdec":
        assert seen[0] == "enc_embed" and seen[-1] == "logits" and \
            len(seen) == cfg.encoder_layers + cfg.num_layers + 4
    else:
        assert seen[0] == "embed" and seen[-1] == "logits" and \
            len(seen) == cfg.num_layers + groups + 2


# ---------------------------------------------------------------------------
# the paper's claim: one evaluation, two framework predictors, one evaldb
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["online", "offline"])
def test_jax_and_torch_evaluations_land_in_one_evaldb(tmp_path, kind):
    path = str(tmp_path / "evals.sqlite")
    spec = dict(kind=kind, num_requests=3, rate_hz=1000.0, warmup=1)
    common = dict(model="mamba2-130m", trace_level="MODEL", batch_size=1, seq_len=16)
    ref, port = RefPlatform(backends=("ref",), evaldb_path=path), \
        LocalPlatform(backends=("torch",), evaldb_path=path, device="cpu")
    try:
        ref_res = ref.evaluate(RefRequest(backend="ref", scenario=RefSpec(**spec), **common))[0]
        port_res = port.evaluate(EvaluationRequest(backend="torch", scenario=ScenarioSpec(**spec),
                                                   **common))[0]
        assert sorted(port_res["metrics"]) == sorted(ref_res["metrics"])
    finally:
        ref.shutdown()
        port.shutdown()
    db = RefEvalDB(path)
    try:
        recs = db.query(model="mamba2-130m", scenario=kind)
        assert sorted(r.backend for r in recs) == ["ref", "torch"]
        by = {r.backend: r for r in recs}
        strip = lambda u: {k: v for k, v in u.items() if k != "backend"}
        assert strip(by["torch"].user_input) == strip(by["ref"].user_input)
        assert sorted(by["torch"].metrics) == sorted(by["ref"].metrics)
        assert by["torch"].model_version == by["ref"].model_version == "1.0.0"
        for r in recs:
            names = {s["name"] for s in db.spans(r.eval_id)}
            assert {"evaluation", "model_load", "inference", f"scenario:{kind}"} <= names
    finally:
        db.close()


# ---------------------------------------------------------------------------
# predictor parity on the JAX weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,backend,seq_len", [("glm4-9b", "pallas", 12),
                                                  ("gemma2-27b", "pallas", 20),
                                                  ("chameleon-34b", "pallas", 12),
                                                  ("granite-20b", "pallas", 12),
                                                  ("qwen3-moe-30b-a3b", "pallas", 12),
                                                  ("llama4-maverick-400b-a17b", "pallas", 12),
                                                  ("mamba2-130m", "ref", 12),
                                                  ("mamba2-130m", "pallas", 16),
                                                  ("zamba2-2.7b", "ref", 12),
                                                  ("zamba2-2.7b", "pallas", 16)])
def test_torch_predictor_matches_the_jax_predictor(arch, backend, seq_len):
    """The JAX predictor (``pallas``: its Pallas kernels in interpret mode;
    mamba2's and zamba2's Pallas ``ssd`` needs whole chunks, so 16 = 2
    chunks of 8) and
    the torch one on the same tokens, the torch handle's weights swapped
    for the JAX handle's."""
    ref_manifest = next(m for m in ref_manifests(reduced=True) if m.name == arch)
    port_manifest = next(m for m in builtin_manifests(reduced=True) if m.name == arch)
    jpred, tpred = ref_make_predictor(backend), make_predictor("torch")
    jh = jpred.open(RefOpenRequest(manifest=ref_manifest, backend=backend, seq_len=seq_len),
                    RefNullTracer())
    th = tpred.open(OpenRequest(manifest=port_manifest, seq_len=seq_len, device="cpu"),
                    NullTracer())
    th.state["params"] = from_jax(jh.state["params"])
    tokens = np.random.default_rng(3).integers(0, 256, (2, seq_len)).astype(np.int32)
    want = np.asarray(jpred.predict(jh, tokens, RefNullTracer()))
    got = tpred.predict(th, tokens, NullTracer())
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    # the FRAMEWORK path on the same handle gives the MODEL path's bits
    tracer = Tracer("t", TracingServer(), TraceLevel.FRAMEWORK)
    assert np.array_equal(tpred.predict(th, tokens, tracer), got)
    tpred.close(th)
    assert th.state is None


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------
def test_client_runs_on_the_cpu(capsys, tmp_path):
    db = str(tmp_path / "cli.sqlite")
    assert client.main(["--evaldb", db, "evaluate", "--device", "cpu", "--model", "mamba2-130m",
                        "--scenario", "server", "--num-requests", "4", "--rate-hz", "100",
                        "--seq-len", "8", "--warmup", "1", "--sched-max-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "achieved_qps" in out and "sched_batches" in out
    assert "# MLModelScope report: mamba2-130m" in out and "torch" in out
    assert client.main(["--evaldb", db, "report", "--device", "cpu", "--model",
                        "mamba2-130m"]) == 0
    assert "server" in capsys.readouterr().out
    assert client.main(["list-models", "--device", "cpu"]) == 0
    assert "glm4-9b:1.0.0" in capsys.readouterr().out
    assert client.main(["list-agents", "--device", "cpu"]) == 0
    assert "backend=torch" in capsys.readouterr().out
    args = client.build_parser().parse_args(["evaluate", "--model", "glm4-9b"])
    assert (args.device, args.full, args.backends, args.backend) == ("cuda", False, "torch",
                                                                     "torch")
    args = client.build_parser().parse_args(["evaluate", "--full", "--device", "cpu",
                                             "--model", "glm4-9b"])
    assert (args.device, args.full) == ("cpu", True)
