"""The MoE family through the port's dense-cache engines, its driver and its
platform, against the JAX package where it has a counterpart.

Reduced qwen3-moe-30b-a3b and llama4-maverick-400b-a17b (dense and MoE
layers interleaved, its cache ``(L/2, 2, b, S, kv, d)``) at a capacity
factor that drops slots, on weights bridged from JAX with every norm
perturbed: ``generate`` and ``serve_continuous`` greedy tokens (and the
continuous schedule) exactly equal to the JAX engines' (float32).  Then the
refusals: llama4 has no paged layout (the engine and the driver stop with
the reference's words), and on an 80 GB card ``weights_fit`` refuses full
llama4 (740.8 GiB of bf16 weights) and admits full qwen3 (56.9 GiB), at
every entry point.  Then a reduced qwen3 evaluation through the port's
``LocalPlatform`` on the CPU, and the driver's MoE header.
"""
import numpy as np
import pytest
import torch

from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.models import DecoderLM
from repro_torch.serve import engine as teng
from test_torch_moe_serve import engines, moe_weights, prompts, requests

ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
CARD = 80 * 10**9


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return moe_weights(request.param)


def test_generate_tokens_equal_jax(weights):
    cfg = weights[0]
    jengine, tengine = engines(weights)
    ps = prompts(cfg, seed=9)[:3]
    want = jengine.generate(ps, max_new_tokens=5)
    got = tengine.generate(ps, max_new_tokens=5)
    assert got.tokens.shape == (3, 5)
    np.testing.assert_array_equal(got.tokens, want.tokens)


class VirtualClock:
    """A clock that advances one unit per read: deterministic timings."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_serve_continuous_equals_jax(weights):
    cfg = weights[0]
    jengine, tengine = engines(weights)
    ps = prompts(cfg, seed=10)
    want = jengine.serve_continuous(requests(jeng, ps), num_slots=2, clock=VirtualClock())
    got = tengine.serve_continuous(requests(teng, ps), num_slots=2, clock=VirtualClock())
    assert [(r.request_id, r.slot, r.admit_step, r.finish_step, r.tokens.tolist())
            for r in got.results] == \
        [(r.request_id, r.slot, r.admit_step, r.finish_step, r.tokens.tolist())
         for r in want.results]
    assert got.steps == want.steps


def test_llama4_is_refused_by_the_paged_engine():
    weights = moe_weights("llama4-maverick-400b-a17b")
    cfg = weights[0]
    jengine, tengine = engines(weights)
    ps = prompts(cfg)[:1]
    with pytest.raises(NotImplementedError) as jerr:
        jengine.serve_paged(requests(jeng, ps, (2,)))
    with pytest.raises(NotImplementedError) as terr:
        tengine.serve_paged(requests(teng, ps, (2,)))
    assert str(terr.value) == str(jerr.value)
    assert "(non-interleaved)" in str(terr.value)


def test_driver_refuses_paged_llama4_and_prints_the_moe_config(capsys):
    from repro_torch.launch import serve
    from repro_torch.models.lm import NOT_PAGED

    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama4-maverick-400b-a17b", "--device", "cpu", "--requests", "1"])
    assert NOT_PAGED in capsys.readouterr().err
    assert serve.main(["--arch", "llama4-maverick-400b-a17b", "--device", "cpu", "--engine",
                       "continuous", "--requests", "3", "--prompt-len", "8",
                       "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert ("[serve] moe: 8 experts of d_ff 64, top 1, capacity factor 2.0, every other of 2 "
            "layers (dense layers of d_ff 128 between)") in out
    assert serve.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--requests", "4",
                       "--prompt-len", "20", "--prompt-len-min", "3", "--max-new-tokens", "4",
                       "--engine-batch", "3", "--page-size", "4", "--max-seq", "32",
                       "--spec-k", "2", "--spec-ngram", "1", "--kv-dtype", "int8"]) == 0
    out = capsys.readouterr().out
    assert "[serve] moe: 8 experts of d_ff 32, top 2, capacity factor 2.0\n" in out
    assert "[serve]   moe                  moe: 8 experts" in out
    assert "[serve]   completed            4" in out


def test_weights_fit_refuses_full_llama4_and_admits_full_qwen3(monkeypatch, capsys):
    """As deepseek-67b: on an 80 GB card full llama4's 740.8 GiB of bf16
    weights are refused before anything is allocated, at ``init``, the
    driver and the platform's model load; full qwen3 fits."""
    from repro_torch.core import NullTracer, OpenRequest, make_predictor
    from repro_torch.core.platform import builtin_manifests
    from repro_torch.launch import serve
    from repro_torch.models import lm

    why = lm.weights_fit(get_config("llama4-maverick-400b-a17b"), torch.bfloat16, CARD)
    assert "740.8 GiB" in why and "runs reduced only" in why
    assert lm.weights_fit(get_config("qwen3-moe-30b-a3b"), torch.bfloat16, CARD) is None
    assert get_config("qwen3-moe-30b-a3b").param_count() * 2 / 2**30 == pytest.approx(56.9,
                                                                                     abs=0.05)
    monkeypatch.setattr(lm, "_device_memory", lambda device: CARD)
    with pytest.raises(MemoryError, match="740.8 GiB"):
        DecoderLM(get_config("llama4-maverick-400b-a17b"), device="cpu",
                  dtype=torch.bfloat16).init()
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama4-maverick-400b-a17b", "--full", "--device", "cpu",
                    "--dtype", "bfloat16", "--engine", "static"])
    assert "runs reduced only" in capsys.readouterr().err
    manifest = next(m for m in builtin_manifests(reduced=False)
                    if m.name == "llama4-maverick-400b-a17b")
    with pytest.raises(MemoryError, match="runs reduced only"):
        make_predictor("torch").open(OpenRequest(manifest=manifest, device="cpu"),
                                     NullTracer())


def test_platform_evaluates_reduced_qwen3():
    """A reduced qwen3 evaluation through the port's platform on the CPU:
    online, MODEL and FRAMEWORK traces; the layer spans carry the
    reference's names."""
    from repro_torch.core import EvaluationRequest, ScenarioSpec
    from repro_torch.core.platform import LocalPlatform

    platform = LocalPlatform(backends=("torch",), device="cpu")
    try:
        for level in ("MODEL", "FRAMEWORK"):
            req = EvaluationRequest(
                model="qwen3-moe-30b-a3b", backend="torch",
                scenario=ScenarioSpec(kind="online", num_requests=3, rate_hz=1000.0, warmup=1),
                trace_level=level, seq_len=16)
            (res,) = platform.evaluate(req)
            assert res["metrics"]["trimmed_mean_ms"] > 0
            names = {s["name"] for s in platform.evaldb.spans(res["eval_id"])}
            assert {"evaluation", "model_load", "inference"} <= names
            if level == "FRAMEWORK":
                assert {"embed", "layer_000_attn", "layer_001_attn", "logits"} <= names
        recs = platform.evaldb.query(model="qwen3-moe-30b-a3b", backend="torch")
        assert len(recs) == 2
        manifest = next(m for m in platform.registry.manifests()
                        if m.name == "qwen3-moe-30b-a3b")
        assert manifest.attributes["family"] == "moe"
        assert manifest.attributes["params_active"] < manifest.attributes["params"]
    finally:
        platform.shutdown()
