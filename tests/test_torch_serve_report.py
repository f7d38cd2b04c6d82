"""What a traced paged run reports, in the port against the JAX package.

The serving-event summaries copied into ``repro_torch.core.analysis`` return
the reference's results on the same spans; a traced speculative
``serve_paged`` emits the reference's ``spec:verify`` events (count and
every field but time) and the same ``spec_decode_summary``; a bf16 model on
the CPU takes its LM head product in float32, so logits after the softcap
equal the float32 product of the same bf16 operands; and the driver takes
the reference's paged flags and prints its report sections.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import analysis as janalysis
from repro.core import tracing as jtracing
from repro.models import build_model
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.core import analysis as tanalysis
from repro_torch.core import tracing as ttracing
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM, from_jax
from repro_torch.serve import engine as teng

SUMMARIES = ("page_occupancy", "prefill_saturation", "spec_decode", "prefix_cache", "slo")


def _spans(tr, seed):
    """A mixed span list of every event the summaries read, plus noise."""
    rng = np.random.default_rng(seed)
    S = lambda name, **tags: tr.Span(name=name, level=tr.TraceLevel.SYSTEM, trace_id="t",
                                     begin=float(rng.uniform(0, 1)),
                                     end=float(rng.uniform(1, 2)), tags=tags)
    out = []
    for i in range(12):
        n = lambda lo, hi: int(rng.integers(lo, hi))
        out += [
            S("pages:occupancy", step=i, pages_in_use=n(0, 40), pages_free=n(0, 40),
              num_pages=40, active_slots=n(0, 4)),
            S("prefill:packed", tokens=n(1, 64), padding=n(0, 16), chunks=n(1, 4), buffer=64,
              budget=64),
            S("spec:verify", window=3, slots=n(1, 4), proposed=n(0, 8), accepted=n(0, 4),
              emitted=n(1, 8)),
            S("prefix:lookup", prompt_tokens=n(8, 40), cached_tokens=8 * n(0, 3),
              hit_pages=n(0, 3), full_hit=n(0, 2)),
            S("prefix:cow", slot=n(0, 4), page=n(1, 40)),
            S("prefix:evict", pages=n(1, 4)),
            S("sched:tenant", tenant=["a", "b", "c"][n(0, 3)], priority=n(0, 3),
              status=["completed", "rejected", "failed"][n(0, 3)],
              latency_s=float(rng.uniform(0, 2)), slo_ms=500.0, slo_ok=bool(n(0, 2)),
              tokens=float(n(10, 50))),
            S("sched:defer", tenant="b"),
            S("batch:execute", batch=n(1, 4)),
        ]
    return out


@pytest.mark.parametrize("name", SUMMARIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_summaries_match_the_reference(name, seed):
    jspans, tspans = _spans(jtracing, seed), _spans(ttracing, seed)
    want = getattr(janalysis, f"{name}_summary")(jspans)
    assert want
    assert getattr(tanalysis, f"{name}_summary")(tspans) == want
    assert (getattr(tanalysis, f"{name}_section")(tspans)
            == getattr(janalysis, f"{name}_section")(jspans))
    assert getattr(tanalysis, f"{name}_summary")([]) == {}
    assert getattr(tanalysis, f"{name}_section")([]) == ""


def test_itl_and_kv_divergence_match_the_reference():
    rng = np.random.default_rng(3)
    itls = list(rng.uniform(0, 0.05, 40))
    assert tanalysis.itl_summary(itls) == janalysis.itl_summary(itls)
    assert tanalysis.itl_summary([]) == {}
    ref = [rng.integers(0, 9, 8).tolist() for _ in range(6)]
    test = [r[:] for r in ref]
    test[1][3] += 1
    test[4] = test[4][:5]
    assert tanalysis.kv_divergence_summary(ref, test) == janalysis.kv_divergence_summary(ref,
                                                                                         test)
    assert (tanalysis.kv_divergence_section(ref, test)
            == janalysis.kv_divergence_section(ref, test))
    with pytest.raises(ValueError, match="mismatched request counts"):
        tanalysis.kv_divergence_summary(ref, test[:2])


# ---------------------------------------------------------------------------
# spec:verify events
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    return cfg, (jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=48),
                 teng.ServingEngine(tmodel, from_jax(jax.tree.map(np.asarray, jparams)),
                                    max_batch=3, max_seq=48, device="cpu"))


def _small_alphabet(mod, seed=5):
    """Prompts over a 4-token alphabet: prompt lookup drafts, and some drafts
    are rejected mid-window (tests/test_spec_decode.py's setup)."""
    rng = np.random.default_rng(seed)
    return [mod.ServeRequest(request_id=i, prompt=rng.integers(0, 4, (12,)).astype(np.int32),
                             max_new_tokens=14) for i in range(3)]


@pytest.mark.parametrize("prefill_mode", ["packed", "chunked"])
def test_spec_verify_events_match_jax(engines, prefill_mode):
    cfg, pair = engines
    runs = []
    for mod, tr, engine in zip((jeng, teng), (jtracing, ttracing), pair):
        server = tr.TracingServer()
        stats = engine.serve_paged(_small_alphabet(mod), page_size=4, spec_k=2, spec_ngram=1,
                                   prefill_mode=prefill_mode, tracer=tr.Tracer("t", server))
        runs.append((stats, server.timeline("t")))
    (jstats, jspans), (tstats, tspans) = runs
    pick = lambda spans: [s.tags for s in spans if s.name == "spec:verify"]
    assert pick(tspans) == pick(jspans)
    assert len(pick(tspans)) == tstats.spec_stats["spec_launches"] > 0
    drop_rate = lambda d: {k: v for k, v in d.items() if k != "emitted_tokens_per_s"}
    summary = tanalysis.spec_decode_summary(tspans)
    assert drop_rate(summary) == drop_rate(janalysis.spec_decode_summary(jspans))
    assert summary["draft_proposed"] == tstats.spec_stats["draft_proposed"]
    assert [r.tokens.tolist() for r in tstats.results] == [r.tokens.tolist()
                                                           for r in jstats.results]


# ---------------------------------------------------------------------------
# the LM head of a bf16 model on the CPU
# ---------------------------------------------------------------------------
def test_bf16_logits_on_cpu_are_the_float32_product():
    cfg = get_config("gemma2-27b", reduced=True)      # logit softcap 30
    assert cfg.logit_softcap > 0
    model = DecoderLM(cfg, device="cpu", dtype=torch.bfloat16)
    params = model.init(seed=0)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    got = model._logits(params, x)
    h = model._norm(x, params["final_norm"])
    head = params["embed"].T
    exact = h.float() @ head.float()
    want = cfg.logit_softcap * torch.tanh(exact / cfg.logit_softcap)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the product rounded to bf16 before the softcap is what this replaced
    rounded = (h @ head).float()
    rounded = cfg.logit_softcap * torch.tanh(rounded / cfg.logit_softcap)
    assert float((rounded - want).abs().max()) > 1e-3


def test_bf16_logits_on_cpu_match_the_jax_head():
    """The same bf16 weights and activations through the reference's head
    (bf16 operands, preferred_element_type=float32, then the softcap): the
    port's logits agree far inside what a bf16-rounded product misses by."""
    import jax.numpy as jnp

    jcfg = jax_get_config("gemma2-27b", reduced=True)
    jmodel = build_model(jcfg, compute_dtype=jnp.bfloat16)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jmodel.init(jax.random.PRNGKey(0)))
    cfg = get_config("gemma2-27b", reduced=True)
    model = DecoderLM(cfg, device="cpu", dtype=torch.bfloat16)
    params = from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.bfloat16)
    x = np.random.default_rng(0).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    got = model._logits(params, torch.from_numpy(x).to(torch.bfloat16))
    want = torch.from_numpy(np.asarray(jmodel._logits(jparams, jnp.asarray(x, jnp.bfloat16))))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    h = model._norm(torch.from_numpy(x).to(torch.bfloat16), params["final_norm"])
    rounded = (h @ params["embed"].T).float()
    rounded = cfg.logit_softcap * torch.tanh(rounded / cfg.logit_softcap)
    assert float((rounded - want).abs().max()) > 1e-3


def test_bf16_logits_sliced_head_equal_whole(monkeypatch):
    """The head taken a vocabulary slice at a time gives the whole product."""
    from repro_torch.models import lm

    model = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu", dtype=torch.bfloat16)
    params = model.init(seed=1)
    x = torch.randn(3, 1, model.cfg.d_model, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    whole = model._logits(params, x)
    monkeypatch.setattr(lm, "_HEAD_SLICE", 48)           # 256 = 5 slices of 48 + 16
    torch.testing.assert_close(model._logits(params, x), whole, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
BASE = ["--device", "cpu", "--requests", "6", "--prompt-len", "20", "--max-new-tokens", "4",
        "--engine-batch", "3", "--page-size", "4", "--max-seq", "32"]


def _lines(out):
    return {ln.split()[1]: ln.split()[2] for ln in out.splitlines()
            if ln.startswith("[serve]   ") and len(ln.split()) == 3}


def test_driver_prefix_workload_chunked(capsys):
    assert tlaunch.main(BASE + ["--mode", "paged", "--prefix-len", "12", "--prefix-share",
                                "1.0", "--prefill-mode", "chunked", "--prefill-chunk",
                                "8"]) == 0
    out = capsys.readouterr().out
    for title in ("page occupancy", "prefix cache", "multi-tenant SLO"):
        assert f"[serve] {title}:" in out
    assert "[serve] prefill saturation:" not in out        # no packed launch
    m = _lines(out)
    assert int(m["saved_prefill_tokens"]) > 0
    assert int(m["prompt_tokens_admitted"]) == 6 * 20


def test_driver_prefix_cache_off_and_groups(capsys):
    assert tlaunch.main(BASE + ["--prefix-len", "8", "--prefix-groups", "2",
                                "--prefix-cache", "off", "--spec-k", "2",
                                "--spec-ngram", "1"]) == 0
    out = capsys.readouterr().out
    assert "[serve] prefix cache:" not in out
    assert "[serve] prefill saturation:" in out
    assert int(_lines(out)["saved_prefill_tokens"]) == 0


def test_driver_overcommit_preempts(capsys):
    assert tlaunch.main(BASE + ["--prompt-len-min", "8", "--max-new-tokens", "10",
                                "--num-pages", "9", "--overcommit", "10"]) == 0
    m = _lines(capsys.readouterr().out)
    assert int(m["preemptions"]) > 0 and int(m["completed"]) == 6


def test_driver_tenants_and_deadline(capsys):
    assert tlaunch.main(BASE + [
        "--tenants", "prem,prio=premium,weight=2,slo=5000;best,prio=0,rate=400,burst=40,"
                     "prompt=10", "--deadline-ms", "60000", "--slo-ms", "4000",
        "--fairness", "on"]) == 0
    out = capsys.readouterr().out
    assert "[serve] multi-tenant SLO:" in out
    assert "prem_completed" in out and "best_completed" in out
    assert _lines(out)["goodput"] == "1.00"


def test_driver_priority_mix_and_fairness_off(capsys):
    assert tlaunch.main(BASE + ["--priority-mix", "best_effort=0.5,premium=0.5",
                                "--fairness", "off"]) == 0
    assert int(_lines(capsys.readouterr().out)["completed"]) == 6


@pytest.mark.parametrize("argv,match", [
    (["--prefix-len", "20"], "must be smaller than --prompt-len"),
    (["--engine", "static", "--tenants", "a"], "requires --engine paged"),
    (["--tenants", "a,colour=red"], "unknown tenant key"),
    (["--tenants", "a,weight=heavy"], "bad tenant value"),
    (["--priority-mix", "premium=lots"], "bad --priority-mix"),
])
def test_driver_validates_new_flags(capsys, argv, match):
    with pytest.raises(SystemExit):
        tlaunch.main(BASE + argv)
    assert match in capsys.readouterr().err


def test_parsers_match_the_reference():
    from repro.launch import serve as jlaunch

    s = "prem,prio=2,weight=2,hz=20,slo=300;best,prio=best_effort,rate=400,burst=120,gen=3"
    assert tlaunch._parse_tenants(s) == jlaunch._parse_tenants(s)
    mix = "best_effort=0.25,standard=0.5,premium=0.25"
    assert tlaunch._parse_priority_mix(mix) == jlaunch._parse_priority_mix(mix)
