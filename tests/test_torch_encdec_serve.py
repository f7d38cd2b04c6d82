"""The enc-dec family (whisper-large-v3, reduced) through the port's
serving entry points against the JAX package: ``generate(extra_inputs=
{"frames": ...})`` greedy tokens against the JAX engine's, at
``encoder_seq`` 16 and 20; the continuous and paged engines' refusals;
the driver's static engine (zero frames, as the reference driver feeds
them) and its refusals; the torch predictor's logits against the JAX
predictor's on the JAX weights; the published config's shapes.

Weights come from the JAX model's ``init`` through ``from_jax`` (the norm
weights perturbed, ``test_torch_encdec._np_params``); prompts and frames
from numpy with fixed seeds.  Tokens are held equal; the predictor's
float32 logits within 1e-4 (rtol and atol: summation order of the matrix
products, as in ``tests/test_torch_platform.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import NullTracer as RefNullTracer
from repro.core import OpenRequest as RefOpenRequest
from repro.core import make_predictor as ref_make_predictor
from repro.core.platform import builtin_manifests as ref_manifests
from repro.models import build_model as jax_build_model
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.core import NullTracer, OpenRequest, Tracer, TraceLevel, TracingServer
from repro_torch.core import make_predictor
from repro_torch.core.platform import builtin_manifests
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model, from_jax, lm
from repro_torch.serve import engine as teng
from test_torch_encdec import _np_params

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-large-v3"
MAX_SEQ = 32


@pytest.fixture(scope="module", params=(16, 20), ids=lambda s: f"Se{s}")
def engines(request):
    cfg = jax_get_config(ARCH, reduced=True).replace(encoder_seq=request.param)
    jmodel = jax_build_model(cfg, backend="flash")
    np_params = _np_params(jmodel)
    jengine = jeng.ServingEngine(jmodel, jax.tree.map(jnp.asarray, np_params), max_batch=3,
                                 max_seq=MAX_SEQ)
    tengine = teng.ServingEngine(build_model(cfg, device="cpu"), from_jax(np_params),
                                 max_batch=3, max_seq=MAX_SEQ, device="cpu")
    return cfg, jengine, tengine


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).normal(size=(b, cfg.encoder_seq, cfg.d_model)
                                              ).astype(np.float32)


@pytest.mark.parametrize("lens,new,seed", [
    ((3, 11, 7), 5, 5),                  # right-padded to 16, decoded at per-row positions
    ((9, 9), 6, 7),                      # one length: one shared position
    ((14,), 8, 8),
])
def test_generate_tokens_equal_jax(engines, lens, new, seed):
    cfg, jengine, tengine = engines
    prompts = _prompts(cfg, lens, seed)
    frames = _frames(cfg, len(lens), seed)
    want = jengine.generate(prompts, max_new_tokens=new, extra_inputs={"frames": frames})
    got = tengine.generate(prompts, max_new_tokens=new, extra_inputs={"frames": frames})
    assert len(np.unique(want.tokens)) > 1          # a comparison that can fail
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens_per_s > 0 and got.prefill_s > 0
    # frames given as a tensor take the same path
    again = tengine.generate(prompts, max_new_tokens=new,
                             extra_inputs={"frames": torch.from_numpy(frames)})
    np.testing.assert_array_equal(again.tokens, want.tokens)


def test_generate_reads_the_frames(engines):
    """Other frames, other first-token logits: the cross-attention reads the
    encoder output of the frames ``extra_inputs`` carries."""
    cfg, _, tengine = engines
    prompts = _prompts(cfg, (6, 6), 3)
    seen = []
    real = tengine.model.prefill

    def spy(params, batch, cache):
        out = real(params, batch, cache)
        seen.append((batch["frames"].dtype, out))
        return out

    tengine.model.prefill = spy
    try:
        for seed in (1, 2):
            tengine.generate(prompts, 1, extra_inputs={"frames": _frames(cfg, 2, seed)})
    finally:
        del tengine.model.prefill
    assert [d for d, _ in seen] == [tengine.model.dtype] * 2
    assert not torch.allclose(seen[0][1], seen[1][1])


def test_continuous_and_paged_engines_refuse_the_family(engines):
    cfg, jengine, tengine = engines
    reqs = lambda mod: [mod.ServeRequest(request_id=0, prompt=_prompts(cfg, (4,), 1)[0],
                                         max_new_tokens=2)]
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        jengine.serve_continuous(reqs(jeng))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tengine.serve_continuous(reqs(teng))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tengine.serve_paged(reqs(teng))
    # no requests: the empty result, as the reference returns it first
    assert tengine.serve_continuous([]).total_tokens == jengine.serve_continuous([]).total_tokens


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def test_driver_serves_whisper_static_on_cpu(capsys, monkeypatch):
    """Every batch gets zero frames of (batch, encoder_seq, d_model)."""
    seen = []
    real = teng.ServingEngine.generate

    def spy(self, prompts, max_new_tokens, extra_inputs=None, greedy=True):
        seen.append((len(prompts), np.asarray(extra_inputs["frames"])))
        return real(self, prompts, max_new_tokens, extra_inputs=extra_inputs)

    monkeypatch.setattr(teng.ServingEngine, "generate", spy)
    assert tlaunch.main([
        "--arch", ARCH, "--device", "cpu", "--engine", "static", "--requests", "5",
        "--prompt-len", "12", "--prompt-len-min", "3", "--max-new-tokens", "4",
        "--engine-batch", "3", "--max-seq", "32", "--rate-hz", "200",
    ]) == 0
    out = capsys.readouterr().out
    assert "whisper-large-v3-reduced on cpu" in out and "engine static" in out
    assert "generated_tokens     20" in out
    cfg = get_config(ARCH, reduced=True)
    assert sum(b for b, _ in seen) == 5
    for b, frames in seen:
        assert frames.shape == (b, cfg.encoder_seq, cfg.d_model) and not frames.any()


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_driver_refuses_the_continuous_and_paged_engines(engine):
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tlaunch.main(["--arch", ARCH, "--device", "cpu", "--engine", engine])


# ---------------------------------------------------------------------------
# the predictor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,seq_len", [("ref", 12), ("pallas", 16)])
def test_torch_predictor_matches_the_jax_predictor(backend, seq_len):
    """The JAX predictor (``pallas``: its Pallas kernels in interpret mode)
    and the torch one on the same tokens with zero frames, the torch
    handle's weights swapped for the JAX handle's; the FRAMEWORK path
    gives the MODEL path's bits."""
    ref_manifest = next(m for m in ref_manifests(reduced=True) if m.name == ARCH)
    port_manifest = next(m for m in builtin_manifests(reduced=True) if m.name == ARCH)
    assert port_manifest.to_dict() == ref_manifest.to_dict()
    jpred, tpred = ref_make_predictor(backend), make_predictor("torch")
    jh = jpred.open(RefOpenRequest(manifest=ref_manifest, backend=backend, seq_len=seq_len),
                    RefNullTracer())
    th = tpred.open(OpenRequest(manifest=port_manifest, seq_len=seq_len, device="cpu"),
                    NullTracer())
    assert isinstance(th.state["model"], lm.EncDecLM)
    rng = np.random.default_rng(4)
    np_params = jax.tree.map(np.asarray, jh.state["params"])
    np_params["final_norm"] = (0.1 * rng.normal(size=np_params["final_norm"].shape)
                               ).astype(np.float32)
    jh.state["params"] = jax.tree.map(jnp.asarray, np_params)
    th.state["params"] = from_jax(np_params)
    tokens = rng.integers(0, 256, (2, seq_len)).astype(np.int32)
    want = np.asarray(jpred.predict(jh, tokens, RefNullTracer()))
    got = tpred.predict(th, tokens, NullTracer())
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    tracer = Tracer("t", TracingServer(), TraceLevel.FRAMEWORK)
    assert np.array_equal(tpred.predict(th, tokens, tracer), got)
    tpred.close(th)


# ---------------------------------------------------------------------------
# the published config
# ---------------------------------------------------------------------------
def test_full_config_fits_one_card_with_a_padded_cross_cache():
    """whisper-large-v3 at published width: 32 + 32 layers, 20 heads of 64
    (MHA), 1500 frames in a cross cache of 1504 slots, and weights far
    under one 80 GB card."""
    cfg = get_config(ARCH)
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.encoder_seq) == \
        (32, 32, 1280, 20, 20, 64, 5120, 1500)
    assert lm.weights_fit(cfg, torch.bfloat16, 80 * 10**9) is None
    model = build_model(cfg.replace(num_layers=2, encoder_layers=1), device="cpu",
                        dtype=torch.bfloat16)
    defs = model.cache_defs(8, 2048)
    assert defs["k"] == (2, 8, 2048, 20, 64) and defs["k_cross"] == (2, 8, 1504, 20, 64)
    assert model.cross_len == 1504 and model.cross_len % 16 == 0
