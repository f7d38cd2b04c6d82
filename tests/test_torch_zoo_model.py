"""The rest of the dense family in the port's model, against the JAX model on
the same weights.

Reduced gemma2-27b, chameleon-34b, granite-20b and deepseek-67b; the JAX
model runs its Pallas kernels in interpret mode (``backend="pallas"``), and
its weights, every norm perturbed from its zero init, reach the port
through ``from_jax``.  Logits agree to 1e-4 and caches to 5e-5 in float32
(the summation order differs).  Also: ``from_jax`` carries QK-norm and
post-norm weights by name, the two encodings of a global layer's window (0
and the reference's ``1 << 30``) give the same bits on every plain
attention path, gemma2's window bites at these lengths, and the embedding
scale is rounded to the model dtype as the reference rounds it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models.lm import GLOBAL_WINDOW
from test_torch_zoo_serve import ARCHS, perturb_norms

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg = jax_get_config(request.param, reduced=True)
    jmodel = build_model(cfg, backend="pallas")
    np_params = perturb_norms(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                              np.random.default_rng(0))
    tmodel = DecoderLM(get_config(request.param, reduced=True), device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, np_params), tmodel, from_jax(np_params), np_params


def test_forward_matches_jax(models):
    jmodel, jparams, tmodel, tparams, _ = models
    tokens = np.random.default_rng(4).integers(0, tmodel.cfg.vocab_size, (2, 21)).astype(np.int32)
    lj, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    lt, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and lt.shape == (2, 21, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert float(aux) == 0.0
    if tmodel.cfg.logit_softcap > 0:
        assert float(lt.abs().max()) < tmodel.cfg.logit_softcap


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_then_decode_matches_jax(models, ragged):
    """A prefill of prompts past gemma2's window (right-padded to 24 with
    lengths, or of one length), then four decode steps (per-row positions
    with a kv bound, or one shared position): logits and the whole dense
    cache agree at every step."""
    jmodel, jparams, tmodel, tparams, _ = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    lens = np.asarray((5, 19, 12) if ragged else (14, 14, 14), np.int32)
    tokens = np.zeros((3, 24 if ragged else 14), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    batch_j, batch_t = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if ragged:
        batch_j["lengths"], batch_t["lengths"] = jnp.asarray(lens), torch.from_numpy(lens)
    S = 32
    lj, jcache = jmodel.prefill(jparams, batch_j, jmodel.init_cache(3, S, dtype="float32"))
    tcache = tmodel.init_cache(3, S)
    lt = tmodel.prefill(tparams, batch_t, tcache)

    def hold(lj, lt):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **CACHE_TOL)

    hold(lj, lt)
    nxt = np.asarray(lj).argmax(-1).astype(np.int32)
    bound = 32 if ragged else None
    for _ in range(4):
        lj, jcache = jmodel.decode(jparams, jnp.asarray(nxt), jcache, uniform_pos=not ragged,
                                   kv_bound=bound)
        lt = tmodel.decode(tparams, torch.from_numpy(nxt), tcache, uniform_pos=not ragged,
                           kv_bound=bound)
        hold(lj, lt)
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)


def test_from_jax_carries_qk_norm_and_post_norms(models):
    jmodel, _, tmodel, tparams, np_params = models
    cfg = tmodel.cfg
    fresh = tmodel.init(seed=0)
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(fresh) == shapes(tparams)
    blk = tparams["blocks"][1]
    assert ("q_norm" in blk["attn"]) == ("k_norm" in blk["attn"]) == cfg.qk_norm
    assert ("post_attn_norm" in blk) == ("post_mlp_norm" in blk) == cfg.post_norms
    named = [("attn", "q_norm"), ("attn", "k_norm")] * cfg.qk_norm + \
        [("post_attn_norm",), ("post_mlp_norm",)] * cfg.post_norms
    for path in named:
        got, want = blk, np_params["blocks"]
        for key in path:
            got, want = got[key], want[key]
        assert tuple(got.shape) == ((cfg.resolved_head_dim,) if "attn" in path else (cfg.d_model,))
        np.testing.assert_array_equal(got.numpy(), want[1])
        assert np.abs(want[1]).max() > 0               # perturbed: the test sees the weight
    assert len(named) == 2 * (cfg.qk_norm + cfg.post_norms)


def _attention_cases(window):
    """Each plain attention path of the kernels on one set of inputs, at a
    given window: dense, one-token over a dense cache and over pages, a
    speculative window over pages, and a packed prefill chunk over context
    pages.  Contexts of 40 keys, far past the 8 of reduced gemma2."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    h, kvh, d, ps = 4, 2, 16, 4
    q, k, v = r(2, 40, h, d), r(2, 40, kvh, d), r(2, 40, kvh, d)
    kp, vp = r(24, ps, kvh, d), r(24, ps, kvh, d)
    table = torch.arange(1, 21, dtype=torch.int32).view(2, 10)
    lens = torch.tensor([37, 23], dtype=torch.int32)
    wl = torch.tensor([3, 2], dtype=torch.int32)
    qp = r(8, h, d)
    kv8 = r(8, kvh, d)
    return {
        "attention": ref.attention(q, k, v, window=window, softcap=50.0),
        "decode_attention": ref.decode_attention(q[:, :1], k, v, lens, window=window,
                                                 softcap=50.0),
        "paged_attention": ref.paged_attention(q[:, :1], kp, vp, table, lens, window=window,
                                               softcap=50.0),
        "spec_verify": ref.spec_verify(q[:, :3], kp, vp, table, lens, wl, window=window,
                                       softcap=50.0),
        "varlen_prefill": ref.varlen_prefill(
            qp, kv8, kv8.clone(), kp, vp, torch.tensor([0, 8], dtype=torch.int32),
            torch.tensor([7], dtype=torch.int32), torch.tensor([32], dtype=torch.int32),
            table[:1], window=window, softcap=50.0),
    }


@pytest.mark.parametrize("path", ["attention", "decode_attention", "paged_attention",
                                  "spec_verify", "varlen_prefill"])
def test_global_window_encodings_give_the_same_bits(path):
    none, zero, big = (_attention_cases(w)[path] for w in (None, 0, GLOBAL_WINDOW))
    assert torch.equal(zero, none) and torch.equal(big, none)
    assert not torch.equal(_attention_cases(8)[path], none)     # a real window bites


def test_gemma2_layers_alternate_windows_that_bite():
    cfg = get_config("gemma2-27b", reduced=True)
    model = DecoderLM(cfg, device="cpu")
    assert model.windows == [8, GLOBAL_WINDOW] * 2
    assert DecoderLM(get_config("gemma2-27b"), device="cpu").windows == \
        [4096, GLOBAL_WINDOW] * 23
    assert DecoderLM(get_config("granite-20b", reduced=True), device="cpu").windows == [None] * 3
    params = model.init(seed=0)
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 21)))}
    want = model.forward(params, tokens)[0]
    model.windows = [0 if w == GLOBAL_WINDOW else w for w in model.windows]
    assert torch.equal(model.forward(params, tokens)[0], want)
    model.windows = [None] * cfg.num_layers
    assert not torch.allclose(model.forward(params, tokens)[0], want, **LOGIT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_scale_is_rounded_to_the_model_dtype(dtype):
    """The reference scales the cast embedding by a weakly typed
    ``sqrt(d_model)``, which takes the embedding's dtype: 68 in bf16 at
    gemma2's 4608."""
    model = DecoderLM(get_config("gemma2-27b"), device="cpu", dtype=dtype)
    want = 68.0 if dtype == torch.bfloat16 else float(np.float32(math.sqrt(4608)))
    assert model._embed_scale == want
    embed = torch.randn(4, 4608).to(dtype)
    got = model._embed_tokens({"embed": embed}, torch.tensor([[2, 0]]))
    jx = jnp.take(jnp.asarray(embed.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), jnp.array([[2, 0]]), axis=0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray((jx * math.sqrt(4608)).astype(jnp.float32)))
    assert DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")._embed_scale is None


def test_full_width_weights_fit_one_card(monkeypatch, capsys):
    """The rule ``DecoderLM.init`` holds every entry point to on an 80 GB
    card: deepseek-67b's 125.6 GiB of bf16 weights run reduced only; the
    others fit.  ``init`` refuses before allocating, and the serve driver
    reports the refusal as a usage error."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    card = 80 * 10**9
    assert "runs reduced only" in lm.weights_fit(get_config("deepseek-67b"), torch.bfloat16, card)
    for arch in ("gemma2-27b", "chameleon-34b", "granite-20b", "glm4-9b"):
        assert lm.weights_fit(get_config(arch), torch.bfloat16, card) is None
    # a device too small for even the reduced weights
    monkeypatch.setattr(lm, "_device_memory", lambda device: 1024)
    with pytest.raises(MemoryError, match="runs reduced only"):
        DecoderLM(get_config("deepseek-67b", reduced=True), device="cpu").init()
    with pytest.raises(SystemExit):
        serve.main(["--arch", "deepseek-67b", "--device", "cpu", "--requests", "1"])
    assert "runs reduced only" in capsys.readouterr().err
