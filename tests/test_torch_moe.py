"""The MoE family in the port's model against the JAX package.

``moe_apply`` against the reference's ``moe_apply`` on the same inputs and
weights (numpy, from a seed): one row and several, one token and many, a
capacity factor low enough that the JAX side drops slots (the test counts
them and needs more than zero), router columns duplicated so that top-k
meets exact ties, and rows whose tail is padding.  Outputs and the
auxiliary loss agree to 1e-5 in float32 (the summation order differs); the
rank of each slot within its expert exactly.  Then reduced qwen3-moe-30b-a3b
(128 experts cut to 8, top 2, QK-norm) and llama4-maverick-400b-a17b (dense
and MoE layers interleaved) against ``build_model(cfg, backend="flash")``
on weights bridged with ``from_jax``, every norm perturbed from its zero
init: ``forward`` logits and aux, ``forward_instrumented``'s names and
logits, prefill then decode with the whole dense cache, at the configs'
capacity factor and at one that drops.  Logits agree to 1e-4, caches to
5e-5 (float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.models import modules as jmod
from repro_torch.configs import get_config
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models import modules as tmod
from repro_torch.models.config import ArchConfig
from test_torch_zoo_serve import perturb_norms

MOE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=5e-5, atol=5e-5)
ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
# a capacity factor at which reduced qwen3 (8 experts, top 2) drops slots
DROPPING_CF = 0.5


def _port_cfg(cfg):
    """The port's copy of a reference config, field for field."""
    return ArchConfig(**dataclasses.asdict(cfg))


def _cfg(cf=None, arch="qwen3-moe-30b-a3b"):
    cfg = jax_get_config(arch, reduced=True)
    return cfg if cf is None else cfg.replace(capacity_factor=cf)


def _weights(cfg, rng):
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": rng.normal(0, 0.3, (D, E)).astype(np.float32),
            "w_gate": rng.normal(0, 0.2, (E, D, F)).astype(np.float32),
            "w_up": rng.normal(0, 0.2, (E, D, F)).astype(np.float32),
            "w_down": rng.normal(0, 0.2, (E, F, D)).astype(np.float32)}


def _dropped(p, x, cfg):
    """The slots (b, s, k) that the JAX routing drops: rank within the
    expert at or past C."""
    b, s, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = min(max(int(cfg.capacity_factor * s * K / E), 1), s * K)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(p["router"])))
    _, idx = jax.lax.top_k(probs, K)
    eid = idx.reshape(b, s * K).astype(jnp.int32)
    pos = jax.vmap(lambda e: jmod._positions_in_expert(e, E))(eid)
    return (np.asarray(pos) >= C).reshape(b, s, K)


def _hold(p, x, cfg):
    """The port's moe_apply against the reference's on the same numpy
    inputs; returns the slots the reference drops, (b, s, k)."""
    want, want_aux = jmod.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, aux = tmod.moe_apply(tp, torch.from_numpy(x), _port_cfg(cfg))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)
    return _dropped(p, x, cfg)


def test_config_copies_match_the_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            port, ref = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            for active in (False, True):
                assert port.param_count(active) == ref.param_count(active)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 8, 16, 17, 64, 2048])
@pytest.mark.parametrize("arch,reduced", [(a, r) for a in ARCHS for r in (False, True)])
def test_capacity_is_the_reference_formula(arch, reduced, s):
    cfg = get_config(arch, reduced=reduced)
    E, K = cfg.num_experts, cfg.experts_per_token
    for cf in (cfg.capacity_factor, DROPPING_CF, 0.01, 8.0):
        want = min(max(int(cf * s * K / E), 1), s * K)
        assert tmod.moe_capacity(cfg.replace(capacity_factor=cf), s) == want


@pytest.mark.parametrize("b,n,E", [(1, 1, 8), (1, 33, 8), (3, 40, 8), (2, 256, 128)])
def test_positions_in_expert_match_the_reference(b, n, E):
    eid = np.random.default_rng(n).integers(0, E, (b, n)).astype(np.int32)
    want = np.stack([np.asarray(jmod._positions_in_expert(jnp.asarray(e), E)) for e in eid])
    got = tmod._positions_in_expert(torch.from_numpy(eid).long(), E)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,s", [(1, 1), (4, 1), (1, 16), (3, 12), (2, 40)])
@pytest.mark.parametrize("cf", [2.0, DROPPING_CF])
def test_moe_apply_matches_the_reference(b, s, cf):
    cfg = _cfg(cf)
    rng = np.random.default_rng(100 * b + s)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    dropped = _hold(_weights(cfg, rng), x, cfg).sum()
    if cf == DROPPING_CF and s > 1:
        assert dropped > 0, "the case must drop slots on the JAX side"
    if s == 1:
        assert dropped == 0            # one token: top-k experts are distinct, C >= 1


def test_moe_apply_drops_at_qwen3_routing():
    """128 experts, top 8, cf 1.25 (the full config's routing at a narrow
    width): a group of 64 tokens has C 5 and drops slots."""
    cfg = jax_get_config("qwen3-moe-30b-a3b", reduced=True).replace(
        num_experts=128, experts_per_token=8, capacity_factor=1.25)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    p = _weights(cfg, rng)
    p["router"] *= 4.0                 # peaked routing: popular experts overflow
    assert _hold(p, x, cfg).sum() > 0


def test_moe_apply_breaks_top_k_ties_to_the_lower_expert():
    """Three router columns equal, inputs on a grid so every logit is
    exact in float32: the three tie on each token, and where they lead,
    top 2 must keep the lower two indices, as ``jax.lax.top_k`` does."""
    cfg = _cfg(8.0)
    rng = np.random.default_rng(11)
    p = _weights(cfg, rng)
    grid = lambda shape: (rng.integers(-4, 5, shape) / 4).astype(np.float32)
    p["router"] = grid(p["router"].shape)
    p["router"][:, 3] = p["router"][:, 5] = p["router"][:, 6]
    x = grid((2, 24, cfg.d_model))
    logits = x @ p["router"]
    assert (logits[..., 3] == logits[..., 5]).all() and (logits[..., 5] == logits[..., 6]).all()
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), cfg.experts_per_token)
    idx = np.asarray(idx)
    leading = (logits[..., 6] > np.delete(logits, [3, 5, 6], axis=-1).max(-1))
    assert leading.sum() > 3, "ties must decide the routing of some tokens"
    assert (np.sort(idx[leading], -1) == [3, 5]).all()
    q = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_array_equal(tmod.moe_route(q, torch.from_numpy(x), _port_cfg(cfg))[2].numpy(),
                                  idx)
    _hold(p, x, cfg)
    # the experts differ, so picking 6 over 5 would move the output
    swapped = dict(q, w_up=q["w_up"][[0, 1, 2, 3, 4, 6, 5, 7]])
    tcfg = _port_cfg(cfg)
    a = tmod.moe_apply(q, torch.from_numpy(x), tcfg)[0]
    b = tmod.moe_apply(swapped, torch.from_numpy(x), tcfg)[0]
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("cf", [2.0, DROPPING_CF])
def test_moe_apply_padded_rows(cf):
    """Rows of 7, 12 and 16 real tokens right-padded to 16 with one pad
    embedding, so every pad routes to the same experts and overflows them:
    the port equals the reference, drops included.  Pads queue behind the
    real tokens of their row (a stable rank), so at the config's capacity
    factor only pads are dropped; at the low one real tokens are too."""
    cfg = _cfg(cf)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 16, cfg.d_model)).astype(np.float32)
    pad = rng.normal(size=(cfg.d_model,)).astype(np.float32)
    real = np.zeros((3, 16), bool)
    for row, n in enumerate((7, 12, 16)):
        x[row, n:] = pad
        real[row, :n] = True
    dropped = _hold(_weights(cfg, rng), x, cfg)
    assert dropped[~real].sum() > 0
    assert (dropped[real].sum() > 0) == (cf == DROPPING_CF)


def test_moe_apply_aux_loss_is_the_switch_loss():
    """Uniform routing gives the Switch loss its minimum of 1."""
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    p = {k: torch.from_numpy(v) for k, v in _weights(cfg, np.random.default_rng(0)).items()}
    p["router"].zero_()
    x = torch.randn(2, 8, cfg.d_model)
    _, aux = tmod.moe_apply(p, x, cfg)
    assert aux.dtype == torch.float32 and float(aux) == pytest.approx(1.0, abs=1e-6)
    assert tmod.moe_apply(p, x, cfg, need_aux=False)[1] is None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[(a, cf) for a in ARCHS for cf in (None, DROPPING_CF)],
                ids=lambda p: f"{p[0]}-cf{p[1] or 'config'}")
def models(request):
    arch, cf = request.param
    cfg = _cfg(cf, arch)
    jmodel = build_model(cfg, backend="flash")
    np_params = perturb_norms(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                              np.random.default_rng(0))
    tmodel = DecoderLM(_port_cfg(cfg), device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, np_params), tmodel, from_jax(np_params)


def test_param_layout_matches_from_jax(models):
    _, _, tmodel, tparams = models
    cfg = tmodel.cfg
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(tmodel.init(seed=0)) == shapes(tparams)
    if tmodel.interleaved:
        assert len(tparams["blocks"]) == cfg.num_layers // 2
        pair = tparams["blocks"][0]
        assert tuple(pair["a"]["mlp"]["w_up"].shape) == (cfg.d_model, cfg.dense_d_ff)
        assert tuple(pair["b"]["mlp"]["w_up"].shape) == (cfg.num_experts, cfg.d_model, cfg.d_ff)
        assert tmodel.CACHE_BATCH_AXIS == {"pos": 0, "k": 2, "v": 2}
    else:
        assert len(tparams["blocks"]) == cfg.num_layers
        assert "router" in tparams["blocks"][1]["mlp"]
        assert tmodel.CACHE_BATCH_AXIS == {"pos": 0, "k": 1, "v": 1}


def test_forward_logits_and_aux_match_jax(models):
    jmodel, jparams, tmodel, tparams = models
    tokens = np.random.default_rng(4).integers(0, tmodel.cfg.vocab_size, (2, 21)).astype(np.int32)
    lj, aux_j = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    lt, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and lt.shape == (2, 21, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)


def test_forward_instrumented_names_and_logits(models):
    """The reference's piece names (``layer_000_dense``/``layer_001_moe``
    for the interleaved pairs, ``layer_{l}_attn`` otherwise) and
    ``forward``'s logits bit for bit."""
    jmodel, jparams, tmodel, tparams = models
    tokens = np.random.default_rng(6).integers(0, tmodel.cfg.vocab_size, (2, 9)).astype(np.int32)
    names_j, names_t = [], []

    def jhook(name, thunk):
        names_j.append(name)
        return thunk()

    def thook(name, thunk):
        names_t.append(name)
        return thunk()

    from repro.models.lm import _forward_instrumented_decoder

    want = _forward_instrumented_decoder(jmodel, jparams, {"tokens": jnp.asarray(tokens)}, jhook)
    batch = {"tokens": torch.from_numpy(tokens)}
    got = tmodel.forward_instrumented(tparams, batch, thook)
    assert names_t == names_j
    if tmodel.interleaved:
        assert names_t[1:3] == ["layer_000_dense", "layer_001_moe"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert torch.equal(got, tmodel.forward(tparams, batch)[0])


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_then_decode_matches_jax(models, ragged):
    """A right-padded (or one-length) prefill, then four decode steps:
    logits and the whole dense cache agree at every step (the interleaved
    cache is (L/2, 2, b, S, kv, d) on both sides)."""
    jmodel, jparams, tmodel, tparams = models
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
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
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


def test_bf16_model_runs_on_the_cpu():
    """A bf16 model (the card's dtype) runs forward and a decode step on
    the CPU: finite float32 logits; the MoE output keeps the activation
    dtype."""
    for arch in ARCHS:
        model = DecoderLM(get_config(arch, reduced=True), device="cpu", dtype=torch.bfloat16)
        params = model.init(seed=1)
        tokens = torch.randint(0, model.cfg.vocab_size, (2, 10), dtype=torch.int32)
        logits, aux = model.forward(params, {"tokens": tokens})
        assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
        assert aux.dtype == torch.float32
        blk = params["blocks"][0]["b" if model.interleaved else "mlp"]
        moe = blk["mlp"] if model.interleaved else blk
        out, _ = tmod.moe_apply(moe, torch.randn(2, 5, model.cfg.d_model, dtype=torch.bfloat16),
                                model.cfg)
        assert out.dtype == torch.bfloat16
        cache = model.init_cache(2, 16)
        model.prefill(params, {"tokens": tokens}, cache)
        step = model.decode(params, tokens[:, 0], cache)
        assert step.dtype == torch.float32 and bool(torch.isfinite(step).all())


def test_interleaved_paged_paths_refuse_with_the_reference_words():
    """llama4's interleaved layout has no paged form: the pool and each
    paged path raise the reference's words."""
    from repro_torch.models.lm import NOT_PAGED

    cfg = jax_get_config("llama4-maverick-400b-a17b", reduced=True)
    jmodel = build_model(cfg)
    tmodel = DecoderLM(get_config("llama4-maverick-400b-a17b", reduced=True), device="cpu")
    params = tmodel.init()
    with pytest.raises(NotImplementedError) as jerr:
        jmodel.paged_cache_defs(8, 4)
    assert str(jerr.value) == NOT_PAGED
    with pytest.raises(NotImplementedError, match=NOT_PAGED.replace("(", r"\(").replace(")", r"\)")):
        tmodel.init_paged_cache(8, 4)
    tok = torch.zeros(1, dtype=torch.int32)
    table = torch.zeros((1, 4), dtype=torch.int32)
    calls = {
        "decode_paged": (lambda: jmodel.decode_paged(None, None, {}, None, None),
                         lambda: tmodel.decode_paged(params, tok, {}, table, tok)),
        "decode_spec": (lambda: jmodel.decode_spec(None, None, {}, None, None, None),
                        lambda: tmodel.decode_spec(params, tok[None], {}, table, tok, tok)),
        "prefill_paged_chunk": (
            lambda: jmodel.prefill_paged_chunk(None, jnp.zeros((1, 4), jnp.int32), {}, None, 0,
                                               0),
            lambda: tmodel.prefill_paged_chunk(params, tok[None], {}, table[0], 0, 0)),
        "prefill_packed": (lambda: jmodel.prefill_packed(None, {"tokens": None}, {}),
                           lambda: tmodel.prefill_packed(params, {"tokens": tok[None]}, {})),
    }
    for name, (jcall, tcall) in calls.items():
        with pytest.raises(NotImplementedError) as jerr:
            jcall()
        with pytest.raises(NotImplementedError) as terr:
            tcall()
        assert str(terr.value) == str(jerr.value), name
        assert "(non-interleaved) only" in str(terr.value)
