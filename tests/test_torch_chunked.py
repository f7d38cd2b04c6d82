"""Chunked prefill and preemption in the port against the JAX package.

``attn_prefill_paged`` against the JAX module (its flash attention through
the Pallas kernel in interpret mode) at chunk starts 0, 16 and 48, with
reduced gemma2-27b's window and softcap, on float32, int8 and fp8 pools
and on a bf16 model and pool;
``prefill_paged_chunk`` logits against the JAX model; ``serve_paged`` with
``prefill_mode="chunked"`` against the JAX engine and against the port's
packed run; ``overcommit`` on a pool cut so that preemption fires, with and
without speculation, against JAX and against an undisturbed run; and the
prompt-token ledger under preemption.  Module outputs agree to 5e-5, logits
to 1e-4 (float32; summation order differs), greedy tokens and counts
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import kvquant as jkvq
from repro.models import build_model
from repro.models import modules as jmod
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.kernels import kvquant
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models import modules as tmod
from repro_torch.serve import engine as teng

TOL = dict(rtol=5e-5, atol=5e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PS, MAX_PAGES, NUM_PAGES, CHUNK = 8, 10, 24, 16


# ---------------------------------------------------------------------------
# attn_prefill_paged and prefill_paged_chunk against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gemma():
    cfg = jax_get_config("gemma2-27b", reduced=True)
    jmodel = build_model(cfg, backend="pallas")
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = DecoderLM(get_config("gemma2-27b", reduced=True), device="cpu")
    return cfg, jmodel, jax.tree.map(jnp.asarray, np_params), tmodel, from_jax(np_params)


ROW = np.array([3, 7, 1, 9, 4, 12, 5, 2, 0, 0], np.int32)   # pages out of order


def _pool(tmodel, mode, seed):
    """One layer's K/V pools (and int8/fp8 scale pools) filled with random
    rows, quantized by the JAX package's own quantizer."""
    shape = tmodel.paged_cache_defs(NUM_PAGES, PS)["k_pages"][1:]
    rng = np.random.default_rng(seed)
    kv = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    if mode is None:
        return kv, None
    dt = jkvq.pool_dtype(mode)
    pairs = [jkvq.quantize(jnp.asarray(t), dt) for t in kv]
    codes = [np.asarray(q) for q, _ in pairs]
    scales = [np.asarray(s, np.float32) for _, s in pairs]
    return codes, scales


def _to_torch(a, mode):
    if mode == "fp8":
        return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.asarray(a).copy())


def _as_f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("pos0", [0, 16, 48])
@pytest.mark.parametrize("layer", [0, 1])       # gemma2: local (window 8), then global
def test_attn_prefill_paged_matches_jax(gemma, mode, pos0, layer):
    cfg, jmodel, jparams, tmodel, tparams = gemma
    (kp, vp), scales = _pool(tmodel, mode, seed=pos0 + layer)
    x = np.random.default_rng(pos0).normal(size=(1, CHUNK, cfg.d_model)).astype(np.float32)
    window = tmodel.windows[layer]
    p_j = jax.tree.map(lambda t: t[layer], jparams["blocks"]["attn"])
    kw_j = {} if scales is None else dict(k_scales=jnp.asarray(scales[0]),
                                           v_scales=jnp.asarray(scales[1]))
    out_j = jmod.attn_prefill_paged(p_j, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(ROW), pos0, cfg, backend="pallas",
                                    window=window, **kw_j)
    pools = [_to_torch(kp, mode), _to_torch(vp, mode)]
    kw_t = {} if scales is None else dict(k_scales=torch.from_numpy(scales[0].copy()),
                                          v_scales=torch.from_numpy(scales[1].copy()))
    y_t = tmod.attn_prefill_paged(tparams["blocks"][layer]["attn"], torch.from_numpy(x),
                                  *pools, torch.from_numpy(ROW), pos0, tmodel.cfg,
                                  window=window, **kw_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(out_j[0]), **LOGIT_TOL)
    # the chunk's rows land where JAX writes them; every other row is untouched
    rows = {(ROW[p // PS], p % PS) for p in range(pos0, pos0 + CHUNK)}
    got = [pools[0], pools[1]] + ([kw_t["k_scales"], kw_t["v_scales"]] if scales else [])
    for t, j, before in zip(got, out_j[1:], [kp, vp] + (scales or [])):
        t, j = _as_f32(t), np.asarray(j).astype(np.float32)
        for page in range(NUM_PAGES):
            for off in range(PS):
                if (page, off) in rows:
                    np.testing.assert_allclose(t[page, off], j[page, off], **TOL)
                else:
                    assert np.array_equal(t[page, off], np.asarray(before[page, off],
                                                                   np.float32))


@pytest.mark.parametrize("pos0", [0, 16, 48])
def test_attn_prefill_paged_bf16_matches_jax(gemma, pos0):
    """A bf16 model on a bf16 pool (the card's dtype): activations, weights
    and pools in bf16 in both packages, at bf16's tolerance (rounding and
    summation order differ); the local layer's window and the softcap."""
    cfg, jmodel, jparams, tmodel, tparams = gemma
    (kp, vp), _ = _pool(tmodel, None, seed=pos0 + 7)
    x = np.random.default_rng(pos0 + 7).normal(size=(1, CHUNK, cfg.d_model)).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    p_j = jax.tree.map(lambda t: t[0].astype(jnp.bfloat16), jparams["blocks"]["attn"])
    y_j, kp_j, vp_j = jmod.attn_prefill_paged(p_j, bf(x), bf(kp), bf(vp), jnp.asarray(ROW),
                                              pos0, cfg, backend="pallas",
                                              window=tmodel.windows[0])
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    p_t = {k: v.to(torch.bfloat16) for k, v in tparams["blocks"][0]["attn"].items()}
    pools = [tb(kp), tb(vp)]
    y_t = tmod.attn_prefill_paged(p_t, tb(x), *pools, torch.from_numpy(ROW), pos0, tmodel.cfg,
                                  window=tmodel.windows[0])
    assert y_t.dtype == torch.bfloat16
    BF16 = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32), **BF16)
    for t, j in zip(pools, (kp_j, vp_j)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **BF16)


def test_attn_prefill_paged_rejects_unaligned_start(gemma):
    cfg, _, _, tmodel, tparams = gemma
    (kp, vp), _ = _pool(tmodel, None, seed=0)
    with pytest.raises(ValueError, match="not page-aligned"):
        tmod.attn_prefill_paged(tparams["blocks"][0]["attn"], torch.zeros(1, 4, cfg.d_model),
                                torch.from_numpy(kp), torch.from_numpy(vp),
                                torch.from_numpy(ROW), 12, tmodel.cfg)


@pytest.mark.parametrize("pos0,last", [(0, 15), (16, 9), (48, 15)])
def test_prefill_paged_chunk_logits_match_jax(gemma, pos0, last):
    """The whole model at a chunk: float32 logits at ``last_index`` and the
    pools it leaves, equal to JAX's (windows on the local layers, softcaps,
    post-norms, the scaled embedding)."""
    cfg, jmodel, jparams, tmodel, tparams = gemma
    defs = tmodel.paged_cache_defs(NUM_PAGES, PS)
    rng = np.random.default_rng(pos0 + 1)
    pools = {k: rng.normal(size=shape).astype(np.float32) for k, shape in defs.items()}
    tokens = rng.integers(0, cfg.vocab_size, (1, CHUNK)).astype(np.int32)
    want, jcache = jmodel.prefill_paged_chunk(
        jparams, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.asarray(ROW), last, pos0)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    got = tmodel.prefill_paged_chunk(tparams, torch.from_numpy(tokens), tcache,
                                     torch.from_numpy(ROW), last, pos0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for k in pools:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **LOGIT_TOL)


def test_prefill_paged_chunk_refuses_ssm():
    model = DecoderLM(get_config("mamba2-130m", reduced=True), device="cpu")
    with pytest.raises(NotImplementedError, match="not paged"):
        model.prefill_paged_chunk(model.init(), torch.zeros(1, 4, dtype=torch.int32), {},
                                  torch.zeros(4, dtype=torch.int32), 3, 0)


# ---------------------------------------------------------------------------
# serve_paged: chunked prefill, preemption, the ledger
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    make = lambda max_seq: (jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=max_seq),
                            teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=max_seq,
                                               device="cpu"))
    return cfg, make(32), make(64)


def _requests(mod, cfg, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


def _tokens(stats):
    return {r.request_id: r.tokens.tolist() for r in stats.results}


def _ledger_exact(stats):
    assert stats.prompt_tokens_admitted == (
        stats.prefill_tokens + stats.saved_prefill_tokens + stats.prefill_tokens_dropped)


COUNTS = ("steps", "preemptions", "prefill_launches", "prefill_chunks", "prefill_tokens",
          "prefill_padded_tokens", "prompt_tokens_admitted", "prefill_tokens_dropped",
          "peak_pages_in_use", "total_tokens")


def _same_as_jax(got, want):
    assert _tokens(got) == _tokens(want)
    for name in COUNTS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.spec_stats == want.spec_stats
    assert got.prefill_budget_stats == want.prefill_budget_stats


PACKED_VS_CHUNKED = ((5, 9, 7, 4), (6, 4, 8, 3), 7)   # tests/test_varlen_prefill.py:175


@pytest.mark.parametrize("chunk", [8, 4])
def test_chunked_equals_packed_equals_jax(engines, chunk):
    cfg, (jengine, tengine), _ = engines
    lens, max_new, seed = PACKED_VS_CHUNKED
    kw = dict(num_slots=3, page_size=4, prefill_chunk=chunk, prefill_mode="chunked")
    want = jengine.serve_paged(_requests(jeng, cfg, lens, max_new, seed), **kw)
    got = tengine.serve_paged(_requests(teng, cfg, lens, max_new, seed), **kw)
    _same_as_jax(got, want)
    assert got.prefill_mode == "chunked" and got.prefill_budget == 0
    assert got.prefill_budget_stats == {}
    assert got.prefill_launches == got.prefill_chunks > len(lens)
    packed = tengine.serve_paged(_requests(teng, cfg, lens, max_new, seed), num_slots=3,
                                 page_size=4, prefill_chunk=chunk, prefill_budget=16)
    assert _tokens(packed) == _tokens(got)
    assert packed.prefill_launches < got.prefill_launches
    _ledger_exact(got)


PREEMPT = ((9, 8, 7, 5), (10, 8, 12, 6), 3)          # tests/test_varlen_prefill.py:226


@pytest.mark.parametrize("mode,spec_k", [("packed", 0), ("chunked", 0), ("packed", 3)])
def test_overcommit_preempts_like_jax(engines, mode, spec_k):
    """A 6-page pool at overcommit 10: preemption fires, the port preempts
    exactly as JAX does, and the tokens equal an undisturbed run's."""
    cfg, (jengine, tengine), _ = engines
    lens, max_new, seed = PREEMPT
    kw = dict(num_slots=3, page_size=4, num_pages=7, prefill_chunk=4, overcommit=10.0,
              prefill_mode=mode, prefill_budget=8, spec_k=spec_k)
    want = jengine.serve_paged(_requests(jeng, cfg, lens, max_new, seed), **kw)
    got = tengine.serve_paged(_requests(teng, cfg, lens, max_new, seed), **kw)
    assert got.preemptions > 0
    _same_as_jax(got, want)
    calm = tengine.serve_paged(_requests(teng, cfg, lens, max_new, seed), num_slots=3,
                               page_size=4, prefill_budget=8)
    assert calm.preemptions == 0
    assert _tokens(got) == _tokens(calm)
    _ledger_exact(got)
    assert got.prompt_tokens_admitted > sum(lens)      # re-admissions count again


def test_cache_off_ledger_exact_under_preemption(engines):
    """tests/test_prefix_cache.py:325: with the cache off every admitted
    prompt token is computed or dropped by preemption."""
    cfg, (jengine, tengine), _ = engines
    kw = dict(num_slots=3, page_size=4, num_pages=7, prefill_chunk=4, overcommit=10.0)
    args = ((9, 8, 7, 5), (10, 8, 12, 6), 3)
    want = jengine.serve_paged(_requests(jeng, cfg, *args), **kw)
    got = tengine.serve_paged(_requests(teng, cfg, *args), **kw)
    assert got.preemptions > 0 and got.saved_prefill_tokens == 0
    assert got.prefill_tokens_dropped == want.prefill_tokens_dropped
    _ledger_exact(got)
    _same_as_jax(got, want)


def test_spec_drafts_never_preempt(engines):
    """tests/test_spec_decode.py:256: on a pool sized exactly for one
    request, drafts that cannot get a page are cut, never preempting."""
    cfg, _, (jengine, tengine) = engines
    prompt = np.random.default_rng(23).integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    kw = dict(num_slots=1, page_size=4, num_pages=(8 + 24) // 4 + 1, prefill_budget=8,
              overcommit=4.0)
    runs = {}
    for mod, eng in ((jeng, jengine), (teng, tengine)):
        for k in (0, 4):
            req = [mod.ServeRequest(request_id=0, prompt=prompt, max_new_tokens=24)]
            runs[mod.__name__, k] = eng.serve_paged(req, spec_k=k, **kw)
    for stats in runs.values():
        assert stats.preemptions == 0
    base = runs[teng.__name__, 0]
    assert _tokens(runs[teng.__name__, 4]) == _tokens(base) == _tokens(runs[jeng.__name__, 0])
    _same_as_jax(runs[teng.__name__, 4], runs[jeng.__name__, 4])


def test_serve_paged_keywords_cover_the_reference():
    """Every keyword of the reference's serve_paged, the fault hook and the
    KV checkpoints included, in the reference's order."""
    import inspect

    ref = list(inspect.signature(jeng.ServingEngine.serve_paged).parameters)
    port = list(inspect.signature(teng.ServingEngine.serve_paged).parameters)
    assert set(ref) - set(port) == set()
    assert port == ref


def test_serve_paged_validates_new_keywords(engines):
    cfg, (_, tengine), _ = engines
    reqs = _requests(teng, cfg, (5,), (2,), 0)
    with pytest.raises(ValueError, match="unknown prefill_mode"):
        tengine.serve_paged(reqs, prefill_mode="ragged")
    with pytest.raises(ValueError, match="overcommit must be > 0"):
        tengine.serve_paged(reqs, overcommit=0.0)
    with pytest.raises(ValueError, match="overcommit budget"):
        tengine.serve_paged(_requests(teng, cfg, (20,), (8,), 0), page_size=4, num_pages=5)
    empty = tengine.serve_paged([], prefill_mode="chunked")
    assert empty.results == [] and empty.prefill_mode == "chunked"


def test_quantized_chunked_equals_packed(engines):
    """An int8 pool read through the same dequantized math: chunked and
    packed prefill give the same tokens, and JAX's chunked tokens."""
    cfg, _, _ = engines
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    tengine = teng.ServingEngine(tmodel, from_jax(jax.tree.map(np.asarray, jparams)),
                                 max_batch=3, max_seq=32, device="cpu", kv_dtype="int8")
    jengine = jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=32, kv_dtype="int8")
    lens, max_new, seed = PACKED_VS_CHUNKED
    kw = dict(num_slots=3, page_size=4, prefill_chunk=8)
    chunked = tengine.serve_paged(_requests(teng, cfg, lens, max_new, seed),
                                  prefill_mode="chunked", **kw)
    packed = tengine.serve_paged(_requests(teng, cfg, lens, max_new, seed), **kw)
    want = jengine.serve_paged(_requests(jeng, cfg, lens, max_new, seed),
                               prefill_mode="chunked", **kw)
    assert _tokens(chunked) == _tokens(packed) == _tokens(want)
    assert kvquant.is_quantized(chunked.kv_dtype)
