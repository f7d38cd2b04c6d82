"""The dense-cache path of the port against the JAX package: the plain
``attention`` and ``decode_attention`` against the Pallas kernels (interpret
mode, as the JAX suite runs them on the CPU), and reduced glm4-9b's
``attn_full``/``attn_decode``, ``prefill``, ``decode`` and ``forward``
against the JAX model built with ``backend="pallas"`` on the same weights.

Inputs come from numpy with fixed seeds.  Tolerances: float32 kernels 5e-5
(the JAX suite's own); bf16 kernels 2e-2 (both round the output to bf16,
and the Pallas flash kernel also rounds the probabilities to bf16 before
the product with V, where the port keeps them in float32); logits 1e-4 and
caches 5e-5 in float32 (summation order).  A query row with no live key is
exactly zero in the port, while the Pallas flash kernel leaves a value that
depends on its block size there: such rows are asserted zero and left out
of the comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import build_model
from repro.models import modules as jmod
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops, ref
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models import modules as tmod

TOL = {torch.float32: dict(rtol=5e-5, atol=5e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=5e-5, atol=5e-5)
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shapes, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return [torch.from_numpy(a).to(dtype) for a in arrs], [jnp.asarray(a, JNP[dtype]) for a in arrs]


def _live_rows(sq, sk, causal, window, q_offset):
    """(sq,) bool: query rows with at least one live key."""
    q_pos = q_offset + np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= (q_pos - k_pos) < window
    return ok.any(axis=1)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # b, sq, sk, h, kvh, d, causal, window, softcap, q_offset
    (2, 40, 40, 4, 2, 16, True, None, 0.0, 0),      # GQA, sk not a block multiple
    (1, 24, 40, 4, 2, 16, False, None, 0.0, 0),     # non-causal, sq != sk
    (2, 40, 40, 4, 4, 8, True, 7, 0.0, 0),          # MHA, window
    (1, 33, 33, 8, 1, 16, True, None, 5.0, 0),      # MQA, softcap
    (2, 8, 40, 4, 2, 16, True, None, 0.0, 32),      # a chunk at positions 32..39
    (1, 16, 40, 4, 2, 16, True, 4, 0.0, 40),        # window past the keys: rows 0..2 live
    (1, 8, 40, 4, 2, 16, True, 4, 0.0, 60),         # no live key in any row
    (1, 20, 20, 4, 2, 16, False, 6, 3.0, 0),        # non-causal window + softcap
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_attention_matches_pallas_flash(case, dtype):
    b, sq, sk, h, kvh, d, causal, window, softcap, q_offset = case
    (q, k, v), (qj, kj, vj) = _inputs([(b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)],
                                      seed=sq + sk + h, dtype=dtype)
    opts = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    want = np.asarray(pallas_flash(qj, kj, vj, **opts, block_q=16, block_k=16,
                                   interpret=True).astype(jnp.float32))
    got = ref.attention(q, k, v, **opts)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(ops.attention(q, k, v, **opts), got, rtol=0, atol=0)
    live = _live_rows(sq, sk, causal, window, q_offset)
    got = got.float().numpy()
    np.testing.assert_allclose(got[:, live], want[:, live], **TOL[dtype])
    assert np.all(got[:, ~live] == 0)


def test_attention_without_live_keys_is_zero_where_pallas_depends_on_blocks():
    """The Pallas kernel's value on a row with no live key changes with its
    kv block size; the port's is an exact zero (ROADMAP Queue 3)."""
    (q, k, v), (qj, kj, vj) = _inputs([(1, 8, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)],
                                      seed=3, dtype=torch.float32)
    opts = dict(causal=True, window=4, q_offset=60)
    a = np.asarray(pallas_flash(qj, kj, vj, **opts, block_k=16, interpret=True))
    c = np.asarray(pallas_flash(qj, kj, vj, **opts, block_k=40, interpret=True))
    assert not np.allclose(a, c)
    assert torch.all(ref.attention(q, k, v, **opts) == 0)


def test_flash_wrapper_on_cpu_runs_the_plain_version():
    (q, k, v), _ = _inputs([(1, 12, 4, 8), (1, 12, 2, 8), (1, 12, 2, 8)], 4, torch.float32)
    before = fa_mod.launches
    torch.testing.assert_close(fa_mod.flash_attention(q, k, v, window=3),
                               ref.attention(q, k, v, window=3), rtol=0, atol=0)
    assert fa_mod.launches == before


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------
DECODE_CASES = [
    # b, S, h, kvh, d, lengths, window, softcap, kv_bound
    (4, 40, 4, 2, 16, [1, 17, 40, 0], None, 0.0, None),     # length 0: exact zeros
    (3, 40, 8, 1, 16, [9, 33, 0], 6, 0.0, None),            # MQA, window
    (3, 48, 4, 4, 8, [5, 20, 31], None, 4.0, 32),           # MHA, softcap, kv_bound
    (2, 64, 4, 2, 16, [16, 3], 8, 0.0, 16),                 # window + kv_bound
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_matches_pallas(case, dtype):
    b, S, h, kvh, d, lengths, window, softcap, kv_bound = case
    (q, k, v), (qj, kj, vj) = _inputs([(b, 1, h, d), (b, S, kvh, d), (b, S, kvh, d)],
                                      seed=S + h + d, dtype=dtype)
    lens = np.asarray(lengths, np.int32)
    opts = dict(window=window, softcap=softcap, kv_bound=kv_bound)
    want = np.asarray(pallas_decode(qj, kj, vj, jnp.asarray(lens), **opts, block_s=16,
                                    interpret=True).astype(jnp.float32))
    got = ref.decode_attention(q, k, v, torch.from_numpy(lens), **opts)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(ops.decode_attention(q, k, v, torch.from_numpy(lens), **opts),
                               got, rtol=0, atol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.all(got[i] == 0) and np.all(want[i] == 0)


def test_decode_attention_never_reads_dead_rows():
    """V rows outside a row's live keys are zeroed before use: a NaN there,
    or past ``kv_bound``, never reaches the output."""
    (q, k, v), _ = _inputs([(2, 1, 4, 8), (2, 32, 2, 8), (2, 32, 2, 8)], 5, torch.float32)
    lens = torch.tensor([10, 20], dtype=torch.int32)
    clean = ref.decode_attention(q, k, v, lens, window=6, kv_bound=24)
    v[0, 10:], v[0, :4], v[1, 24:] = float("nan"), float("nan"), float("nan")
    k[1, 24:] = float("nan")
    torch.testing.assert_close(da_mod.decode_attention(q, k, v, lens, window=6, kv_bound=24),
                               clean, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the model: reduced glm4-9b against the JAX model (Pallas kernels)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg, backend="pallas")
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for blk_key in ("ln1", "ln2"):
        leaf = np_params["blocks"][blk_key]
        np_params["blocks"][blk_key] = (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
    np_params["final_norm"] = (0.1 * rng.normal(size=np_params["final_norm"].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    return jmodel, jparams, tmodel, from_jax(np_params)


@pytest.mark.parametrize("q_offset", [0, 5])
def test_attn_full_matches_jax(models, q_offset):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    x = np.random.default_rng(1).normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda t: t[1], jparams["blocks"]["attn"])
    y_j, (k_j, v_j) = jmod.attn_full(p_j, jnp.asarray(x), cfg, backend="pallas",
                                     q_offset=q_offset, return_kv=True)
    y_t, (k_t, v_t) = tmod.attn_full(tparams["blocks"][1]["attn"], torch.from_numpy(x), cfg,
                                     q_offset=q_offset, return_kv=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), **CACHE_TOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **CACHE_TOL)


@pytest.mark.parametrize("uniform,pos,kv_bound", [
    (True, [6, 6, 6], 16),
    (False, [3, 9, 0], 16),
    (False, [12, 23, 30], None),         # the last row's position past the cache
])
def test_attn_decode_matches_jax(models, uniform, pos, kv_bound):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    S = 24
    rng = np.random.default_rng(2)
    kc, vc = (rng.normal(size=(3, S, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
              for _ in range(2))
    x1 = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    p_j = jax.tree.map(lambda t: t[0], jparams["blocks"]["attn"])
    y_j, kc_j, vc_j = jmod.attn_decode(
        p_j, jnp.asarray(x1), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos), cfg,
        backend="pallas", uniform_pos=uniform, kv_bound=kv_bound)
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y_t = tmod.attn_decode(tparams["blocks"][0]["attn"], torch.from_numpy(x1), kc_t, vc_t,
                           torch.from_numpy(pos), cfg, uniform_pos=uniform, kv_bound=kv_bound)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **CACHE_TOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j), **CACHE_TOL)
    live = pos < S
    np.testing.assert_allclose(y_t.numpy()[live], np.asarray(y_j)[live], **LOGIT_TOL)


def test_attn_decode_ring_is_not_ported(models):
    """The ring, which this module once refused, is ported with the hybrid
    family: on reduced glm4-9b's attention too, a wrapped ring writes each
    row at ``pos % S`` and attends ``min(pos + 1, S)`` keys, as the
    reference does (``test_torch_hybrid.py`` holds the hybrid model)."""
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(12)
    S = 8
    kc, vc = (rng.normal(size=(2, S, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
              for _ in range(2))
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([5, 19], np.int32)
    p_j = jax.tree.map(lambda t: t[0], jparams["blocks"]["attn"])
    y_j, kc_j, _ = jmod.attn_decode(p_j, jnp.asarray(x1), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(pos), cfg, backend="pallas", ring=True,
                                    uniform_pos=False)
    kc_t = torch.from_numpy(kc.copy())
    y_t = tmod.attn_decode(tparams["blocks"][0]["attn"], torch.from_numpy(x1), kc_t,
                           torch.from_numpy(vc.copy()), torch.from_numpy(pos), cfg, ring=True,
                           uniform_pos=False)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **CACHE_TOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)


def _prefill_both(models, prompts, S, ragged):
    """Prefill ``prompts`` in both models (right-padded with lengths when
    ``ragged``, else all of one length); returns the JAX cache, the port's
    cache and both logits."""
    jmodel, jparams, tmodel, tparams = models
    b = len(prompts)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    tokens = np.zeros((b, int(lens.max()) if not ragged else 16), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    batch_j = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens)}
    if ragged:
        batch_j["lengths"] = jnp.asarray(lens)
        batch_t["lengths"] = torch.from_numpy(lens)
    lj, jcache = jmodel.prefill(jparams, batch_j, jmodel.init_cache(b, S, dtype="float32"))
    tcache = tmodel.init_cache(b, S)
    lt = tmodel.prefill(tparams, batch_t, tcache)
    return jcache, tcache, np.asarray(lj), lt.numpy()


def _hold_caches(jcache, tcache):
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **CACHE_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_then_decode_matches_jax(models, ragged):
    """A prefill (right-padded to 16 with lengths, or of one length), then
    four decode steps (per-row positions with a kv bound, or one shared
    position): logits and the whole cache agree at every step."""
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    lens = (5, 11, 8) if ragged else (9, 9, 9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    S = 32
    jcache, tcache, lj, lt = _prefill_both(models, prompts, S, ragged)
    np.testing.assert_allclose(lt, lj, **LOGIT_TOL)
    _hold_caches(jcache, tcache)
    nxt = lj.argmax(-1).astype(np.int32)
    for i in range(4):
        bound = 16 if ragged else None
        lj, jcache = jmodel.decode(jparams, jnp.asarray(nxt), jcache,
                                   uniform_pos=not ragged, kv_bound=bound)
        lt = tmodel.decode(tparams, torch.from_numpy(nxt), tcache,
                           uniform_pos=not ragged, kv_bound=bound)
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), lj, **LOGIT_TOL)
        _hold_caches(jcache, tcache)
        nxt = lj.argmax(-1).astype(np.int32)


def test_forward_matches_jax(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    lj, aux_j = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    lt, aux_t = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and lt.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert float(aux_t) == float(aux_j) == 0.0


def test_prefill_logits_are_forward_logits_at_the_last_token(models):
    """Inside the port: a right-padded prefill gives each row the logits
    that ``forward`` over its unpadded prompt gives at its last token."""
    _, _, tmodel, tparams = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, n).astype(np.int32) for n in (4, 10)]
    tokens = np.zeros((2, 16), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    cache = tmodel.init_cache(2, 16)
    logits = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                      "lengths": torch.tensor([4, 10], dtype=torch.int32)}, cache)
    assert cache["pos"].tolist() == [4, 10]
    for i, p in enumerate(prompts):
        full, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(p[None])})
        torch.testing.assert_close(logits[i], full[0, -1], **LOGIT_TOL)


def test_init_cache_layout():
    model = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    cache = model.init_cache(3, 20)
    cfg = model.cfg
    assert cache["k"].shape == (cfg.num_layers, 3, 20, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert cache["k"].dtype == torch.float32 and cache["pos"].dtype == torch.int32
    assert set(cache) == set(model.CACHE_BATCH_AXIS)
    for name, ax in model.CACHE_BATCH_AXIS.items():
        assert cache[name].shape[ax] == 3
    bf = DecoderLM(cfg, device="cpu", dtype=torch.bfloat16).init_cache(1, 4)
    assert bf["v"].dtype == torch.bfloat16
