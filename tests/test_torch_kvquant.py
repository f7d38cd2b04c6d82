"""Quantized (int8/fp8) KV pools in the port against the JAX package.

``quantize`` codes and scales are held bit for bit against
``repro.kernels.kvquant`` (fp8 compared as a ``uint8`` view); the plain
attention versions on quantized pools against the Pallas kernels in
interpret mode (5e-5, float32: both dequantize ``code * scale`` in float32
and differ only in summation order); quantize-on-append against the JAX
modules; and ``serve_paged(kv_dtype=...)`` tokens against the JAX engine on
the reduced config.  Pools written from K/V computed in two frameworks may
differ in an int8 code where a value sits on a rounding boundary, so pool
contents are compared after dequantization, to one quantization step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import kvquant as jkq
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.spec_verify import spec_verify as pallas_spec
from repro.kernels.varlen_prefill import varlen_prefill as pallas_varlen
from repro.models import build_model
from repro.models import modules as jmod
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.kernels import kvquant as tkq
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models import modules as tmod
from repro_torch.serve import engine as teng

H, KVH, DH = 8, 4, 16
PAGE = 8
TOL = dict(rtol=5e-5, atol=5e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MODES = ["int8", "fp8"]


def _close(port, jax_out, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out, np.float32), **tol)


def _codes(q):
    """Codes as raw bytes: numpy cannot compare fp8 values directly."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


# ---------------------------------------------------------------------------
# the kvquant copy
# ---------------------------------------------------------------------------
def test_modes_match_jax():
    for name in (None, "int8", "fp8", "float32", "bfloat16", "float16", "f32", "bf16"):
        assert tkq.is_quantized(name) == jkq.is_quantized(name)
    for mod in (tkq, jkq):
        with pytest.raises(ValueError):
            mod.is_quantized("int4")
    assert tkq.pool_dtype("int8") == torch.int8
    assert tkq.pool_dtype("fp8") == torch.float8_e4m3fn
    for mode in MODES:
        assert tkq.quant_max(tkq.pool_dtype(mode)) == jkq.quant_max(jkq.pool_dtype(mode))
    with pytest.raises(ValueError):
        tkq.quant_max(torch.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,amp", [(0, 3.0), (1, 1e-3), (2, 40.0), (3, 1.0)])
def test_quantize_is_bit_equal_to_jax(mode, seed, amp):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, PAGE, KVH, DH)) * amp).astype(np.float32)
    x[0, 0] = 0.0                                  # all-zero rows: scale 0
    x[1, 2, 1, :3] = [amp, -amp, 0.5 * amp]        # ties and the row max
    qj, sj = jkq.quantize(jnp.asarray(x), jkq.pool_dtype(mode))
    qt, st = tkq.quantize(torch.from_numpy(x), tkq.pool_dtype(mode))
    assert qt.dtype == tkq.pool_dtype(mode) and st.dtype == torch.float32
    np.testing.assert_array_equal(_codes(qt), _codes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert np.all(st.numpy()[0, 0] == 0.0)
    np.testing.assert_array_equal(tkq.dequantize(qt, st).numpy(),
                                  np.asarray(jkq.dequantize(qj, sj)))


def test_int8_rounds_half_to_even_like_jax():
    """Codes exactly halfway between two integers: both round to even."""
    x = np.array([[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]]], np.float32)   # scale 1
    qj, _ = jkq.quantize(jnp.asarray(x), jnp.int8)
    qt, _ = tkq.quantize(torch.from_numpy(x), torch.int8)
    assert qt.tolist() == np.asarray(qj).tolist() == [[[127, 0, 2, 2, 0, -2]]]


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8", "fp8"])
def test_kv_bytes_per_token_matches_jax(kv_dtype):
    for L, kvh, dh in ((3, 2, 64), (40, 2, 128)):
        assert tkq.kv_bytes_per_token(L, kvh, dh, kv_dtype) == \
            jkq.kv_bytes_per_token(L, kvh, dh, kv_dtype)
    # glm4-9b at full width: int8/fp8 pay 1-byte codes plus a 4-byte scale
    assert tkq.kv_bytes_per_token(40, 2, 128, "int8") == 21120
    assert tkq.kv_bytes_per_token(40, 2, 128, "bfloat16") == 40960


# ---------------------------------------------------------------------------
# plain attention on quantized pools vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
def _quantized_pools(rng, num_pages, mode):
    k = rng.standard_normal((num_pages, PAGE, KVH, DH)).astype(np.float32)
    v = rng.standard_normal((num_pages, PAGE, KVH, DH)).astype(np.float32)
    store = jkq.pool_dtype(mode)
    kq, ks = jkq.quantize(jnp.asarray(k), store)
    vq, vs = jkq.quantize(jnp.asarray(v), store)
    jax_pools = (kq, vq, ks, vs)
    torch_pools = tuple(
        torch.from_numpy(_codes(t).copy()).view(tkq.pool_dtype(mode)) if i < 2
        else torch.from_numpy(np.asarray(t).copy())
        for i, t in enumerate(jax_pools))
    return jax_pools, torch_pools


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("opts", [{}, {"window": 6}])
def test_paged_attention_quantized_matches_pallas(mode, opts):
    rng = np.random.default_rng(0)
    (kq, vq, ks, vs), (tkq_, tvq, tks, tvs) = _quantized_pools(rng, 24, mode)
    b, max_pages = 4, 4
    q = rng.standard_normal((b, 1, H, DH)).astype(np.float32)
    table = rng.permutation(np.arange(1, 24))[: b * max_pages].reshape(b, max_pages).astype(np.int32)
    lengths = np.array([5, 13, 1, 27], np.int32)
    want = pallas_paged(jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(lengths),
                        k_scales=ks, v_scales=vs, **opts)
    targs = (torch.from_numpy(q), tkq_, tvq, torch.from_numpy(table), torch.from_numpy(lengths))
    _close(ref.paged_attention(*targs, k_scales=tks, v_scales=tvs, **opts), want)
    _close(ops.paged_attention(*targs, k_scales=tks, v_scales=tvs, **opts), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("opts", [{}, {"softcap": 9.0}])
def test_varlen_prefill_quantized_matches_pallas(mode, opts):
    """Only the committed context pages are quantized; the packed chunk
    K/V stay full precision."""
    rng = np.random.default_rng(1)
    (kq, vq, ks, vs), (tkq_, tvq, tks, tvs) = _quantized_pools(rng, 24, mode)
    C, max_pages = 4, 4
    spans = [16, 8, 24, 16]
    T = sum(spans)
    cu = np.zeros((C + 1,), np.int32)
    cu[1:] = np.cumsum(spans)
    lens = np.array([13, 8, 21, 10], np.int32)
    pos0 = np.array([0, 16, 8, 0], np.int32)
    tables = rng.permutation(np.arange(1, 24))[: C * max_pages].reshape(C, max_pages).astype(np.int32)
    q = rng.standard_normal((T, H, DH)).astype(np.float32)
    k = rng.standard_normal((T, KVH, DH)).astype(np.float32)
    v = rng.standard_normal((T, KVH, DH)).astype(np.float32)
    meta = (cu, lens, pos0, tables)
    want = pallas_varlen(*map(jnp.asarray, (q, k, v)), kq, vq, *map(jnp.asarray, meta),
                         k_scales=ks, v_scales=vs, **opts)
    targs = (*map(torch.from_numpy, (q, k, v)), tkq_, tvq, *map(torch.from_numpy, meta))
    _close(ref.varlen_prefill(*targs, k_scales=tks, v_scales=tvs, **opts), want)
    _close(ops.varlen_prefill(*targs, k_scales=tks, v_scales=tvs, **opts), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("opts", [{}, {"window": 4}])
def test_spec_verify_quantized_matches_pallas(mode, opts):
    rng = np.random.default_rng(2)
    (kq, vq, ks, vs), (tkq_, tvq, tks, tvs) = _quantized_pools(rng, 24, mode)
    b, W, max_pages = 4, 3, 4
    q = rng.standard_normal((b, W, H, DH)).astype(np.float32)
    table = rng.permutation(np.arange(1, 24))[: b * max_pages].reshape(b, max_pages).astype(np.int32)
    lengths = np.array([5, 14, 3, 26], np.int32)
    wlens = np.array([3, 1, 0, 2], np.int32)
    want = pallas_spec(jnp.asarray(q), kq, vq, *map(jnp.asarray, (table, lengths, wlens)),
                       k_scales=ks, v_scales=vs, **opts)
    targs = (torch.from_numpy(q), tkq_, tvq, *map(torch.from_numpy, (table, lengths, wlens)))
    _close(ref.spec_verify(*targs, k_scales=tks, v_scales=tvs, **opts), want)
    _close(ops.spec_verify(*targs, k_scales=tks, v_scales=tvs, **opts), want)


@pytest.mark.parametrize("mode", MODES)
def test_fused_dequant_equals_attending_a_dequantized_pool(mode):
    """Within the port: a quantized pool attends exactly like the float32
    pool it dequantizes to."""
    rng = np.random.default_rng(3)
    _, (tkq_, tvq, tks, tvs) = _quantized_pools(rng, 12, mode)
    q = torch.from_numpy(rng.standard_normal((2, 1, H, DH)).astype(np.float32))
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lens = torch.tensor([17, 9], dtype=torch.int32)
    got = ref.paged_attention(q, tkq_, tvq, table, lens, k_scales=tks, v_scales=tvs)
    want = ref.paged_attention(q, tkq.dequantize(tkq_, tks), tkq.dequantize(tvq, tvs), table, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the model: quantized pools and quantize-on-append against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    return cfg, jmodel, jparams, tmodel, from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("mode", MODES)
def test_init_paged_cache_quantized(weights, mode):
    cfg, jmodel, _, tmodel, _ = weights
    cache = tmodel.init_paged_cache(6, PAGE, mode)
    defs = jmodel.paged_cache_defs(6, PAGE, dtype=mode)
    assert set(cache) == set(defs) == {"k_pages", "v_pages", "k_scales", "v_scales"}
    for name, t in cache.items():
        assert tuple(t.shape) == tuple(defs[name].shape), name
        assert not t.any()
    assert cache["k_pages"].dtype == tkq.pool_dtype(mode)
    assert cache["k_scales"].dtype == torch.float32
    plain = tmodel.init_paged_cache(6, PAGE)
    assert set(plain) == {"k_pages", "v_pages"} and plain["k_pages"].dtype == tmodel.dtype


def _dequant_close(tq, ts, jq, js, mode):
    """Dequantized pools agree to one quantization step per row (int8: the
    row's scale; fp8: 1/8 of the row's max), and the scales to 1e-4."""
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-7)
    got = tkq.dequantize(tq, ts).numpy()
    want = (jnp.asarray(jq).astype(jnp.float32) * jnp.asarray(js)[..., None])
    step = np.asarray(js)[..., None] * (1.0 if mode == "int8" else 448.0 / 8)
    assert np.all(np.abs(got - np.asarray(want)) <= step * 1.0001 + 1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_attn_decode_paged_quantized_matches_jax(weights, mode):
    cfg, jmodel, jparams, tmodel, tparams = weights
    rng = np.random.default_rng(4)
    store = jkq.pool_dtype(mode)
    kf = rng.standard_normal((16, 4, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    vf = rng.standard_normal(kf.shape).astype(np.float32)
    (kq, ks), (vq, vs) = jkq.quantize(jnp.asarray(kf), store), jkq.quantize(jnp.asarray(vf), store)
    x1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    table = np.array([[1, 2, 3, 0, 0, 0], [4, 5, 0, 0, 0, 0], [0] * 6], np.int32)
    pos = np.array([9, 4, 0], np.int32)
    p_j = jax.tree.map(lambda t: t[0], jparams["blocks"]["attn"])
    y_j, kq_j, vq_j, ks_j, vs_j = jmod.attn_decode_paged(
        p_j, jnp.asarray(x1), kq, vq, jnp.asarray(table), jnp.asarray(pos), cfg,
        backend="pallas", pages_bound=4, k_scales=ks, v_scales=vs)
    tp = [torch.from_numpy(_codes(t).copy()).view(tkq.pool_dtype(mode)) for t in (kq, vq)]
    ts = [torch.from_numpy(np.asarray(t).copy()) for t in (ks, vs)]
    y_t = tmod.attn_decode_paged(
        tparams["blocks"][0]["attn"], torch.from_numpy(x1), *tp, torch.from_numpy(table),
        torch.from_numpy(pos), cfg, pages_bound=4, k_scales=ts[0], v_scales=ts[1])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)
    _dequant_close(tp[0], ts[0], kq_j, ks_j, mode)
    _dequant_close(tp[1], ts[1], vq_j, vs_j, mode)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_then_decode_quantized_matches_jax(weights, mode):
    """A packed prefill launch then three decode steps on a quantized pool:
    logits agree throughout."""
    cfg, jmodel, jparams, tmodel, tparams = weights
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    T, C, ps, mp, npages = 8, 2, 4, 4, 8
    meta = dict(
        tokens=np.zeros((1, T), np.int32), tok_pos=np.arange(T, dtype=np.int32),
        dst_page=np.array([1] * 4 + [2] * 4, np.int32), dst_off=np.arange(T, dtype=np.int32) % ps,
        cu_seqlens=np.array([0, 8, 8], np.int32), chunk_lens=np.array([7, 0], np.int32),
        chunk_pos0=np.zeros(C, np.int32),
        page_tables=np.array([[1, 2, 3, 0], [0] * 4], np.int32),
        last_idx=np.array([6, 0], np.int32))
    meta["tokens"][0, :7] = prompt
    jcache = jmodel.init_paged_cache(npages, ps, dtype=mode)
    tcache = tmodel.init_paged_cache(npages, ps, mode)
    lj, jcache = jmodel.prefill_packed(jparams, {k: jnp.asarray(v) for k, v in meta.items()},
                                       jcache, pages_bound=1)
    lt = tmodel.prefill_packed(tparams, {k: torch.from_numpy(v) for k, v in meta.items()},
                               tcache, pages_bound=1)
    np.testing.assert_allclose(lt.numpy()[:1], np.asarray(lj)[:1], **LOGIT_TOL)
    nxt = np.array([int(np.asarray(lj)[0].argmax())], np.int32)
    table, lengths = meta["page_tables"][:1], np.array([7], np.int32)
    for _ in range(3):
        lj, jcache = jmodel.decode_paged(jparams, jnp.asarray(nxt), jcache, jnp.asarray(table),
                                         jnp.asarray(lengths), pages_bound=4)
        lt = tmodel.decode_paged(tparams, torch.from_numpy(nxt), tcache,
                                 torch.from_numpy(table), torch.from_numpy(lengths),
                                 pages_bound=4)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)
        lengths += 1


# ---------------------------------------------------------------------------
# serve_paged on quantized pools against the JAX engine
# ---------------------------------------------------------------------------
def _requests(mod, cfg):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 13, 4)]
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, (6, 4, 8, 3)))]


def _tokens(stats):
    return [r.tokens.tolist() for r in stats.results]


@pytest.mark.parametrize("mode", MODES)
def test_serve_paged_quantized_tokens_equal_jax(weights, mode):
    """The setup of tests/test_kvquant.py's engine tests, reduced glm4-9b."""
    cfg, jmodel, jparams, tmodel, tparams = weights
    kw = dict(num_slots=3, page_size=8, num_pages=40)
    want = jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=64,
                              kv_dtype=mode).serve_paged(_requests(jeng, cfg), **kw)
    engine = teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=64, device="cpu",
                                kv_dtype=mode)
    got = engine.serve_paged(_requests(teng, cfg), **kw)
    assert _tokens(got) == _tokens(want)
    assert got.kv_dtype == want.kv_dtype == mode
    assert got.kv_bytes_per_token == want.kv_bytes_per_token == tkq.kv_bytes_per_token(
        cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, mode)
    # the same quantized pool read through the verify kernel: spec == plain
    spec = engine.serve_paged(_requests(teng, cfg), spec_k=2, **kw)
    assert _tokens(spec) == _tokens(got)


def test_quantized_pool_is_smaller_than_full_precision(weights):
    cfg, _, _, tmodel, tparams = weights
    kw = dict(num_slots=3, page_size=8, num_pages=40)
    full = teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=64,
                              device="cpu").serve_paged(_requests(teng, cfg), **kw)
    q8 = teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=64, device="cpu",
                            kv_dtype="int8").serve_paged(_requests(teng, cfg), **kw)
    assert full.kv_dtype == "float32"
    assert full.kv_bytes_per_token == tkq.kv_bytes_per_token(
        cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, "float32")
    assert q8.kv_bytes_per_token < full.kv_bytes_per_token


def test_engine_rejects_unknown_kv_dtype(weights):
    _, _, _, tmodel, tparams = weights
    for bad in ("int4", "float32"):
        with pytest.raises(ValueError, match="kv_dtype"):
            teng.ServingEngine(tmodel, tparams, max_batch=2, max_seq=32, device="cpu",
                               kv_dtype=bad)


@pytest.mark.parametrize("mode", MODES)
def test_driver_runs_quantized_on_cpu(capsys, mode):
    assert tlaunch.main([
        "--device", "cpu", "--requests", "3", "--prompt-len", "10", "--prompt-len-min", "4",
        "--max-new-tokens", "3", "--engine-batch", "2", "--page-size", "4",
        "--max-seq", "16", "--kv-dtype", mode,
    ]) == 0
    out = capsys.readouterr().out
    assert f"kv_dtype {mode}" in out and "generated_tokens     9" in out
