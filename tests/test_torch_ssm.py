"""The SSM family of the port (mamba2-130m) against the JAX package: the
plain ``ssd`` scan and ``ssd_step`` against ``repro.kernels.ref``, the
chunked ``ops.ssd_chunked_jnp`` and the Pallas ``ssd`` (interpret mode, as
the JAX suite runs it on the CPU); the Mamba-2 modules; reduced mamba2's
``forward``, ``prefill`` caches and ``decode``; and the static and
continuous engines' greedy tokens and schedules.

Inputs come from numpy with fixed seeds.  Tolerances: the scan 5e-4, the
JAX suite's own between its chunked scan and the sequential recurrence
(float32, other summation order over the sequence); logits 1e-4 and states
and conv histories 5e-5 in float32, as for the dense model (summation
order of the matrix products).  The model is held against
``build_model(cfg, backend="flash")`` (the JAX driver's default backend,
whose ``ssd`` zero-pads a partial chunk) at any prompt length, and against
``backend="pallas"`` only where every length is a multiple of the chunk:
the Pallas ``ssd`` gives NaN on a trailing partial chunk (recorded below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd as pallas_ssd
from repro.models import build_model
from repro.models import modules as jmod
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models import modules as tmod
from repro_torch.serve import engine as teng

SSD_TOL = dict(rtol=5e-4, atol=5e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=5e-5, atol=5e-5)
ARCH = "mamba2-130m"


def _ssd_inputs(b, s, h, p, n, seed, init):
    """numpy x, dt, A, B, C (and an initial state) in the JAX suite's
    ranges: dt in [0.01, 0.2], A in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, B, C = f(b, s, h, p), f(b, s, n), f(b, s, n)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    return x, dt, A, B, C, (f(b, h, p, n) if init else None)


def _both(arrays):
    """The same arrays as torch tensors and as jax arrays (None stays)."""
    t = [None if a is None else torch.from_numpy(a) for a in arrays]
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    return t, j


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
SSD_SHAPES = [
    # b, s, h, p, n, chunk: the JAX suite's, every s a multiple of chunk
    (1, 16, 2, 4, 8, 4),
    (2, 40, 4, 8, 16, 8),
    (1, 64, 3, 16, 32, 16),
]
RAGGED_SHAPES = [
    (1, 11, 2, 4, 8, 8),        # a partial trailing chunk of 3
    (2, 40, 4, 8, 16, 16),      # 40 = 2 x 16 + 8
    (1, 70, 3, 16, 32, 64),     # 70 = 64 + 6
]


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES + RAGGED_SHAPES)
def test_plain_ssd_matches_jax_ref_and_chunked(shape, with_init):
    b, s, h, p, n, chunk = shape
    (x, dt, A, B, C, s0), (xj, dtj, Aj, Bj, Cj, s0j) = _both(
        _ssd_inputs(b, s, h, p, n, s + h, with_init))
    y, sf = ref.ssd(x, dt, A, B, C, initial_state=s0, return_state=True)
    assert y.shape == (b, s, h, p) and sf.shape == (b, h, p, n)
    assert y.dtype == sf.dtype == torch.float32
    for want_y, want_s in (
        jref.ssd(xj, dtj, Aj, Bj, Cj, initial_state=s0j, return_state=True),
        jops.ssd_chunked_jnp(xj, dtj, Aj, Bj, Cj, chunk=chunk, initial_state=s0j,
                             return_state=True),
    ):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(sf.numpy(), np.asarray(want_s), **SSD_TOL)
    # the dispatch on a CPU tensor is the plain version, bit for bit
    got = ops.ssd(x, dt, A, B, C, chunk=chunk, initial_state=s0, return_state=True)
    assert torch.equal(got[0], y) and torch.equal(got[1], sf)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_plain_ssd_matches_pallas(shape, with_init):
    b, s, h, p, n, chunk = shape
    (x, dt, A, B, C, s0), (xj, dtj, Aj, Bj, Cj, s0j) = _both(
        _ssd_inputs(b, s, h, p, n, 2 * s + h, with_init))
    want_y, want_s = pallas_ssd(xj, dtj, Aj, Bj, Cj, chunk=chunk, initial_state=s0j,
                                return_state=True, interpret=True)
    y, sf = ref.ssd(x, dt, A, B, C, initial_state=s0, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(want_s), **SSD_TOL)


def test_pallas_ssd_partial_chunk_is_nan_where_the_port_is_finite():
    """A difference inside the reference: the Pallas ``ssd`` zeroes dt on
    the padded timesteps of a trailing partial chunk but not x, B and C,
    which interpret mode fills with NaN, so every row of that chunk and the
    final state come out non-finite (``0 * NaN``).  The port reads only
    live rows: it is finite there and equals the JAX oracle ``ref.ssd``."""
    b, s, h, p, n, chunk = 1, 11, 2, 4, 8, 8
    (x, dt, A, B, C, _), (xj, dtj, Aj, Bj, Cj, _) = _both(_ssd_inputs(b, s, h, p, n, 0, False))
    py, ps = (np.asarray(a) for a in pallas_ssd(xj, dtj, Aj, Bj, Cj, chunk=chunk,
                                                return_state=True, interpret=True))
    assert not np.isfinite(py[:, chunk:]).any() and not np.isfinite(ps).any()
    y, sf = ref.ssd(x, dt, A, B, C, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    want_y, want_s = jref.ssd(xj, dtj, Aj, Bj, Cj, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(want_s), **SSD_TOL)
    # the full chunk before it agrees with the Pallas kernel
    np.testing.assert_allclose(y.numpy()[:, :chunk], py[:, :chunk], **SSD_TOL)


def test_ssd_step_matches_jax():
    b, h, p, n = 3, 4, 8, 16
    rng = np.random.default_rng(11)
    x, dt, A, B, C, _ = _ssd_inputs(b, 1, h, p, n, 12, False)
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], state)
    (xt, dtt, At, Bt, Ct, st), jargs = _both(args)
    y, new = ops.ssd_step(xt, dtt, At, Bt, Ct, st)
    want_y, want_s = jref.ssd_step(*jargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(want_s), **SSD_TOL)
    assert y.dtype == torch.float32 and new.dtype == torch.float32


def test_ssd_step_continues_the_scan():
    """Inside the port: one ``ssd_step`` after a scan of ``s - 1`` steps is
    the scan of ``s`` steps (the prefill -> decode hand-off)."""
    (x, dt, A, B, C, _), _ = _both(_ssd_inputs(2, 12, 2, 4, 8, 13, False))
    y_full, s_full = ref.ssd(x, dt, A, B, C, return_state=True)
    _, s_part = ref.ssd(x[:, :-1], dt[:, :-1], A, B[:, :-1], C[:, :-1], return_state=True)
    y_step, s_step = ref.ssd_step(x[:, -1], dt[:, -1], A, B[:, -1], C[:, -1], s_part)
    torch.testing.assert_close(y_step, y_full[:, -1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s_step, s_full, rtol=1e-6, atol=1e-6)


def test_ssd_wrapper_on_cpu_runs_the_plain_version():
    (x, dt, A, B, C, s0), _ = _both(_ssd_inputs(1, 9, 2, 4, 8, 14, True))
    before = ssd_mod.launches
    got = ssd_mod.ssd(x, dt, A, B, C, chunk=4, initial_state=s0)
    assert torch.equal(got, ref.ssd(x, dt, A, B, C, initial_state=s0))
    assert ssd_mod.launches == before


def test_ssd_smem_reckoning():
    """The wrapper's shared-memory count is the kernel's layout: mamba2's
    full width with a chunk of 64 fits one block (the opt-in above 48 KB);
    a chunk of 256 does not."""
    assert 48 * 1024 < ssd_mod.smem_bytes(64, 128, 64) == 132864 <= 227 * 1024
    assert ssd_mod.smem_bytes(64, 128, 256) > 227 * 1024


# ---------------------------------------------------------------------------
# the modules and the model: reduced mamba2 against the JAX model
# ---------------------------------------------------------------------------
def _np_params(jmodel):
    """JAX ``init`` weights with the norm weights (zeros at init) perturbed,
    so that the ``(1 + w)`` scale is exercised."""
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    blocks = np_params["blocks"]
    for leaf_path in (("ln",), ("mamba", "norm"), ("mamba", "conv_b")):
        node = blocks
        for k in leaf_path[:-1]:
            node = node[k]
        leaf = node[leaf_path[-1]]
        node[leaf_path[-1]] = (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
    np_params["final_norm"] = (0.1 * rng.normal(size=np_params["final_norm"].shape)
                               ).astype(np.float32)
    return np_params


@pytest.fixture(scope="module")
def models():
    cfg = jax_get_config(ARCH, reduced=True)
    jmodel = build_model(cfg, backend="flash")
    np_params = _np_params(jmodel)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tmodel = DecoderLM(get_config(ARCH, reduced=True), device="cpu")
    return jmodel, jparams, tmodel, from_jax(np_params)


def _layer(jparams, tparams, li):
    return (jax.tree.map(lambda t: t[li], jparams["blocks"]["mamba"]),
            tparams["blocks"][li]["mamba"])


@pytest.mark.parametrize("with_init", [False, True])
def test_causal_conv1d_matches_jax(models, with_init):
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 7, conv_dim)).astype(np.float32)
    init = (rng.normal(size=(2, cfg.conv_kernel - 1, conv_dim)).astype(np.float32)
            if with_init else None)
    pj, pt = _layer(jparams, tparams, 1)
    want = jmod.causal_conv1d(jnp.asarray(x), pj["conv_w"], pj["conv_b"],
                              init=None if init is None else jnp.asarray(init))
    got = tmod.causal_conv1d(torch.from_numpy(x), pt["conv_w"], pt["conv_b"],
                             init=None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE_TOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_forward_matches_jax(models, carried, return_state):
    """The block over 13 tokens (chunk 8: one full chunk and a partial one),
    from zero or from a carried SSD state and conv history."""
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(21)
    b, s = 2, 13
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    state = conv = None
    if carried:
        state = rng.normal(size=(b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
                           ).astype(np.float32)
        conv = rng.normal(size=(b, cfg.conv_kernel - 1, cfg.ssm_inner + 2 * cfg.ssm_state)
                          ).astype(np.float32)
    pj, pt = _layer(jparams, tparams, 2)
    want = jmod.mamba_forward(
        pj, jnp.asarray(x), cfg, backend="flash",
        ssm_state=None if state is None else jnp.asarray(state),
        conv_state=None if conv is None else jnp.asarray(conv), return_state=return_state)
    got = tmod.mamba_forward(
        pt, torch.from_numpy(x), cfg,
        ssm_state=None if state is None else torch.from_numpy(state),
        conv_state=None if conv is None else torch.from_numpy(conv), return_state=return_state)
    if not return_state:
        want, got = (want,), (got,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **LOGIT_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)


def test_mamba_step_matches_jax(models):
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(22)
    b = 3
    x1 = rng.normal(size=(b, cfg.d_model)).astype(np.float32)
    state = rng.normal(size=(b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
                       ).astype(np.float32)
    conv = rng.normal(size=(b, cfg.conv_kernel - 1, cfg.ssm_inner + 2 * cfg.ssm_state)
                      ).astype(np.float32)
    pj, pt = _layer(jparams, tparams, 0)
    want = jmod.mamba_step(pj, jnp.asarray(x1), jnp.asarray(state), jnp.asarray(conv), cfg,
                           backend="flash")
    got = tmod.mamba_step(pt, torch.from_numpy(x1), torch.from_numpy(state),
                          torch.from_numpy(conv), cfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **LOGIT_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)


def test_forward_matches_jax(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    lj, aux_j = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    lt, aux_t = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and lt.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert float(aux_t) == float(aux_j) == 0.0


def _hold_caches(jcache, tcache):
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for name in ("ssm", "conv"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        assert tcache[name].dtype == torch.float32
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **STATE_TOL)


@pytest.mark.parametrize("s", [11, 16])
def test_prefill_then_decode_matches_jax(models, s):
    """A prefill of 3 rows (11 tokens: a partial chunk; 16: two full ones),
    then four decode steps: logits and every layer's state and conv history
    agree at every step."""
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    tokens = np.random.default_rng(s).integers(0, cfg.vocab_size, (3, s)).astype(np.int32)
    lj, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                jmodel.init_cache(3, 32, dtype="float32"))
    tcache = tmodel.init_cache(3, 32)
    lt = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    _hold_caches(jcache, tcache)
    nxt = np.asarray(lj).argmax(-1).astype(np.int32)
    for _ in range(4):
        lj, jcache = jmodel.decode(jparams, jnp.asarray(nxt), jcache)
        lt = tmodel.decode(tparams, torch.from_numpy(nxt), tcache)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        _hold_caches(jcache, tcache)
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)


def test_model_matches_jax_pallas_at_chunk_multiples(models):
    """Against the JAX model on its Pallas ``ssd`` (interpret mode), where
    every length is a multiple of the chunk: ``forward`` over 16 tokens and
    a prefill of 8, with its caches."""
    _, _, tmodel, tparams = models
    cfg = tmodel.cfg
    pmodel = build_model(jax_get_config(ARCH, reduced=True), backend="pallas")
    pparams = _np_params(pmodel)
    tparams = from_jax(pparams)
    pparams = jax.tree.map(jnp.asarray, pparams)
    rng = np.random.default_rng(30)
    tokens = rng.integers(0, cfg.vocab_size, (2, 2 * cfg.ssm_chunk)).astype(np.int32)
    lj, _ = pmodel.forward(pparams, {"tokens": jnp.asarray(tokens)})
    lt, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    short = tokens[:, : cfg.ssm_chunk]
    lj, jcache = pmodel.prefill(pparams, {"tokens": jnp.asarray(short)},
                                pmodel.init_cache(2, 16, dtype="float32"))
    tcache = tmodel.init_cache(2, 16)
    lt = tmodel.prefill(tparams, {"tokens": torch.from_numpy(short)}, tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    _hold_caches(jcache, tcache)


def test_ssm_refuses_ragged_prefill_and_paged_caches(models):
    """As the reference: right-padded lengths and a paged cache are for
    pure-attention caches only."""
    _, _, tmodel, tparams = models
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "lengths": torch.tensor([3, 8], dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="pad tokens"):
        tmodel.prefill(tparams, batch, tmodel.init_cache(2, 8))
    with pytest.raises(NotImplementedError, match="ssm/hybrid state is not paged"):
        tmodel.init_paged_cache(8, 4)


def test_ssm_cache_and_param_layout(models):
    jmodel, _, tmodel, tparams = models
    cfg = tmodel.cfg
    cache = tmodel.init_cache(3, 20)
    jcache = jmodel.init_cache(3, 20, dtype="float32")
    assert set(cache) == set(jcache) == set(tmodel.CACHE_BATCH_AXIS)
    for name, ax in tmodel.CACHE_BATCH_AXIS.items():
        assert tuple(cache[name].shape) == jcache[name].shape and cache[name].shape[ax] == 3
    bf = DecoderLM(cfg, device="cpu", dtype=torch.bfloat16).init_cache(1, 4)
    assert bf["ssm"].dtype == torch.float32 and bf["conv"].dtype == torch.bfloat16
    # tied embeddings: no lm_head, the same leaves and shapes as JAX's tree
    fresh = tmodel.init(seed=0)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert "lm_head" not in fresh and shapes(fresh) == shapes(tparams)


def test_bf16_params_keep_the_ssd_scalars_float32(models):
    """In a bf16 model A_log, D and dt_bias stay float32, whether drawn by
    ``init`` or bridged by ``from_jax`` (JAX's ``_cast_mamba``), and the
    inits span the reference's ranges."""
    jmodel, _, tmodel, _ = models
    model = DecoderLM(tmodel.cfg, device="cpu", dtype=torch.bfloat16)
    bridged = from_jax(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1))),
                       dtype=torch.bfloat16)
    for params in (model.init(seed=1), bridged):
        blk = params["blocks"][0]["mamba"]
        for name, leaf in blk.items():
            want = torch.float32 if name in ("A_log", "D", "dt_bias") else torch.bfloat16
            assert leaf.dtype == want, name
        assert params["embed"].dtype == torch.bfloat16
        a = torch.exp(blk["A_log"])
        assert bool(((a >= 1.0 - 1e-5) & (a <= 16.0 + 1e-4)).all())
        dt = torch.nn.functional.softplus(blk["dt_bias"])
        assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6)).all())
        assert torch.equal(blk["D"], torch.ones_like(blk["D"]))


# ---------------------------------------------------------------------------
# the engines: static generate and serve_continuous against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(models):
    jmodel, jparams, tmodel, tparams = models
    jengine = jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=32)
    tengine = teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=32, device="cpu")
    return tmodel.cfg, jengine, tengine


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]


def _requests(mod, prompts, max_new):
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


@pytest.mark.parametrize("lens,seed", [((3, 11, 7), 5), ((9, 9), 6), ((16,), 7)])
def test_generate_tokens_equal_jax(engines, lens, seed):
    cfg, jengine, tengine = engines
    prompts = _prompts(cfg, lens, seed)
    want = jengine.generate(prompts, max_new_tokens=5)
    got = tengine.generate(prompts, max_new_tokens=5)
    assert len(np.unique(want.tokens)) > 1          # a comparison that can fail
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens_per_s > 0 and got.prefill_s > 0


@pytest.mark.parametrize("lens,max_new,slots,seed", [
    ((3, 11, 7), (3, 5, 2), 2, 5),
    ((6, 2, 9, 4, 12), (4, 2, 3, 5, 1), 3, 8),
])
def test_serve_continuous_equals_jax(engines, lens, max_new, slots, seed):
    """Tokens, slots, admission and finish steps and the step count."""
    cfg, jengine, tengine = engines
    prompts = _prompts(cfg, lens, seed)
    want = jengine.serve_continuous(_requests(jeng, prompts, max_new), num_slots=slots)
    got = tengine.serve_continuous(_requests(teng, prompts, max_new), num_slots=slots)
    assert len(np.unique(np.concatenate([r.tokens for r in want.results]))) > 1
    assert got.steps == want.steps and got.total_tokens == want.total_tokens
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.request_id, a.slot, a.admit_step, a.finish_step) == \
               (b.request_id, b.slot, b.admit_step, b.finish_step)
    assert got.prefill_tokens == sum(lens)


def test_pad_prompts_left_pads_to_the_longest(engines):
    cfg, jengine, tengine = engines
    prompts = _prompts(cfg, (3, 7, 5), 9)
    got, lens = tengine._pad_prompts(prompts, 4)
    want, _ = jengine._pad_prompts(prompts, 4)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 7) and lens.tolist() == [3, 7, 5]
    assert (got[0, :4] == 0).all() and (got[0, 4:] == prompts[0]).all()
    assert tengine._kv_bucket(9) is None
    with pytest.raises(ValueError, match="max_seq"):
        tengine._pad_prompts(prompts, 26)


def test_serve_continuous_budgets_from_the_padded_length(engines):
    """A left-padded slot starts at the longest prompt: a short request
    whose own prompt fits ``max_seq`` but not from there is refused."""
    cfg, _, tengine = engines
    reqs = _requests(teng, _prompts(cfg, (20, 4), 10), (2, 20))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tengine.serve_continuous(reqs)


def test_ssm_engines_launch_only_ssd_and_rmsnorm(engines, monkeypatch):
    """generate and serve_continuous reach ssd once per layer per prefill
    and rmsnorm 2L + 1 times per pass, and no attention kernel; serve_paged
    refuses the family (on the card chip_smoke.py counts the launches)."""
    cfg, _, tengine = engines
    calls = []
    for name in ("paged_attention", "varlen_prefill", "spec_verify", "flash_attention",
                 "decode_attention", "ssd", "rmsnorm"):
        fn = getattr(ops, f"_{name}")
        monkeypatch.setattr(ops, f"_{name}",
                            lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    tengine.generate(_prompts(cfg, (5, 7), 3), max_new_tokens=3)
    cont = tengine.serve_continuous(_requests(teng, _prompts(cfg, (4, 6, 5), 4), (2, 3, 2)))
    L = cfg.num_layers
    passes, steps = 1 + 3, 3 + cont.steps        # generate: 1 prefill, 3 steps
    assert calls.count("ssd") == L * passes
    assert calls.count("rmsnorm") == (2 * L + 1) * (passes + steps)
    assert len(calls) == L * passes + (2 * L + 1) * (passes + steps)
    with pytest.raises(NotImplementedError, match="not paged"):
        tengine.serve_paged(_requests(teng, _prompts(cfg, (4,), 1), (2,)))


def test_model_path_hands_the_kernels_what_they_take(models, monkeypatch):
    """On the CPU the wrappers run their plain versions, which take any
    layout; the CUDA kernels do not.  Every rmsnorm input of prefill,
    decode and forward is contiguous, and every ssd input has the layout
    the kernel's strides describe."""
    _, _, tmodel, tparams = models
    seen = {"rmsnorm": 0, "ssd": 0}

    def rmsnorm(x, w, eps=1e-6, _f=ops._rmsnorm):
        assert x.is_contiguous() and w.is_contiguous() and w.dtype == x.dtype
        seen["rmsnorm"] += 1
        return _f(x, w, eps)

    def ssd(x, dt, A, B, C, _f=ops._ssd, **kw):
        p = x.shape[3]
        assert x.stride(3) == 1 and x.stride(2) == p and B.stride(2) == C.stride(2) == 1
        assert dt.is_contiguous() and dt.dtype == A.dtype == torch.float32
        seen["ssd"] += 1
        return _f(x, dt, A, B, C, **kw)

    monkeypatch.setattr(ops, "_rmsnorm", rmsnorm)
    monkeypatch.setattr(ops, "_ssd", ssd)
    tokens = torch.from_numpy(np.random.default_rng(31).integers(0, 256, (2, 11)).astype(np.int32))
    cache = tmodel.init_cache(2, 16)
    logits = tmodel.prefill(tparams, {"tokens": tokens}, cache)
    tmodel.decode(tparams, logits.argmax(-1).to(torch.int32), cache)
    tmodel.forward(tparams, {"tokens": tokens})
    L = tmodel.cfg.num_layers
    assert seen == {"rmsnorm": 3 * (2 * L + 1), "ssd": 2 * L}


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_driver_serves_mamba_on_cpu(capsys, engine):
    assert tlaunch.main([
        "--arch", ARCH, "--device", "cpu", "--engine", engine, "--requests", "4",
        "--prompt-len", "12", "--prompt-len-min", "3", "--max-new-tokens", "3",
        "--engine-batch", "2", "--max-seq", "24", "--rate-hz", "500",
    ]) == 0
    out = capsys.readouterr().out
    assert "mamba2-130m-reduced on cpu" in out and f"engine {engine}" in out
    assert "generated_tokens     12" in out


def test_driver_refuses_the_paged_engine_for_ssm(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", ARCH, "--device", "cpu", "--engine", "paged"])
    assert "ssm/hybrid state is not paged" in capsys.readouterr().err

