"""The enc-dec family of the port (whisper-large-v3, reduced) against the
JAX package: ``sinusoidal``, the non-gated MLP's tanh GELU, the cross
block's parameters, ``attn_full`` with ``kv_from`` and no RoPE,
``attn_decode`` without RoPE, ``cross_attn_decode`` over the padded cross
cache; the model's ``encode``, ``forward``, and ``prefill`` + ``decode``
with their caches, on a uniform and on a right-padded batch, at
``encoder_seq`` 16 and 20 (20 is not a multiple of 16: the port's cross
cache holds 32 slots, the reference's 20).

Weights come from the JAX model's ``init`` through ``from_jax`` (the norm
weights perturbed so that their ``(1 + w)`` scale is exercised); inputs
from numpy with fixed seeds.  The JAX model is ``build_model(cfg,
backend="flash")`` (the JAX driver's default), and at ``encoder_seq`` 16
with prompts of 16 and 8 tokens (the widths of the JAX suite's Pallas
checks) also ``backend="pallas"``, its Pallas kernels in interpret mode.
Tolerances in float32: logits and activations 1e-4 (rtol and atol:
summation order of the matrix products), caches 5e-5, the sinusoidal
table 1e-6 + 2e-7 per position (XLA's float32 ``exp`` and torch's differ
by an ulp on a few frequencies, which the position multiplies).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import modules as jmod
from repro_torch.configs import get_config
from repro_torch.models import DecoderLM, EncDecLM, build_model, from_jax
from repro_torch.models import modules as tmod

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=5e-5, atol=5e-5)
# the sinusoidal table: 1e-6 plus 2e-7 per position (the same angles up to
# one float32 ulp of a frequency, times the position, through sin/cos)
TABLE_ATOL, TABLE_PER_POSITION = 1e-6, 2e-7
ARCH = "whisper-large-v3"
ENCODER_SEQS = (16, 20)
MAX_SEQ = 32


def _np_params(jmodel):
    """JAX ``init`` weights with every norm weight (zeros at init) perturbed."""
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    bump = lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    for name in ("ln1", "ln2"):
        np_params["enc_blocks"][name] = bump(np_params["enc_blocks"][name])
    for name in ("ln1", "ln2", "ln3"):
        np_params["dec_blocks"][name] = bump(np_params["dec_blocks"][name])
    for name in ("enc_norm", "final_norm"):
        np_params[name] = bump(np_params[name])
    return np_params


def _pair(cfg, backend="flash"):
    jmodel = jax_build_model(cfg, backend=backend)
    np_params = _np_params(jmodel)
    return (jmodel, jax.tree.map(jnp.asarray, np_params), build_model(cfg, device="cpu"),
            from_jax(np_params))


@pytest.fixture(scope="module", params=ENCODER_SEQS, ids=lambda s: f"Se{s}")
def models(request):
    return _pair(jax_get_config(ARCH, reduced=True).replace(encoder_seq=request.param))


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).normal(size=(b, cfg.encoder_seq, cfg.d_model)
                                              ).astype(np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d_model", [2, 64, 1280])
@pytest.mark.parametrize("shape", [(1500,), (3, 1)])
def test_sinusoidal_matches_the_reference(d_model, shape):
    """Positions (s,) as the encoder and prefill pass them and (b, 1) as
    decode does; d_model 2 takes the denominator's ``max(half - 1, 1)``."""
    pos = np.random.default_rng(d_model).integers(0, 1500, shape).astype(np.int32)
    if len(shape) == 1:
        pos = np.arange(shape[0], dtype=np.int32)
    want = np.asarray(jmod.sinusoidal(jnp.asarray(pos), d_model))
    got = tmod.sinusoidal(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # XLA's float32 exp and torch's differ by an ulp on a few frequencies
    # (<= 1): the angle at position p then moves by up to p * 2**-23
    err = np.abs(got.numpy() - want)
    assert (err <= TABLE_ATOL + TABLE_PER_POSITION * pos[..., None]).all(), err.max()


def _mlp_case(seed):
    rng = np.random.default_rng(seed)
    p = {"w_up": rng.normal(scale=0.5, size=(16, 32)).astype(np.float32),
         "w_down": rng.normal(scale=0.2, size=(32, 16)).astype(np.float32)}
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = np.asarray(jmod.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    return {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), want


@pytest.mark.parametrize("seed", [0, 1])
def test_non_gated_mlp_is_the_tanh_gelu(seed):
    """``mlp_apply`` without ``w_gate`` matches ``jax.nn.gelu``'s default
    (the tanh approximation) within 1e-5; the exact erf GELU misses it."""
    p, x, want = _mlp_case(seed)
    np.testing.assert_allclose(tmod.mlp_apply(p, x).numpy(), want, rtol=1e-5, atol=1e-5)
    erf = torch.nn.functional.gelu(x @ p["w_up"]) @ p["w_down"]
    assert np.abs(erf.numpy() - want).max() > 1e-4


def test_non_gated_defs_and_the_cross_block_match_the_reference():
    cfg = get_config(ARCH, reduced=True).replace(qk_norm=True)
    assert set(tmod.mlp_defs(cfg, gated=False)) == set(jmod.mlp_defs(cfg, (), gated=False))
    assert set(tmod.mlp_defs(cfg)) == set(jmod.mlp_defs(cfg, ()))
    for cross in (False, True):
        assert set(tmod.attn_defs(cfg, cross=cross)) == set(jmod.attn_defs(cfg, (), cross=cross))
    assert "q_norm" not in tmod.attn_defs(cfg, cross=True)


def test_attn_full_cross_and_without_rope_match_jax(models):
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[1], jparams["dec_blocks"])
    tblk = tparams["dec_blocks"][1]
    y_j, (k_j, v_j) = jmod.attn_full(jblk["cross_attn"], jnp.asarray(x), cfg, backend="flash",
                                     use_rope=False, kv_from=jnp.asarray(enc), return_kv=True)
    y_t, (k_t, v_t) = tmod.attn_full(tblk["cross_attn"], torch.from_numpy(x), cfg,
                                     use_rope=False, kv_from=torch.from_numpy(enc),
                                     return_kv=True)
    assert tuple(k_t.shape) == (2, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), **CACHE_TOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **CACHE_TOL)
    # self-attention without RoPE, causal; and the non-causal encoder form
    for causal in (True, False):
        y_j = jmod.attn_full(jblk["self_attn"], jnp.asarray(x), cfg, backend="flash",
                             causal=causal, use_rope=False)
        y_t = tmod.attn_full(tblk["self_attn"], torch.from_numpy(x), cfg, causal=causal,
                             use_rope=False)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)
    # with RoPE the output differs: use_rope=False really drops it
    roped = tmod.attn_full(tblk["self_attn"], torch.from_numpy(x), cfg)
    assert not np.allclose(roped.numpy(), np.asarray(y_j), **LOGIT_TOL)


@pytest.mark.parametrize("uniform,pos", [(True, [5, 5]), (False, [3, 11])])
def test_attn_decode_without_rope_matches_jax(models, uniform, pos):
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(sum(pos))
    kc, vc = (rng.normal(size=(2, 16, cfg.num_kv_heads, cfg.resolved_head_dim)
                         ).astype(np.float32) for _ in range(2))
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    jblk = jax.tree.map(lambda a: a[0], jparams["dec_blocks"])["self_attn"]
    y_j, kc_j, vc_j = jmod.attn_decode(jblk, jnp.asarray(x1), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(pos), cfg, backend="flash", use_rope=False,
                                       uniform_pos=uniform)
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y_t = tmod.attn_decode(tparams["dec_blocks"][0]["self_attn"], torch.from_numpy(x1), kc_t,
                           vc_t, torch.from_numpy(pos), cfg, use_rope=False,
                           uniform_pos=uniform)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **CACHE_TOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j), **CACHE_TOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)


def test_cross_attn_decode_reads_encoder_seq_keys_of_the_padded_cache(models):
    """The port's cross cache holds ``cross_len`` slots (a multiple of 16);
    the slots past ``encoder_seq`` are never read: filled with large
    values they change nothing, and the result is the reference's over a
    cache of ``encoder_seq`` slots."""
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    Se, Sx = cfg.encoder_seq, tmodel.cross_len
    assert Sx % 16 == 0 and Se <= Sx < Se + 16
    rng = np.random.default_rng(9)
    kx, vx = (rng.normal(size=(3, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
                         ).astype(np.float32) for _ in range(2))
    x1 = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[1], jparams["dec_blocks"])["cross_attn"]
    want = np.asarray(jmod.cross_attn_decode(jblk, jnp.asarray(x1), jnp.asarray(kx),
                                             jnp.asarray(vx), cfg, backend="flash"))
    pad = lambda a: np.concatenate(
        [a, np.full((3, Sx - Se) + a.shape[2:], 1e4, np.float32)], axis=1)
    got = tmod.cross_attn_decode(tparams["dec_blocks"][1]["cross_attn"], torch.from_numpy(x1),
                                 torch.from_numpy(pad(kx)), torch.from_numpy(pad(vx)), cfg)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_from_jax_splits_the_encoder_and_decoder_stacks(models):
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    assert len(tparams["enc_blocks"]) == cfg.encoder_layers
    assert len(tparams["dec_blocks"]) == cfg.num_layers
    np.testing.assert_array_equal(tparams["dec_blocks"][1]["cross_attn"]["wk"].numpy(),
                                  np.asarray(jparams["dec_blocks"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(tparams["enc_blocks"][0]["mlp"]["w_up"].numpy(),
                                  np.asarray(jparams["enc_blocks"]["mlp"]["w_up"][0]))
    # the port's own definitions: the same leaves and shapes
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(tmodel.init(seed=0)) == shapes(tparams)
    assert isinstance(tmodel, EncDecLM) and not tmodel.stateful


def test_decoder_lm_refuses_the_family_and_build_model_routes_it():
    cfg = get_config(ARCH, reduced=True)
    with pytest.raises(NotImplementedError, match="family encdec"):
        DecoderLM(cfg, device="cpu")
    assert isinstance(build_model(cfg, device="cpu"), EncDecLM)
    assert isinstance(build_model(get_config("glm4-9b", reduced=True), device="cpu"), DecoderLM)
    with pytest.raises(ValueError, match="takes family encdec"):
        EncDecLM(get_config("glm4-9b", reduced=True), device="cpu")


@pytest.mark.parametrize("what", ["decode_paged", "decode_spec", "prefill_packed",
                                  "prefill_paged_chunk", "paged_cache_defs",
                                  "init_paged_cache"])
def test_paged_methods_raise(what):
    model = build_model(get_config(ARCH, reduced=True), device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        getattr(model, what)(None, None, None)


def test_encode_matches_jax(models):
    jmodel, jparams, tmodel, tparams = models
    frames = _frames(tmodel.cfg, 2, 1)
    want = np.asarray(jmodel.encode(jparams, jnp.asarray(frames)))
    got = tmodel.encode(tparams, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_frames_take_the_models_dtype(monkeypatch):
    """A bf16 model casts float32 frames to bf16 on entry (the reference
    promotes its encoder to float32), so its encoder stays in bf16."""
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    params = model.init(seed=0)
    frames = torch.from_numpy(_frames(cfg, 1, 2))
    seen = []
    real = tmod.ops.attention
    monkeypatch.setattr(tmod.ops, "attention",
                        lambda q, *a, **kw: seen.append(q.dtype) or real(q, *a, **kw))
    enc = model.encode(params, frames)
    assert enc.dtype == torch.bfloat16 and seen == [torch.bfloat16] * cfg.encoder_layers


def test_forward_matches_jax(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    frames = _frames(cfg, 2, 3)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    lj, aux_j = jmodel.forward(jparams, {"frames": jnp.asarray(frames),
                                         "tokens": jnp.asarray(tokens)})
    lt, aux_t = tmodel.forward(tparams, {"frames": torch.from_numpy(frames),
                                         "tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and lt.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert float(aux_t) == float(aux_j) == 0.0


def _hold_caches(tmodel, jcache, tcache):
    Se = tmodel.cfg.encoder_seq
    assert set(tcache) == set(jcache) == {"pos", "k", "v", "k_cross", "v_cross"}
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **CACHE_TOL)
    for name in ("k_cross", "v_cross"):
        assert tcache[name].shape[2] == tmodel.cross_len
        np.testing.assert_allclose(tcache[name].numpy()[:, :, :Se], np.asarray(jcache[name]),
                                   **CACHE_TOL)
        assert not tcache[name][:, :, Se:].any()          # the pad slots stay zero


def _prefill_decode(jmodel, jparams, tmodel, tparams, tokens, lengths, steps=4):
    """Prefill then ``steps`` greedy decode steps on both models, the logits
    and caches held at every step."""
    cfg = tmodel.cfg
    b = tokens.shape[0]
    frames = _frames(cfg, b, 6)
    uniform = lengths is None
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
    if not uniform:
        jb["lengths"], tb["lengths"] = jnp.asarray(lengths), torch.from_numpy(lengths)
    jcache = jmodel.init_cache(b, MAX_SEQ, dtype="float32")
    tcache = tmodel.init_cache(b, MAX_SEQ)
    lj, jcache = jmodel.prefill(jparams, jb, jcache)
    lt = tmodel.prefill(tparams, tb, tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    _hold_caches(tmodel, jcache, tcache)
    nxt = np.asarray(lj).argmax(-1).astype(np.int32)
    for _ in range(steps):
        lj, jcache = jmodel.decode(jparams, jnp.asarray(nxt), jcache, uniform_pos=uniform,
                                   kv_bound=MAX_SEQ)
        lt = tmodel.decode(tparams, torch.from_numpy(nxt), tcache, uniform_pos=uniform,
                           kv_bound=MAX_SEQ)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        _hold_caches(tmodel, jcache, tcache)
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "right-padded"])
def test_prefill_and_decode_match_jax(models, ragged):
    """A uniform batch of 11-token prompts, and prompts of 11, 4 and 7
    tokens right-padded to 11 with ``lengths`` (each row's logits at its own
    last token, decode at its own position)."""
    jmodel, jparams, tmodel, tparams = models
    tokens = np.random.default_rng(7).integers(0, tmodel.cfg.vocab_size, (3, 11)
                                               ).astype(np.int32)
    lengths = None
    if ragged:
        lengths = np.asarray([11, 4, 7], np.int32)
        for i, n in enumerate(lengths):
            tokens[i, n:] = 0
    _prefill_decode(jmodel, jparams, tmodel, tparams, tokens, lengths)


@pytest.fixture(scope="module")
def pallas_models():
    return _pair(jax_get_config(ARCH, reduced=True), backend="pallas")


@pytest.mark.parametrize("s", [16, 8])
def test_prefill_and_decode_match_jax_pallas(pallas_models, s):
    """The reference on its Pallas kernels (interpret mode) at encoder_seq
    16: flash over the prompt and the frames, decode_attention over the
    self and the cross caches."""
    jmodel, jparams, tmodel, tparams = pallas_models
    tokens = np.random.default_rng(s).integers(0, tmodel.cfg.vocab_size, (2, s)).astype(np.int32)
    _prefill_decode(jmodel, jparams, tmodel, tparams, tokens, None, steps=2)


def test_forward_instrumented_names_and_logits(models):
    _, _, tmodel, tparams = models
    cfg = tmodel.cfg
    batch = {"frames": torch.from_numpy(_frames(cfg, 2, 8)),
             "tokens": torch.from_numpy(np.random.default_rng(8).integers(
                 0, cfg.vocab_size, (2, 9)).astype(np.int32))}
    seen = []

    def hook(name, thunk):
        seen.append(name)
        return thunk()

    got = tmodel.forward_instrumented(tparams, batch, hook)
    assert torch.equal(got, tmodel.forward(tparams, batch)[0])
    assert seen == (["enc_embed"] + [f"enc_layer_{l:03d}" for l in range(cfg.encoder_layers)]
                    + ["enc_norm", "dec_embed"]
                    + [f"dec_layer_{l:03d}" for l in range(cfg.num_layers)] + ["logits"])
