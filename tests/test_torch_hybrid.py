"""The hybrid family of the port (zamba2-2.7b, reduced) against the JAX
package: ``attn_decode`` on a ring cache; the model's ``forward``,
``prefill`` and ``decode`` with their caches, past the ring's wrap and
after a prompt longer than the ring; ``forward_instrumented``'s layer
names; the static and continuous engines' greedy tokens and schedules; the
paged refusals in the model and the driver.

Weights come from the JAX model's ``init`` through ``from_jax`` (the norm
weights perturbed so that their ``(1 + w)`` scale is exercised); inputs
from numpy with fixed seeds.  The JAX model is ``build_model(cfg,
backend="flash")`` (the JAX driver's default backend; its ``ssd`` zero-pads
a partial chunk, where the Pallas ``ssd`` gives NaN: see
``test_torch_ssm.py``).  Tolerances as for the SSM family in float32:
logits 1e-4, states, conv histories and K/V 5e-5 (summation order of the
matrix products and the scan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.models import modules as jmod
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM, from_jax, lm
from repro_torch.models import modules as tmod
from repro_torch.serve import engine as teng

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=5e-5, atol=5e-5)
ARCH = "zamba2-2.7b"
RING = 8                    # long_context_window of the wrap checks
LONG = 100_000              # a max_seq past the ring threshold


def _np_params(jmodel):
    """JAX ``init`` weights with every norm weight (zeros at init) and the
    conv bias perturbed."""
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    bump = lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    blocks, shared = np_params["blocks"], np_params["shared"]
    blocks["ln"] = bump(blocks["ln"])
    for name in ("norm", "conv_b"):
        blocks["mamba"][name] = bump(blocks["mamba"][name])
    for name in ("ln1", "ln2"):
        shared[name] = bump(shared[name])
    np_params["final_norm"] = bump(np_params["final_norm"])
    return np_params


def _pair(cfg):
    jmodel = build_model(cfg, backend="flash")
    np_params = _np_params(jmodel)
    return (jmodel, jax.tree.map(jnp.asarray, np_params), DecoderLM(cfg, device="cpu"),
            from_jax(np_params))


@pytest.fixture(scope="module")
def models():
    return _pair(jax_get_config(ARCH, reduced=True))


@pytest.fixture(scope="module")
def ring_models():
    """Reduced zamba2 with a ring of RING slots (the JAX suite's wrap check)."""
    return _pair(jax_get_config(ARCH, reduced=True).replace(long_context_window=RING))


# ---------------------------------------------------------------------------
# the ring in attn_decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("uniform,pos", [
    (True, [3, 3, 3]),
    (True, [21, 21, 21]),                # wrapped: slot 21 % 8
    (False, [2, 9, 30]),                 # per-row slots, two rows wrapped
    (False, [0, 7, 8]),                  # the first wrap
])
def test_attn_decode_ring_matches_jax(models, uniform, pos):
    """Every row writes at ``pos % S`` (idle slots past the ring too, as the
    reference's masked write does) and attends ``min(pos + 1, S)`` keys."""
    _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(sum(pos))
    kc, vc = (rng.normal(size=(3, RING, cfg.num_kv_heads, cfg.resolved_head_dim)
                         ).astype(np.float32) for _ in range(2))
    x1 = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    y_j, kc_j, vc_j = jmod.attn_decode(
        jparams["shared"]["attn"], jnp.asarray(x1), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos), cfg, backend="flash", ring=True, uniform_pos=uniform)
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y_t = tmod.attn_decode(tparams["shared"]["attn"], torch.from_numpy(x1), kc_t, vc_t,
                           torch.from_numpy(pos), cfg, ring=True, uniform_pos=uniform,
                           window=3, kv_bound=2)       # both ignored on a ring
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **STATE_TOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j), **STATE_TOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)
    assert not np.array_equal(kc_t.numpy(), kc)       # the write landed


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_from_jax_carries_the_shared_block(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    assert set(tparams["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    np.testing.assert_array_equal(tparams["shared"]["attn"]["wq"].numpy(),
                                  np.asarray(jparams["shared"]["attn"]["wq"]))
    np.testing.assert_array_equal(tparams["shared"]["ln2"].numpy(),
                                  np.asarray(jparams["shared"]["ln2"]))
    assert len(tparams["blocks"]) == cfg.num_layers
    # the port's own definitions: the same leaves and shapes
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(tmodel.init(seed=0)) == shapes(tparams)
    assert tmodel.stateful and tmodel.hybrid and not tmodel.ssm


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
    assert set(tcache) == set(jcache) == {"pos", "ssm", "conv", "k", "v"}
    for name in ("ssm", "conv", "k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **STATE_TOL)


def _prefill_decode(pair, b, s, max_seq, steps, seed):
    """Prefill ``b`` rows of ``s`` tokens, then ``steps`` greedy decode
    steps in both models: logits and every cache leaf agree at each step.
    Returns the port's cache."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lj, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                jmodel.init_cache(b, max_seq, dtype="float32"))
    tcache = tmodel.init_cache(b, max_seq)
    lt = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    _hold_caches(jcache, tcache)
    nxt = np.asarray(lj).argmax(-1).astype(np.int32)
    for _ in range(steps):
        lj, jcache = jmodel.decode(jparams, jnp.asarray(nxt), jcache)
        lt = tmodel.decode(tparams, torch.from_numpy(nxt), tcache)
        assert np.isfinite(lt.numpy()).all()
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        _hold_caches(jcache, tcache)
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)
    return tcache


@pytest.mark.parametrize("s", [11, 16])
def test_prefill_then_decode_matches_jax(models, s):
    """3 rows of 11 tokens (a partial chunk) or 16 (two whole chunks), then
    four decode steps, on a plain cache of 32 slots."""
    tcache = _prefill_decode(models, 3, s, 32, 4, s)
    assert int(tcache["pos"][0]) == s + 4 and tcache["k"].shape[2] == 32


@pytest.mark.parametrize("s,steps", [(20, 12), (5, 12)])
def test_ring_wrap_matches_jax(ring_models, s, steps):
    """``max_seq`` 100000 puts the shared attention on a ring of 8 slots (the
    JAX suite's long-context check): a 20-token prompt, longer than the ring
    (the prefill's roll), and a 5-token one that wraps while decoding;
    logits and caches at every step, and ``pos`` at the end."""
    tmodel = ring_models[2]
    assert tmodel.cache_len(LONG) == RING
    tcache = _prefill_decode(ring_models, 2, s, LONG, steps, 40 + s)
    assert tcache["k"].shape[2] == RING and int(tcache["pos"][0]) == s + steps


def test_ring_starts_past_the_threshold(models):
    tmodel = models[2]
    cfg = tmodel.cfg
    assert lm.RING_THRESHOLD == 65_536
    assert tmodel.cache_len(lm.RING_THRESHOLD) == lm.RING_THRESHOLD
    assert tmodel.cache_len(lm.RING_THRESHOLD + 1) == cfg.long_context_window
    defs = tmodel.cache_defs(3, 200_000)
    G, E = cfg.num_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every
    assert defs["k"].shape == (G, 3, cfg.long_context_window, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
    assert defs["ssm"].shape[:3] == (G, E, 3) and defs["conv"].shape[:3] == (G, E, 3)
    cache = tmodel.init_cache(3, 20)
    for name, ax in tmodel.CACHE_BATCH_AXIS.items():
        assert cache[name].shape[ax] == 3
    assert cache["ssm"].dtype == torch.float32 and cache["pos"].dtype == torch.int32


def test_forward_instrumented_names_the_layers_as_the_reference(models):
    """``layer_{l:03d}_mamba`` for every Mamba-2 layer and, after each group,
    ``layer_{g:03d}_shared_attn``; the pieces give ``forward``'s bits."""
    _, _, tmodel, tparams = models
    cfg = tmodel.cfg
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 9)).astype(np.int32))
    names = []
    out = tmodel.forward_instrumented(tparams, {"tokens": tokens},
                                      lambda name, thunk: names.append(name) or thunk())
    E = cfg.hybrid_attn_every
    want = ["embed"]
    for l in range(cfg.num_layers):
        want.append(f"layer_{l:03d}_mamba")
        if l % E == E - 1:
            want.append(f"layer_{l // E:03d}_shared_attn")
    assert names == want + ["logits"]
    assert torch.equal(out, tmodel.forward(tparams, {"tokens": tokens})[0])


def test_paged_paths_refuse_the_family(models):
    """As the reference: the hybrid state is not paged, on every paged
    entry point, and a right-padded prefill is refused."""
    _, _, tmodel, tparams = models
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ssm/hybrid state is not paged"):
        tmodel.init_paged_cache(8, 4)
    for call in (lambda: tmodel.decode_paged(tparams, z(1), {}, z(1, 2), z(1)),
                 lambda: tmodel.decode_spec(tparams, z(1, 2), {}, z(1, 2), z(1), z(1)),
                 lambda: tmodel.prefill_packed(tparams, {"tokens": z(1, 4)}, {}),
                 lambda: tmodel.prefill_paged_chunk(tparams, z(1, 4), {}, z(2), 3, 0)):
        with pytest.raises(NotImplementedError, match="ssm/hybrid state is not paged"):
            call()
    batch = {"tokens": z(2, 8), "lengths": torch.tensor([3, 8], dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="pad tokens"):
        tmodel.prefill(tparams, batch, tmodel.init_cache(2, 8))


def test_model_path_hands_the_kernels_what_they_take(models, monkeypatch):
    """Every attention input of prefill, decode and forward is contiguous
    (the CUDA kernels take no other layout), int32 lengths, and each
    kernel is reached as often as the family's layout implies: one flash
    attention a group and pass, one decode attention a group and step, one
    ssd a layer and pass, 2L + 2G + 1 rmsnorm a pass and a step."""
    _, _, tmodel, tparams = models
    cfg = tmodel.cfg
    seen = {"flash_attention": 0, "decode_attention": 0, "ssd": 0, "rmsnorm": 0}

    def spy(name, check):
        real = getattr(ops, f"_{name}")

        def fn(*a, **kw):
            check(*a, **kw)
            seen[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(ops, f"_{name}", fn)

    def contiguous(*a, **kw):
        assert all(t.is_contiguous() for t in a if isinstance(t, torch.Tensor))

    def decode(q, k, v, lengths, **kw):
        contiguous(q, k, v, lengths)
        assert lengths.dtype == torch.int32 and kw.get("kv_bound") is None

    spy("flash_attention", contiguous)
    spy("decode_attention", decode)
    spy("ssd", lambda *a, **kw: None)
    spy("rmsnorm", contiguous)
    tokens = torch.from_numpy(np.random.default_rng(31).integers(0, 256, (2, 11)).astype(np.int32))
    cache = tmodel.init_cache(2, LONG)
    logits = tmodel.prefill(tparams, {"tokens": tokens}, cache)
    tmodel.decode(tparams, logits.argmax(-1).to(torch.int32), cache, uniform_pos=False)
    tmodel.forward(tparams, {"tokens": tokens})
    L = cfg.num_layers
    G = L // cfg.hybrid_attn_every
    assert seen == {"flash_attention": 2 * G, "decode_attention": G, "ssd": 2 * L,
                    "rmsnorm": 3 * (2 * L + 2 * G + 1)}


# ---------------------------------------------------------------------------
# the engines: static generate and serve_continuous against the JAX engine
# ---------------------------------------------------------------------------
def _engines(pair, max_seq):
    jmodel, jparams, tmodel, tparams = pair
    return (tmodel.cfg, jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=max_seq),
            teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=max_seq, device="cpu"))


@pytest.fixture(scope="module")
def engines(models):
    return _engines(models, 32)


@pytest.fixture(scope="module")
def ring_engines(ring_models):
    return _engines(ring_models, LONG)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]


def _requests(mod, prompts, max_new):
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


@pytest.mark.parametrize("which,lens,new,seed", [
    ("plain", (3, 11, 7), 5, 5),
    ("plain", (16,), 5, 7),
    ("ring", (12, 5), 10, 8),            # the 12-token prompt rolls, both wrap
])
def test_generate_tokens_equal_jax(engines, ring_engines, which, lens, new, seed):
    cfg, jengine, tengine = engines if which == "plain" else ring_engines
    prompts = _prompts(cfg, lens, seed)
    want = jengine.generate(prompts, max_new_tokens=new)
    got = tengine.generate(prompts, max_new_tokens=new)
    assert len(np.unique(want.tokens)) > 1          # a comparison that can fail
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens_per_s > 0 and got.prefill_s > 0


@pytest.mark.parametrize("which,lens,max_new,slots,seed", [
    ("plain", (3, 11, 7), (3, 5, 2), 2, 5),
    ("plain", (6, 2, 9, 4, 12), (4, 2, 3, 5, 1), 3, 8),
    ("ring", (6, 2, 9, 4), (6, 3, 9, 4), 2, 9),     # slots past the ring, idle ones too
])
def test_serve_continuous_equals_jax(engines, ring_engines, which, lens, max_new, slots, seed):
    """Tokens, slots, admission and finish steps and the step count."""
    cfg, jengine, tengine = engines if which == "plain" else ring_engines
    prompts = _prompts(cfg, lens, seed)
    want = jengine.serve_continuous(_requests(jeng, prompts, max_new), num_slots=slots)
    got = tengine.serve_continuous(_requests(teng, prompts, max_new), num_slots=slots)
    assert len(np.unique(np.concatenate([r.tokens for r in want.results]))) > 1
    assert got.steps == want.steps and got.total_tokens == want.total_tokens
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.request_id, a.slot, a.admit_step, a.finish_step) == \
               (b.request_id, b.slot, b.admit_step, b.finish_step)


def test_engines_left_pad_and_decode_unbounded(engines):
    """The hybrid state absorbs pads: exact-length, left-padded prompts and
    no bound on the live lengths, as the reference's engine."""
    cfg, jengine, tengine = engines
    prompts = _prompts(cfg, (3, 7, 5), 9)
    got, lens = tengine._pad_prompts(prompts, 4)
    want, _ = jengine._pad_prompts(prompts, 4)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 7) and (got[0, :4] == 0).all()
    assert not tengine._ragged_ok and tengine._kv_bucket(9) is None


def test_serve_paged_refuses_the_family(engines):
    _, _, tengine = engines
    with pytest.raises(NotImplementedError, match="not paged"):
        tengine.serve_paged(_requests(teng, _prompts(tengine.model.cfg, (4,), 1), (2,)))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_driver_serves_zamba2_on_cpu(capsys, engine):
    assert tlaunch.main([
        "--arch", ARCH, "--device", "cpu", "--engine", engine, "--requests", "4",
        "--prompt-len", "12", "--prompt-len-min", "3", "--max-new-tokens", "3",
        "--engine-batch", "2", "--max-seq", "24", "--rate-hz", "500",
    ]) == 0
    out = capsys.readouterr().out
    assert "zamba2-2.7b-reduced on cpu" in out and f"engine {engine}" in out
    assert "generated_tokens     12" in out


def test_driver_refuses_the_paged_engine_for_hybrid(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", ARCH, "--device", "cpu", "--engine", "paged"])
    assert "ssm/hybrid state is not paged" in capsys.readouterr().err


def test_full_config_fits_one_card():
    """zamba2-2.7b at published width: 54 Mamba-2 layers, 9 groups, 32 heads
    of 80 in the shared block, and weights far under one 80 GB card."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.hybrid_attn_every, cfg.d_model, cfg.num_heads,
            cfg.resolved_head_dim) == (54, 6, 2560, 32, 80)
    assert lm.weights_fit(cfg, torch.bfloat16, 80 * 10**9) is None
    model = DecoderLM(cfg.replace(num_layers=6), device="cpu", dtype=torch.bfloat16)
    assert model.cache_defs(8, 2048)["k"].shape == (1, 8, 2048, 32, 80)
