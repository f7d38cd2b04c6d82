"""The port's glm4-9b (reduced) against the JAX model on the same weights.

JAX weights come from ``model.init(jax.random.PRNGKey(0))`` (with the norm
weights perturbed from their zero init, so the ``(1 + w)`` convention is
exercised), go through numpy, and reach the port via ``from_jax``.  The JAX
model runs its Pallas kernels in interpret mode.  Logits agree to 1e-4 in
float32 (the summation order differs); page-pool contents to 5e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import build_model
from repro.models import modules as jmod
from repro_torch.configs import get_config, list_archs
from repro_torch.models import DecoderLM, EncDecLM, from_jax
from repro_torch.models import build_model as torch_build_model
from repro_torch.models import modules as tmod

PS = 4
MAX_PAGES = 6
NUM_PAGES = 16
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=5e-5, atol=5e-5)


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


def test_config_copy_matches():
    assert list_archs() == ["zamba2-2.7b", "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
                            "deepseek-67b", "granite-20b", "glm4-9b", "gemma2-27b",
                            "chameleon-34b", "mamba2-130m", "whisper-large-v3"]
    for arch in list_archs():
        for reduced in (False, True):
            port, ref = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.param_count() == ref.param_count()
    # every architecture of the reference is ported (ResNet-50 is no
    # ArchConfig in either package: its config is models.resnet's)
    assert list_archs() == jax_list_archs()
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("resnet50")
    # the hybrid family's config is the reference's, and the model builds
    zamba = get_config("zamba2-2.7b")
    assert dataclasses.asdict(zamba) == dataclasses.asdict(jax_get_config("zamba2-2.7b"))
    assert DecoderLM(get_config("zamba2-2.7b", reduced=True), device="cpu").hybrid


def test_from_jax_splits_stacked_blocks(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    assert len(tparams["blocks"]) == cfg.num_layers
    np.testing.assert_array_equal(
        tparams["blocks"][1]["attn"]["wq"].numpy(), np.asarray(jparams["blocks"]["attn"]["wq"][1]))
    # same leaves and shapes as the port's own definitions
    fresh = tmodel.init(seed=0)
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(fresh) == shapes(tparams)


def test_init_is_seeded_and_on_device():
    model = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    a, b = model.init(seed=3), model.init(seed=3)
    assert torch.equal(a["embed"], b["embed"])
    assert a["embed"].dtype == torch.float32 and a["embed"].device.type == "cpu"
    assert not torch.equal(a["embed"], model.init(seed=4)["embed"])


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    want = np.asarray(jmod.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    got = tmod.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy()
    np.testing.assert_allclose(got, want, **POOL_TOL)


def _pools(tmodel, seed):
    """A random filled pool, as numpy (L, P, ps, kvh, d) arrays."""
    cfg = tmodel.cfg
    shape = tmodel.paged_cache_defs(NUM_PAGES, PS)["k_pages"]
    assert shape == (cfg.num_layers, NUM_PAGES, PS, cfg.num_kv_heads, cfg.resolved_head_dim)
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


def test_attn_decode_paged_matches_jax(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    kp, vp = _pools(tmodel, 2)
    rng = np.random.default_rng(3)
    x1 = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    table = np.array([[1, 2, 3, 0, 0, 0], [4, 5, 0, 0, 0, 0], [0] * 6], np.int32)
    pos = np.array([9, 4, 0], np.int32)
    p_j = jax.tree.map(lambda t: t[0], jparams["blocks"]["attn"])
    y_j, kp_j, vp_j = jmod.attn_decode_paged(
        p_j, jnp.asarray(x1), jnp.asarray(kp[0]), jnp.asarray(vp[0]),
        jnp.asarray(table), jnp.asarray(pos), cfg, backend="pallas", pages_bound=4)
    kp_t, vp_t = torch.from_numpy(kp[0].copy()), torch.from_numpy(vp[0].copy())
    y_t = tmod.attn_decode_paged(
        tparams["blocks"][0]["attn"], torch.from_numpy(x1), kp_t, vp_t,
        torch.from_numpy(table), torch.from_numpy(pos), cfg, pages_bound=4)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kp_j), **POOL_TOL)
    np.testing.assert_allclose(vp_t.numpy(), np.asarray(vp_j), **POOL_TOL)


def _pack(spans, T, C):
    """Packing metadata for ``spans`` = [(tokens, table_row, start)], laid
    out as the serving engine does (page-aligned spans, tail pads into the
    scratch page, empty trailing chunk rows)."""
    tokens = np.zeros((1, T), np.int32)
    tok_pos = np.zeros((T,), np.int32)
    dst_page = np.zeros((T,), np.int32)
    dst_off = (np.arange(T) % PS).astype(np.int32)
    cu = np.zeros((C + 1,), np.int32)
    lens = np.zeros((C,), np.int32)
    pos0 = np.zeros((C,), np.int32)
    last = np.zeros((C,), np.int32)
    tables = np.zeros((C, MAX_PAGES), np.int32)
    off = 0
    for ci, (toks, row, start) in enumerate(spans):
        take = len(toks)
        span = -(-take // PS) * PS
        tokens[0, off : off + take] = toks
        pos = start + np.arange(span, dtype=np.int32)
        tok_pos[off : off + span] = pos
        dst_page[off : off + span] = row[pos // PS]
        dst_off[off : off + span] = pos % PS
        cu[ci + 1] = off + span
        lens[ci], pos0[ci], last[ci] = take, start, off + take - 1
        tables[ci] = row
        off += span
    cu[len(spans) + 1 :] = off
    return dict(tokens=tokens, tok_pos=tok_pos, dst_page=dst_page, dst_off=dst_off,
                cu_seqlens=cu, chunk_lens=lens, chunk_pos0=pos0, page_tables=tables,
                last_idx=last)


def test_attn_prefill_packed_matches_jax(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    kp, vp = _pools(tmodel, 4)
    row_a = np.array([1, 2, 3, 0, 0, 0], np.int32)
    row_b = np.array([4, 5, 6, 7, 0, 0], np.int32)
    meta = _pack([(np.arange(6), row_a, 4), (np.arange(9), row_b, 0)], 32, C=3)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 32, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda t: t[1], jparams["blocks"]["attn"])
    y_j, kp_j, vp_j = jmod.attn_prefill_packed(
        p_j, jnp.asarray(x), jnp.asarray(kp[1]), jnp.asarray(vp[1]),
        {k: jnp.asarray(v) for k, v in meta.items()}, cfg, backend="pallas", pages_bound=1)
    kp_t, vp_t = torch.from_numpy(kp[1].copy()), torch.from_numpy(vp[1].copy())
    y_t = tmod.attn_prefill_packed(
        tparams["blocks"][1]["attn"], torch.from_numpy(x), kp_t, vp_t,
        {k: torch.from_numpy(v) for k, v in meta.items()}, cfg, pages_bound=1)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **LOGIT_TOL)
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kp_j), **POOL_TOL)
    np.testing.assert_allclose(vp_t.numpy(), np.asarray(vp_j), **POOL_TOL)


def test_prefill_packed_then_decode_paged_matches_jax(models):
    """Two packed launches (the second with committed context), then four
    decode steps with page growth: logits and pools agree throughout."""
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(7)
    prompt_a = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    prompt_b = rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
    table = np.zeros((3, MAX_PAGES), np.int32)        # slot 2 stays idle
    table[0, :2] = [1, 2]
    table[1, :3] = [3, 4, 5]
    jcache = jmodel.init_paged_cache(NUM_PAGES, PS, dtype="float32")
    tcache = tmodel.init_paged_cache(NUM_PAGES, PS)

    def prefill(spans, bound):
        nonlocal jcache
        meta = _pack(spans, 16, C=3)
        lj, jcache = jmodel.prefill_packed(
            jparams, {k: jnp.asarray(v) for k, v in meta.items()}, jcache, pages_bound=bound)
        lt = tmodel.prefill_packed(
            tparams, {k: torch.from_numpy(v) for k, v in meta.items()}, tcache, pages_bound=bound)
        return np.asarray(lj), lt.numpy()

    lj, lt = prefill([(prompt_a, table[0], 0), (prompt_b[:4], table[1], 0)], 1)
    np.testing.assert_allclose(lt[:2], lj[:2], **LOGIT_TOL)
    first_a = int(lj[0].argmax())
    lj, lt = prefill([(prompt_b[4:], table[1], 4)], 1)
    np.testing.assert_allclose(lt[:1], lj[:1], **LOGIT_TOL)
    first_b = int(lj[0].argmax())
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **POOL_TOL)

    lengths = np.array([7, 10, 0], np.int32)
    nxt = np.array([first_a, first_b, 0], np.int32)
    free = iter(range(6, NUM_PAGES))
    for _ in range(4):
        for s in (0, 1):                               # page growth
            if lengths[s] % PS == 0:
                table[s, lengths[s] // PS] = next(free)
        lj, jcache = jmodel.decode_paged(
            jparams, jnp.asarray(nxt), jcache, jnp.asarray(table), jnp.asarray(lengths),
            pages_bound=4)
        lt = tmodel.decode_paged(
            tparams, torch.from_numpy(nxt), tcache, torch.from_numpy(table),
            torch.from_numpy(lengths), pages_bound=4)
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy()[:2], lj[:2], **LOGIT_TOL)
        nxt[:2] = lj[:2].argmax(-1)
        lengths[:2] += 1
    for name in ("k_pages", "v_pages"):
        live = np.asarray(jcache[name])[:, 1:]          # page 0 is scratch
        np.testing.assert_allclose(tcache[name].numpy()[:, 1:], live, **POOL_TOL)


def test_unported_configs_raise():
    """DecoderLM refuses the enc-dec family, which ``build_model`` gives its
    own ``EncDecLM``; every dense option of the zoo, the MoE family and the
    hybrid family are accepted."""
    cfg = jax_get_config("whisper-large-v3", reduced=True)
    with pytest.raises(NotImplementedError, match=f"family {cfg.family}"):
        DecoderLM(cfg, device="cpu")
    assert isinstance(torch_build_model(cfg, device="cpu"), EncDecLM)
    zamba = DecoderLM(jax_get_config("zamba2-2.7b", reduced=True), device="cpu")
    assert zamba.cfg.family == "hybrid" and zamba.stateful and "shared" in zamba.param_defs()
    for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"):
        assert DecoderLM(get_config(arch, reduced=True), device="cpu").cfg.family == "moe"
    cfg = get_config("glm4-9b", reduced=True).replace(
        qk_norm=True, post_norms=True, scale_embed=True, logit_softcap=30.0, attn_softcap=50.0,
        sliding_window=8, global_every=2)
    DecoderLM(cfg, device="cpu")
