"""Tensor-parallel paged serving of the port against the reference's.

Mirrors ``tests/test_tp_serving.py`` case for case, on real ranks: the
port runs tp > 1 as a gloo world of spawned processes on the CPU
(``repro_torch.launch.mesh``), where the reference needs forced host
devices.  Coverage:

* the three serving kernels' plain versions on head slices at tp 1, 2
  and 4 (float32 and bf16): the slices concatenated equal the unsharded
  call bit for bit, and the reference's ``ref`` oracle within its ``_tol``;
* the mesh, ``heads_shard_axis``'s common-axis rule and ``tp_degree``'s
  replication fallback;
* ``serve_paged`` at tp 2 (one world, started once per module, whose runs
  the parametrised cases read) against the port at tp 1 and the JAX
  engine at tp 1 on the same bridged weights: packed/chunked x spec_k
  0/2 x prefix cache off/on, preemption, int8 pools, the
  ``rs_block_outputs`` lever, the ``tp:collective`` ledger, reduced
  qwen3-moe; tp 4 on glm4-9b's 2 kv heads falls back to tp 1 (a world of
  4);
* the port's split choices and ``tp_degree`` against the reference's
  ``param_pspecs`` for every arch at published widths and model axes 2,
  4, 8 and 16 (a ``jax.sharding.AbstractMesh`` serves the reference);
* the driver's ``--tp 2 --device cpu`` and its refusal of ``--tp`` off the
  paged engine.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.serve import engine as jeng
from repro.sharding import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.mesh import make_host_mesh, mesh_name
from repro_torch.models import build_model, from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve.tp import ServeJob, TPRun, serve_tp
from repro_torch.sharding.specs import (
    heads_shard_axis,
    param_pspecs,
    serve_rules,
    set_activation_rules,
    shard_params,
    tp_degree,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process (the ranks take one each too):
    the tensors are tiny, and the suite's parallel workers each starting a
    thread per core oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-5, atol=5e-5))


def _rules_for(tp):
    """The rules over a plain axis-size mesh (no process group)."""
    return serve_rules({"data": 1, "model": tp})


# ---------------------------------------------------------------------------
# kernel workloads: ragged lengths, page-straddling contexts (the reference's)
# ---------------------------------------------------------------------------
H, KVH, DH = 8, 4, 16
PAGE = 8
KERNEL_TPS = [1, 2, 4]
DTYPES = [torch.float32, torch.bfloat16]


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _pools(rng, num_pages):
    return (rng.standard_normal((num_pages, PAGE, KVH, DH)),
            rng.standard_normal((num_pages, PAGE, KVH, DH)))


def _paged_decode_case():
    rng = np.random.default_rng(0)
    kp, vp = _pools(rng, 24)
    b, max_pages = 4, 4
    q = rng.standard_normal((b, 1, H, DH))
    table = rng.permutation(np.arange(1, 24))[: b * max_pages].reshape(b, max_pages)
    lengths = np.asarray([5, 13, 1, 27])
    return q, kp, vp, table.astype(np.int32), lengths.astype(np.int32)


def _varlen_case():
    rng = np.random.default_rng(1)
    kp, vp = _pools(rng, 24)
    C, max_pages = 4, 4
    spans = [16, 8, 24, 16]
    T = sum(spans)
    cu = np.zeros((C + 1,), np.int32)
    cu[1:] = np.cumsum(spans)
    chunk_lens = np.asarray([13, 8, 21, 10], np.int32)
    chunk_pos0 = np.asarray([0, 16, 8, 0], np.int32)
    tables = rng.permutation(np.arange(1, 24))[: C * max_pages].reshape(
        C, max_pages).astype(np.int32)
    q = rng.standard_normal((T, H, DH))
    k = rng.standard_normal((T, KVH, DH))
    v = rng.standard_normal((T, KVH, DH))
    return q, k, v, kp, vp, cu, chunk_lens, chunk_pos0, tables


def _spec_case():
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng, 24)
    b, W, max_pages = 4, 3, 4
    q = rng.standard_normal((b, W, H, DH))
    table = rng.permutation(np.arange(1, 24))[: b * max_pages].reshape(b, max_pages)
    lengths = np.asarray([5, 14, 3, 26], np.int32)
    window_lens = np.asarray([3, 1, 0, 2], np.int32)
    return q, kp, vp, table.astype(np.int32), lengths, window_lens


def _head_split(fn, tp, q_axis, kv_args, q, *rest):
    """``fn`` on each of ``tp`` head slices (q's query heads on axis
    ``q_axis``, each tensor of ``kv_args`` (indices into ``rest``) its kv
    heads on axis 2, or 1 for packed rows), concatenated: the head split of
    the reference's ``_shard_heads``."""
    outs = []
    for r in range(tp):
        hs = slice(r * H // tp, (r + 1) * H // tp)
        ks = slice(r * KVH // tp, (r + 1) * KVH // tp)
        part = list(rest)
        for i, axis in kv_args:
            idx = [slice(None)] * part[i].dim()
            idx[axis] = ks
            part[i] = part[i][tuple(idx)].contiguous()
        idx = [slice(None)] * q.dim()
        idx[q_axis] = hs
        outs.append(fn(q[tuple(idx)].contiguous(), *part))
    return torch.cat(outs, dim=q_axis)


def _jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32),
                       jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("tp", KERNEL_TPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_paged_attention_tp_matches_oracle(tp, dtype):
    q, kp, vp, table, lengths = _paged_decode_case()
    args = (_t(kp, dtype), _t(vp, dtype), torch.from_numpy(table), torch.from_numpy(lengths))
    qt = _t(q, dtype)
    base = ops.paged_attention(qt, *args)
    got = _head_split(ops.paged_attention, tp, 2, [(0, 2), (1, 2)], qt, *args)
    want = jref.paged_attention(_jax(q, dtype), _jax(kp, dtype), _jax(vp, dtype),
                                jnp.asarray(table), jnp.asarray(lengths))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))
    # head slices never mix heads: the split is exact against the unsplit call
    assert torch.equal(got, base)


@pytest.mark.parametrize("tp", KERNEL_TPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_varlen_prefill_tp_matches_oracle(tp, dtype):
    q, k, v, kp, vp, cu, cl, c0, tables = _varlen_case()
    meta = [torch.from_numpy(a) for a in (cu, cl, c0, tables)]
    args = (_t(k, dtype), _t(v, dtype), _t(kp, dtype), _t(vp, dtype), *meta)
    qt = _t(q, dtype)
    base = ops.varlen_prefill(qt, *args)
    got = _head_split(ops.varlen_prefill, tp, 1, [(0, 1), (1, 1), (2, 2), (3, 2)], qt, *args)
    want = jref.varlen_prefill(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                               _jax(kp, dtype), _jax(vp, dtype), jnp.asarray(cu),
                               jnp.asarray(cl), jnp.asarray(c0), jnp.asarray(tables))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))
    assert torch.equal(got, base)


@pytest.mark.parametrize("tp", KERNEL_TPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_spec_verify_tp_matches_oracle(tp, dtype):
    q, kp, vp, table, lengths, wlens = _spec_case()
    args = (_t(kp, dtype), _t(vp, dtype), *map(torch.from_numpy, (table, lengths, wlens)))
    qt = _t(q, dtype)
    base = ops.spec_verify(qt, *args)
    got = _head_split(ops.spec_verify, tp, 2, [(0, 2), (1, 2)], qt, *args)
    want = jref.spec_verify(_jax(q, dtype), _jax(kp, dtype), _jax(vp, dtype),
                            jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(wlens))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))
    assert torch.equal(got, base)


def test_paged_attention_tp_pages_bound():
    """The pages bound composes with the head split."""
    q, kp, vp, table, lengths = _paged_decode_case()
    lengths = np.minimum(lengths, 2 * PAGE)
    args = (_t(kp, torch.float32), _t(vp, torch.float32), torch.from_numpy(table),
            torch.from_numpy(lengths))
    qt = _t(q, torch.float32)
    want = ops.paged_attention(qt, *args, pages_bound=2)
    got = _head_split(lambda *a: ops.paged_attention(*a, pages_bound=2), 2, 2,
                      [(0, 2), (1, 2)], qt, *args)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# mesh + rules plumbing
# ---------------------------------------------------------------------------
def test_make_host_mesh_defaults_single_device():
    mesh = make_host_mesh()
    assert list(mesh) == ["data", "model"]
    assert mesh["model"] == 1 and mesh["data"] == 1
    assert mesh_name(mesh) == "1x1"


def test_make_host_mesh_tp_axis(tp2_world):
    """Inside a world of 2 the mesh is a DeviceMesh with a 2-wide model axis."""
    mesh = tp2_world["mesh"]
    assert mesh["type"] == "DeviceMesh"
    assert mesh["shape"] == {"data": 1, "model": 2}


def test_make_host_mesh_rejects_oversized_tp():
    with pytest.raises(ValueError, match="ranks"):
        make_host_mesh(tp=10)
    with pytest.raises(ValueError):
        make_host_mesh(tp=0)


def test_heads_shard_axis_requires_common_axis():
    rules = _rules_for(2)
    with set_activation_rules(rules):
        assert heads_shard_axis(8, 4) == (rules.mesh, "model")
        # kv heads that don't divide fall back to replication as a UNIT
        assert heads_shard_axis(8, 3) is None
        assert heads_shard_axis(3, 3) is None
    assert heads_shard_axis(8, 4) is None         # no rules active


def test_tp_degree_replication_fallback():
    cfg = get_config("glm4-9b", reduced=True)     # heads=4, kv=2
    assert tp_degree(_rules_for(2), cfg.num_heads, cfg.num_kv_heads) == 2
    assert tp_degree(_rules_for(4), cfg.num_heads, cfg.num_kv_heads) == 1
    assert tp_degree(None, cfg.num_heads, cfg.num_kv_heads) == 1


def test_collectives_are_the_identity_at_one_rank():
    from repro_torch.sharding import comm

    x = torch.arange(6.0).view(1, 2, 3)
    for rules in (None, _rules_for(1)):
        with set_activation_rules(rules):
            assert comm.model_group() == (None, 1, 0)
            assert comm.all_reduce(x) is x
            assert comm.reduce_scatter(x, dim=1) is x
            assert comm.all_gather(x, dim=1) is x


def test_a_failed_collective_raises_with_its_name():
    """A backend that refuses an op (or fails it) surfaces as a
    ``CollectiveError`` naming the op, the dtype and the device; nothing
    retries it elsewhere."""
    from repro_torch.sharding import comm

    def refuse():
        raise RuntimeError("no support for this op on this device")

    with pytest.raises(comm.CollectiveError, match="reduce_scatter .* torch.bfloat16 .* cpu"):
        comm._run("reduce_scatter", refuse, torch.zeros(2, dtype=torch.bfloat16))
    # a model axis above one needs a process group behind it
    with set_activation_rules(_rules_for(2)):
        with pytest.raises(comm.CollectiveError, match="DeviceMesh"):
            comm.all_reduce(torch.zeros(2))


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_pieces_rebuild_the_tree(tp):
    """Each rank's shards, put back along their split dims, are the whole
    tree; the leaves the rules keep whole are every rank's own."""
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    rules = _rules_for(tp)
    defs = model.param_defs()
    pieces = [shard_params(params, rules, r, defs=defs) for r in range(tp)]
    splits = param_pspecs(defs, rules)

    def check(full, split, *parts):
        if isinstance(full, dict):
            for k in full:
                check(full[k], split[k], *(p[k] for p in parts))
        elif isinstance(full, list):
            for i in range(len(full)):
                check(full[i], split[i], *(p[i] for p in parts))
        elif split is None:
            assert all(p is full for p in parts)
        else:
            assert torch.equal(torch.cat(parts, dim=split[0]), full)

    check(params, splits, *pieces)
    assert splits["blocks"][0]["mlp"]["router"] is None
    assert splits["blocks"][0]["mlp"]["w_up"] == (0, "model")
    assert splits["embed"] == (0, "model")


def test_paged_attention_refuses_a_pool_cut_on_another_axis():
    """A rank's heads (2 query heads on 1 kv head) over a pool that kept
    both kv heads: the kernels would read the counts from the tensors, so
    the module refuses the mismatch before any launch."""
    from repro_torch.models import modules

    cfg = get_config("glm4-9b", reduced=True)
    model = build_model(cfg, device="cpu")
    rules = _rules_for(2)
    params = shard_params(model.init(seed=0), rules, 0, defs=model.param_defs())
    attn = params["blocks"][0]["attn"]
    assert attn["wq"].shape[1] == 2 and attn["wk"].shape[1] == 1
    whole = model.init_paged_cache(4, 8)                        # 2 kv heads
    table = torch.ones((1, 2), dtype=torch.int32)
    x1 = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="query heads on 2 kv heads"):
        modules.attn_decode_paged(attn, x1, whole["k_pages"][0], whole["v_pages"][0], table,
                                  torch.zeros((1,), dtype=torch.int32), cfg)


def test_engine_refuses_a_split_without_a_world():
    """Rules whose heads split, in a process that is no rank of a world
    (a mesh of axis sizes, no process group): the engine cannot take a
    rank's shards and says so."""
    cfg = get_config("glm4-9b", reduced=True)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        teng.ServingEngine(model, model.init(seed=0), max_batch=2, max_seq=32, device="cpu",
                           rules=_rules_for(2))


def test_engine_refuses_a_tp_leaf_the_rules_keep_whole():
    """Heads that split at tp 2 over an MLP 129 wide, which does not: the
    rules keep its leaves whole, and the engine, whose model takes every
    ffn leaf for a shard under a model group, refuses before any world is
    asked for."""
    cfg = get_config("glm4-9b", reduced=True).replace(d_ff=129)
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="mlp/w_up does not divide the model axis"):
        teng.ServingEngine(model, model.init(seed=0), max_batch=2, max_seq=32, device="cpu",
                           rules=_rules_for(2))


def test_shards_outside_a_group_raise():
    """A rank's vocab-parallel embedding and head met outside a model group
    (no rules active) raise: a rank's shards never pass for the whole
    model, where a lookup would index the shard and the head return part
    of the logits."""
    from repro_torch.models import modules

    cfg = get_config("glm4-9b", reduced=True)
    model = build_model(cfg, device="cpu")
    params = shard_params(model.init(seed=0), _rules_for(2), 1, defs=model.param_defs())
    with pytest.raises(RuntimeError, match="embedding holds 128 of the vocabulary's 256"):
        modules.vocab_embed(params["embed"], torch.zeros((1, 3), dtype=torch.int32),
                            cfg.vocab_size)
    with pytest.raises(RuntimeError, match="head holds 128 of the vocabulary's 256"):
        model._logits(params, torch.zeros((1, 1, cfg.d_model)))


def test_a_failing_rank_fails_the_run():
    """Every rank raises (an unknown pool dtype): the launcher reports a
    rank's traceback and leaves no process behind."""
    import multiprocessing as mp

    cfg = get_config("glm4-9b", reduced=True)
    run = TPRun(_requests(teng, cfg), engine=dict(max_batch=3, max_seq=64, kv_dtype="int4"),
                serve=BASE_KW)
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed(.|\n)*int4"):
        serve_tp([ServeJob(cfg, 0, [run])], 2, device="cpu", timeout_s=120.0)
    assert not mp.active_children()


# ---------------------------------------------------------------------------
# end-to-end: serve_paged at tp 2 against tp 1 (the port's and JAX's)
# ---------------------------------------------------------------------------
def _requests(mod, cfg, shared_prefix=False):
    rng = np.random.default_rng(7)
    if shared_prefix:
        prefix = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
        prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (n,))
                                   .astype(np.int32)]) for n in (5, 3, 7, 2)]
    else:
        prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (5, 9, 13, 4)]
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, (6, 4, 8, 3)))]


def _preempt_requests(mod, cfg):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (9, 8, 7, 5)]
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, (10, 8, 12, 6)))]


GRID = [(mode, k, cache) for mode in ("packed", "chunked") for k in (0, 2)
        for cache in (False, True)]
BASE_KW = dict(num_slots=3, page_size=8, num_pages=40)
PREEMPT_KW = dict(num_slots=3, page_size=4, num_pages=7, prefill_chunk=4, overcommit=10.0)


def _grid_kw(mode, k, cache):
    return dict(BASE_KW, prefill_mode=mode, spec_k=k, prefix_cache=cache)


def _scenarios(cfg):
    """(name, requests maker, engine kwargs, serve kwargs, rs lever, traced)
    of every glm4-9b run."""
    out = [(("grid",) + g, lambda m, c=g[2]: _requests(m, cfg, c), dict(max_seq=64),
            _grid_kw(*g), False, False) for g in GRID]
    out += [
        (("preempt",), lambda m: _preempt_requests(m, cfg), dict(max_seq=32), PREEMPT_KW,
         False, False),
        (("events",), lambda m: _requests(m, cfg), dict(max_seq=64), BASE_KW, False, True),
        (("rs",), lambda m: _requests(m, cfg), dict(max_seq=64), BASE_KW, True, True),
        (("int8",), lambda m: _requests(m, cfg), dict(max_seq=64, kv_dtype="int8"), BASE_KW,
         False, False),
    ]
    return out


@pytest.fixture(scope="module")
def tp2_world():
    """One world of 2 ranks serving every tp-2 run (started first, so that
    it runs while this process serves tp 1 with both packages); and one of
    4 for the fallback.  Returns {label: [result, ...]} plus, per
    scenario, the port's and JAX's tp-1 stats."""
    out = {}
    models = {}
    for arch in ("glm4-9b", "qwen3-moe-30b-a3b"):
        jcfg = jax_get_config(arch, reduced=True)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        models[arch] = (jmodel, jparams, tree, get_config(arch, reduced=True))
    glm = models["glm4-9b"][3]
    scen = _scenarios(glm)
    probe = _requests(teng, glm)[2].prompt
    runs = [TPRun(make(teng), engine=dict(max_batch=3, **ekw), serve=skw,
                  rs_block_outputs=rs, trace=trace, probe=probe if name == ("events",) else None)
            for name, make, ekw, skw, rs, trace in scen]
    moe = models["qwen3-moe-30b-a3b"][3]
    moe_run = TPRun(_requests(teng, moe), engine=dict(max_batch=3, max_seq=64), serve=BASE_KW)
    world2 = serve_tp([ServeJob(glm, models["glm4-9b"][2], runs),
                       ServeJob(moe, models["qwen3-moe-30b-a3b"][2], [moe_run])], 2, device="cpu",
                      wait=False, timeout_s=300.0)
    world4 = serve_tp([ServeJob(glm, models["glm4-9b"][2],
                                [TPRun(_requests(teng, glm), engine=dict(max_batch=3, max_seq=64),
                                       serve=BASE_KW)])], 4, device="cpu", wait=False,
                      timeout_s=300.0)
    # tp 1: the port and the JAX engine on the same bridged weights
    base = {}
    for arch, names in (("glm4-9b", scen),
                        ("qwen3-moe-30b-a3b", [(("moe",), lambda m: _requests(m, moe),
                                                dict(max_seq=64), BASE_KW, False, False)])):
        jmodel, jparams, tree, cfg = models[arch]
        tmodel = build_model(cfg, device="cpu")
        tparams = from_jax(tree)
        if arch == "glm4-9b":
            out["logits1"] = teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=64,
                                                device="cpu").prompt_logits(probe)
        jax_engines = {}     # one JAX engine per shape: its jitted steps are reused
        for name, make, ekw, skw, _, _ in names:
            te = teng.ServingEngine(tmodel, tparams, max_batch=3, device="cpu", **ekw)
            key = tuple(sorted(ekw.items()))
            if key not in jax_engines:
                jax_engines[key] = jeng.ServingEngine(jmodel, jparams, max_batch=3, **ekw)
            base[name] = (te.serve_paged(make(teng), **skw),
                          jax_engines[key].serve_paged(make(jeng), **skw))
    out["base"] = base
    got2 = world2.result()
    out["glm"] = dict(zip([s[0] for s in scen], got2[0]))
    out["mesh"] = got2[0][0].mesh
    out["moe"] = got2[1][0]
    out["tp4"] = world4.result()[0][0]
    return out


def _assert_tokens(got, *wants):
    for want in wants:
        by_id = {r.request_id: r for r in want.results}
        assert len(got.results) == len(want.results)
        for r in got.results:
            np.testing.assert_array_equal(r.tokens, by_id[r.request_id].tokens)


@pytest.mark.parametrize("prefill_mode", ["packed", "chunked"])
@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_serve_paged_tp2_bit_identical(tp2_world, prefill_mode, spec_k, prefix_cache):
    name = ("grid", prefill_mode, spec_k, prefix_cache)
    got = tp2_world["glm"][name]
    port, jax_ = tp2_world["base"][name]
    assert got.engine_tp == 2 and got.stats.tp == 2 and port.tp == 1
    _assert_tokens(got.stats, port, jax_)
    if prefix_cache:
        assert got.stats.saved_prefill_tokens == port.saved_prefill_tokens
        assert got.stats.saved_prefill_tokens == jax_.saved_prefill_tokens
    # the page accounting is host-global: every rank holds the same pool
    assert got.pool_pages == [port.num_pages] * 2


def test_serve_paged_tp2_preemption_bit_identical(tp2_world):
    """Page pressure preempts and recovers at tp 2 exactly as at tp 1."""
    got = tp2_world["glm"][("preempt",)]
    port, jax_ = tp2_world["base"][("preempt",)]
    assert port.preemptions > 0
    assert got.stats.preemptions == port.preemptions == jax_.preemptions
    _assert_tokens(got.stats, port, jax_)


def test_serve_paged_tp2_emits_collective_events(tp2_world):
    got = tp2_world["glm"][("events",)]
    _assert_tokens(got.stats, *tp2_world["base"][("events",)])
    summary = got.tp_summary
    assert summary["tp"] == 2.0
    assert summary["sharded_launches"] > 0
    # every collective is a psum here: a ring all-reduce moves 2(tp-1)/tp of
    # the payload, the payload itself at tp 2
    assert summary["psum_count"] > 0
    assert summary["psum_moved_bytes"] == summary["psum_payload_bytes"]
    assert summary["total_moved_bytes"] == summary["psum_moved_bytes"]
    # count = 2 collectives a layer and launch; payload tokens * d_model * 4
    cfg = get_config("glm4-9b", reduced=True)
    stats = got.stats
    assert summary["sharded_launches"] == stats.steps + stats.prefill_launches
    assert summary["psum_count"] == 2 * cfg.num_layers * summary["sharded_launches"]


def test_prompt_logits_tp2_match_tp1(tp2_world):
    """A prompt's last-token logits through one chunked-prefill launch: at
    tp 2 (the vocabulary gathered from both ranks) those of tp 1, within
    float32 summation order."""
    got = tp2_world["glm"][("events",)].logits
    want = tp2_world["logits1"]
    assert got.shape == want.shape == (get_config("glm4-9b", reduced=True).vocab_size,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_serve_paged_tp2_reduce_scatter_lever(tp2_world):
    """rs_block_outputs keeps the tokens and halves the analytic traffic of
    the seq-shardable (prefill) launches."""
    got = tp2_world["glm"][("rs",)]
    _assert_tokens(got.stats, *tp2_world["base"][("rs",)])
    summary = got.tp_summary
    assert summary.get("reduce_scatter_count", 0) > 0
    assert (summary["reduce_scatter_moved_bytes"]
            == summary["reduce_scatter_payload_bytes"] / 2)


def test_serve_paged_tp4_fallback_still_identical(tp2_world):
    """glm4-9b reduced has 2 kv heads: tp 4 cannot split them, so the rules
    fall back to replication (effective tp 1), and the tokens still match."""
    got = tp2_world["tp4"]
    assert got.engine_tp == 1 and got.stats.tp == 1
    assert got.mesh["shape"] == {"data": 1, "model": 4}
    _assert_tokens(got.stats, *tp2_world["base"][("events",)])


def test_serve_paged_tp2_int8_bit_identical(tp2_world):
    """Quantized pools split their scale pools with the kv heads: int8 at tp
    2 gives int8 at tp 1's tokens (quantization is per kv head)."""
    got = tp2_world["glm"][("int8",)]
    port, jax_ = tp2_world["base"][("int8",)]
    assert got.engine_tp == 2
    assert got.stats.kv_dtype == "int8" and port.kv_dtype == "int8"
    # the whole pool's bytes a token, as at tp 1
    assert got.stats.kv_bytes_per_token == port.kv_bytes_per_token
    _assert_tokens(got.stats, port, jax_)


def test_serve_paged_tp2_moe_identical(tp2_world):
    """Reduced qwen3-moe at tp 2: 4 of its 8 experts a rank, the router
    whole on each, tokens equal tp 1's."""
    got = tp2_world["moe"]
    port, jax_ = tp2_world["base"][("moe",)]
    assert got.engine_tp == 2
    _assert_tokens(got.stats, port, jax_)


# ---------------------------------------------------------------------------
# the split choices against the reference's rules
# ---------------------------------------------------------------------------
def _pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) of two trees: the port's per-layer
    lists against the reference's stacked subtrees."""
    if isinstance(port, dict):
        for k, v in port.items():
            yield from _pairs(v, ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        for i, v in enumerate(port):
            yield from _pairs(v, ref, f"{path}/{i}")
    else:
        yield path, port, ref


@pytest.mark.parametrize("model_axis", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", list_archs())
def test_split_choices_match_reference(arch, model_axis):
    """Every leaf's split (dim, axis) is the reference's PartitionSpec less
    its leading layer dims, with the same logical axes on the same shape."""
    jcfg = jax_get_config(arch)
    jdefs = jax_build_model(jcfg).param_defs()
    jrules = jspecs.serve_rules(jax.sharding.AbstractMesh((1, model_axis), ("data", "model")))
    jspec = jspecs.param_pspecs(jdefs, jrules)
    cfg = get_config(arch)
    tdefs = build_model(cfg, device="cpu").param_defs()
    rules = _rules_for(model_axis)
    tsplit = param_pspecs(tdefs, rules)
    n = 0
    for (path, tp_def, j_def), (_, split, spec) in zip(_pairs(tdefs, jdefs),
                                                      _pairs(tsplit, jspec)):
        lead = len(j_def.shape) - len(tp_def.shape)
        assert tuple(j_def.shape[lead:]) == tuple(tp_def.shape), path
        assert tuple(j_def.axes[lead:]) == tuple(tp_def.axes), path
        dims = [(i - lead, a) for i, a in enumerate(tuple(spec)) if a is not None]
        assert all(i >= 0 for i, _ in dims), path
        assert split == (dims[0] if dims else None), path
        n += 1
    assert n > 0
    assert (tp_degree(rules, cfg.num_heads, cfg.num_kv_heads)
            == jspecs.tp_degree(jrules, jcfg.num_heads, jcfg.num_kv_heads))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def test_driver_tp2_on_cpu(capsys):
    rc = tlaunch.main(["--device", "cpu", "--tp", "2", "--requests", "4", "--prompt-len", "12",
                       "--prompt-len-min", "3", "--max-new-tokens", "3", "--engine-batch", "2",
                       "--page-size", "4", "--max-seq", "24"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "tp=2" in out
    assert "requested tp=2, effective tp=2 (heads split)" in out
    assert "[serve] tensor-parallel collectives:" in out
    assert "psum_moved_bytes" in out


def test_driver_tp_needs_paged_engine(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--tp", "2", "--engine", "static"])
    assert "--tp > 1 requires --engine paged" in capsys.readouterr().err
