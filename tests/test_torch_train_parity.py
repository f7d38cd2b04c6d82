"""The port's train step against the JAX package's, from the same weights
(``params.from_jax``) and the same numpy batches: ``lr_at`` and
``adamw_update`` within 1e-6; on reduced glm4-9b in float32, remat off and
on at 1, 2 and 4 microbatches, the step's loss, ce and grad_norm within
1e-4 relative and every leaf's gradient within ``1e-4 * max|g_leaf|``
(summation order); the bf16-compute, float32-master step against JAX's
``compute_dtype=bfloat16`` model with ``cast_params_once``: loss within
2e-2 and grad_norm within 5e-2 relative (bf16 rounds at other places in
the two); three float32 steps' losses within 1e-4 relative.  The JAX model
runs its default ``flash`` backend (the custom-VJP flash path)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_grad_fn, make_train_step

REL = 1e-4
BATCH, SEQ = 4, 12
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: these tensors are tiny, and the suite's
    parallel workers each starting a thread per core oversubscribe the
    cores (this file's tests took twice as long under the full suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(arch, **kw):
    cfg = jax_get_config(arch, reduced=True)
    model = jax_build_model(cfg, **kw)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def batches(cfg, n, seed=0):
    """n (numpy tokens, JAX batch, torch batch) triples; zero frames for an
    enc-dec model."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
        if cfg.family == "encdec":
            jb["frames"] = jnp.zeros((BATCH, cfg.encoder_seq, cfg.d_model), jnp.float32)
            tb["frames"] = torch.zeros((BATCH, cfg.encoder_seq, cfg.d_model))
        out.append((toks, jb, tb))
    return out


def by_path(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items() for p, x in by_path(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {p: x for i, v in enumerate(tree) for p, x in by_path(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def assert_leaf_grads(got, want_jax):
    """Each port gradient leaf within REL * max|g_leaf| of JAX's (bridged
    into the port's layout)."""
    got, want = by_path(got), by_path(from_jax(want_jax))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        assert (g - w).abs().max() <= REL * max(float(w.abs().max()), 1e-30), \
            (path, float((g - w).abs().max()))


def assert_metrics(got, want, keys=("loss", "ce", "aux", "grad_norm"), rel=REL):
    for k in keys:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= rel * max(abs(w), 1e-30), (k, float(got[k]), w)


@functools.lru_cache(maxsize=None)
def jax_reference(arch):
    """The JAX model, its weights and its full-batch gradients on the first
    batch, once per arch (the tests of one arch share one compile)."""
    cfg, jmodel, jparams = jax_model(arch)
    loss_fn = jstep.make_loss_fn(jmodel)
    jgrads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(jparams, batches(cfg, 1)[0][1])
    return cfg, jmodel, jparams, jgrads


def parity_steps(arch, n_steps, microbatches=1, remat=True):
    """The JAX and the port's train steps side by side from bridged
    weights: per step (JAX metrics, port metrics); also JAX's full-batch
    gradients and the port's (make_grad_fn at this microbatching) of step 1."""
    cfg, jmodel, jparams, jgrads = jax_reference(arch)
    jcfg = jopt.OptimizerConfig(**OPT)
    jstate = jopt.init_opt_state(jmodel.param_defs(), jcfg)
    model = build_model(get_config(arch, reduced=True), "cpu")
    params = from_jax(jparams)
    tcfg = topt.OptimizerConfig(**OPT)
    state = topt.init_opt_state(model.param_defs(), tcfg, "cpu")
    data = batches(cfg, n_steps)
    tgrads, _ = make_grad_fn(model, microbatches, remat)(params, data[0][2])
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg, microbatches=microbatches, remat=remat))
    tfn = make_train_step(model, tcfg, microbatches=microbatches, remat=remat)
    out = []
    for _, jb, tb in data:
        jparams, jstate, jm = jfn(jparams, jstate, jb)
        params, state, tm = tfn(params, state, tb)
        out.append((jm, tm))
    return out, jgrads, tgrads


def test_lr_at_matches_jax():
    cfg = dict(lr=2e-3, warmup_steps=3, total_steps=10, min_lr_frac=0.1)
    for step in range(12):
        want = float(jopt.lr_at(step, jopt.OptimizerConfig(**cfg)))
        got = topt.lr_at(torch.tensor(step, dtype=torch.int32), topt.OptimizerConfig(**cfg))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30)


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_update_matches_jax(clip):
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}

    def tree(scale):
        return jax.tree.map(lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))

    p, g1, g2 = tree(1.0), tree(0.3), tree(0.3)
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=20, clip_norm=clip)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p)
    js = {"step": jnp.int32(0), "m": jax.tree.map(jnp.zeros_like, jp),
          "v": jax.tree.map(jnp.zeros_like, jp)}
    conv = lambda t: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)
    tp = conv(p)
    ts = {"step": torch.tensor(0, dtype=torch.int32), "m": conv(jax.tree.map(np.zeros_like, p)),
          "v": conv(jax.tree.map(np.zeros_like, p))}
    for g in (g1, g2):
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, conv(g), ts, tcfg)
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
        for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            for a, b in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree_j)):
                b = np.asarray(b)
                assert np.abs(a.numpy() - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-30)
    assert int(ts["step"]) == int(js["step"]) == 2


@pytest.mark.parametrize("microbatches", [1, 2, 4])
@pytest.mark.parametrize("remat", [False, True])
def test_glm4_train_step_matches_jax(remat, microbatches):
    steps, jgrads, tgrads = parity_steps("glm4-9b", 1, microbatches, remat)
    assert_metrics(steps[0][1], steps[0][0])
    assert_leaf_grads(tgrads, jgrads)


def test_glm4_three_steps_match_jax():
    steps, _, _ = parity_steps("glm4-9b", 3, microbatches=2, remat=True)
    for jm, tm in steps:
        assert_metrics(tm, jm)


def test_glm4_bf16_compute_fp32_masters_match_jax():
    cfg, jmodel, jparams = jax_model("glm4-9b", compute_dtype=jnp.bfloat16)
    jcfg = jopt.OptimizerConfig(**OPT)
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg, microbatches=2, remat=True,
                                        cast_params_once=True))
    _, jm = jfn(jparams, jopt.init_opt_state(jmodel.param_defs(), jcfg),
                batches(cfg, 1)[0][1])[1:]
    model = build_model(get_config("glm4-9b", reduced=True), "cpu", torch.bfloat16)
    tcfg = topt.OptimizerConfig(**OPT)
    params = from_jax(jparams)
    assert params["embed"].dtype == torch.float32
    tfn = make_train_step(model, tcfg, microbatches=2, remat=True, cast_params_once=True)
    params, _, tm = tfn(params, topt.init_opt_state(model.param_defs(), tcfg, "cpu"),
                        batches(cfg, 1)[0][2])
    assert params["embed"].dtype == torch.float32
    assert_metrics(tm, jm, ("loss",), rel=2e-2)
    assert_metrics(tm, jm, ("grad_norm",), rel=5e-2)
