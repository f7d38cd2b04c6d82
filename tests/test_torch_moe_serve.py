"""Reduced qwen3-moe-30b-a3b through the port's ``serve_paged`` against the
JAX engine on the same weights, at a capacity factor that drops slots.

With capacity-based routing a token's output depends on the group it is
routed in: every chunk and pad row of a packed prefill launch competes in
one group of ``t_pack`` tokens, a chunked prefill's chunk (padded to a page
multiple) is a group of its own, a verify window of ``W`` tokens another.
So the port must cut the same groups at the same boundaries as the
reference.  Every mode of ``serve_paged`` is held to JAX's greedy tokens
and counts exactly (float32): packed prefill over several boundaries,
chunked prefill, ``spec_k`` 2, int8 and fp8 pools, the prefix cache on, and
``overcommit`` 2 on a pool cut so that preemption fires.  A spy on the
port's ``moe_apply`` counts the slots dropped in each run (routing
recomputed from its inputs) and needs more than zero, so no case is
vacuous.  JAX weights, every norm perturbed from its zero init, reach the
port through ``from_jax``.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.serve import engine as jeng
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models import lm as tlm
from repro_torch.models import modules as tmod
from repro_torch.serve import engine as teng
from test_torch_moe import DROPPING_CF, _port_cfg
from test_torch_zoo_serve import perturb_norms

LENS, MAX_NEW = (21, 9, 30, 14), (6, 8, 4, 7)
MAX_SEQ = 48
PAGED = dict(num_slots=3, page_size=4, prefill_budget=8)
COUNTS = ("steps", "preemptions", "prefill_launches", "prefill_tokens", "prompt_tokens_admitted",
          "prefill_tokens_dropped", "saved_prefill_tokens", "cow_copies", "peak_pages_in_use",
          "total_tokens")


def moe_weights(arch, cf=DROPPING_CF):
    """(JAX config, JAX model, JAX params, port model, port params) of the
    reduced ``arch`` at capacity factor ``cf``."""
    cfg = jax_get_config(arch, reduced=True).replace(capacity_factor=cf)
    jmodel = build_model(cfg)
    np_params = perturb_norms(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                              np.random.default_rng(0))
    jparams = jax.tree.map(jax.numpy.asarray, np_params)
    return cfg, jmodel, jparams, DecoderLM(_port_cfg(cfg), device="cpu"), from_jax(np_params)


@pytest.fixture(scope="module")
def weights():
    return moe_weights("qwen3-moe-30b-a3b")


@pytest.fixture
def drops(monkeypatch):
    """Slots the port's MoE layers drop while the test runs (each call's
    routing recomputed from its inputs, as ``moe_apply`` routes)."""
    seen = {"dropped": 0, "calls": 0}
    real = tmod.moe_apply

    def spy(p, x, cfg, need_aux=True):
        b, s, _ = x.shape
        idx = tmod.moe_route(p, x, cfg)[2]
        pos = tmod._positions_in_expert(idx.reshape(b, -1), cfg.num_experts)
        seen["dropped"] += int((pos >= tmod.moe_capacity(cfg, s)).sum())
        seen["calls"] += 1
        return real(p, x, cfg, need_aux)

    monkeypatch.setattr(tlm, "moe_apply", spy)
    return seen


def engines(weights, max_seq=MAX_SEQ, **kw):
    cfg, jmodel, jparams, tmodel, tparams = weights
    return (jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=max_seq, **kw),
            teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=max_seq, device="cpu",
                               **kw))


def prompts(cfg, seed=7, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]


def requests(mod, ps, max_new=MAX_NEW):
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(ps, max_new))]


def tokens(stats):
    return {r.request_id: r.tokens.tolist() for r in stats.results}


def _same_as_jax(got, want):
    assert tokens(got) == tokens(want)
    for name in COUNTS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.spec_stats == want.spec_stats
    assert got.prefix_stats == want.prefix_stats


def _shared(cfg, seed=11, page=4, n=6):
    """A shared 3-page prefix with unique tails, every third prompt the
    prefix alone (a full hit once cached)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (3 * page,)).astype(np.int32)
    return [prefix.copy() if i % 3 == 2 else
            np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (5,)).astype(np.int32)])
            for i in range(n)]


# (engine keywords, serve_paged keywords, prompts' seed); the prefix-cache
# case runs shared-prefix prompts, the overcommit case PREEMPT's
MODES = {
    "packed": ({}, {}, 7),
    "chunked": ({}, dict(prefill_mode="chunked", prefill_chunk=8), 7),
    "spec_k 2": ({}, dict(spec_k=2, spec_ngram=1), 8),
    "int8": (dict(kv_dtype="int8"), {}, 9),
    "fp8": (dict(kv_dtype="fp8"), {}, 10),
    "prefix cache on": ({}, dict(prefix_cache=True, prefill_budget=16), 11),
    "overcommit 2": ({}, dict(num_pages=7, overcommit=2.0, prefill_chunk=4), 3),
}
# prompt lengths and new tokens that outgrow a 6-page pool admitted at
# overcommit 2 (tests/test_torch_chunked.py's PREEMPT)
PREEMPT = ((9, 8, 7, 5), (10, 8, 12, 6))


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_paged_tokens_equal_jax(weights, drops, mode):
    cfg = weights[0]
    engine_kw, kw, seed = MODES[mode]
    jengine, tengine = engines(weights, **engine_kw)
    if mode == "prefix cache on":
        ps, max_new = _shared(cfg), (5,) * 6
    elif mode == "overcommit 2":
        ps, max_new = prompts(cfg, seed, PREEMPT[0]), PREEMPT[1]
    else:
        ps, max_new = prompts(cfg, seed), MAX_NEW
    want = jengine.serve_paged(requests(jeng, ps, max_new), **{**PAGED, **kw})
    got = tengine.serve_paged(requests(teng, ps, max_new), **{**PAGED, **kw})
    _same_as_jax(got, want)
    assert [len(t) for t in tokens(got).values()] == list(max_new)
    assert drops["dropped"] > 0, "the run must drop slots for the case to test capacity"
    assert got.prompt_tokens_admitted == (got.prefill_tokens + got.saved_prefill_tokens
                                          + got.prefill_tokens_dropped)
    if mode == "packed":
        assert got.prefill_launches >= 4                  # several boundaries
    if mode == "chunked":
        assert got.prefill_mode == "chunked" and got.prefill_launches > len(ps)
    if mode == "spec_k 2":
        assert got.spec_stats["spec_launches"] > 0
    if mode in ("int8", "fp8"):
        assert got.kv_dtype == mode and got.kv_bytes_per_token == want.kv_bytes_per_token
    if mode == "prefix cache on":
        assert got.prefix_stats["full_hits"] > 0 and got.cow_copies > 0
    if mode == "overcommit 2":
        assert got.preemptions > 0


def test_packed_launch_is_one_routing_group(weights):
    """A packed launch routes its whole ``(1, t_pack)`` buffer, pads
    included, as one group (t_pack is the budget, 8 tokens here), a
    chunked-prefill chunk its page-padded length, a decode step one token
    a slot."""
    cfg = weights[0]
    _, tengine = engines(weights)
    shapes = []
    real = tlm.moe_apply

    def shape_spy(p, x, cfg_, need_aux=True):
        shapes.append(tuple(x.shape[:2]))
        return real(p, x, cfg_, need_aux)

    L = cfg.num_layers
    tlm.moe_apply = shape_spy
    try:
        packed = tengine.serve_paged(requests(teng, prompts(cfg)), **PAGED)
        n_packed = len(shapes)
        chunked = tengine.serve_paged(requests(teng, prompts(cfg)), prefill_mode="chunked",
                                      prefill_chunk=8, **PAGED)
    finally:
        tlm.moe_apply = real
    assert shapes[:n_packed] == ([(1, 8)] * L * packed.prefill_launches
                                 + [(3, 1)] * L * packed.steps) or sorted(
        set(shapes[:n_packed])) == [(1, 8), (3, 1)]
    assert shapes[:n_packed].count((1, 8)) == L * packed.prefill_launches
    assert shapes[:n_packed].count((3, 1)) == L * packed.steps
    chunks = [sh for sh in shapes[n_packed:] if sh[0] == 1]
    assert len(chunks) == L * chunked.prefill_launches
    assert {c for _, c in chunks} <= {4, 8} and (1, 4) in chunks    # padded to a page
