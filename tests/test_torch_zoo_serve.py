"""The rest of the dense family through the port's engines, against the JAX
engines on the same weights.

Reduced gemma2-27b (sliding window 8 on every other layer, global layers
between, attention softcap 50, logit softcap 30, post-norms, scaled tied
embeddings), chameleon-34b (QK-norm), granite-20b (MQA: 4 query heads on 1
kv head) and deepseek-67b.  JAX weights come from ``model.init`` with every
norm weight perturbed from its zero init, so QK-norm and post-norms do work,
and reach the port through ``from_jax``.  Prompts run to 30 tokens, past
gemma2's window, and a prefill budget of 8 tokens splits them over several
boundaries, so a chunk's context crosses the window's edge.  Greedy tokens
must be exactly equal: ``serve_paged`` with ``spec_k`` 0 and 2 and on an
int8 pool (``generate`` and ``serve_continuous``:
``tests/test_torch_zoo_engines.py``).
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.models import DecoderLM, from_jax
from repro_torch.serve import engine as teng

ARCHS = ("gemma2-27b", "chameleon-34b", "granite-20b", "deepseek-67b")
NORMS = {"ln1", "ln2", "final_norm", "q_norm", "k_norm", "post_attn_norm", "post_mlp_norm"}
LENS, MAX_NEW = (21, 9, 30, 14), (6, 8, 4, 7)
MAX_SEQ = 48
PAGED = dict(num_slots=3, page_size=4, prefill_budget=8)


def perturb_norms(tree, rng):
    """Every norm weight of a numpy parameter tree moved off its zero init."""
    return {k: (perturb_norms(v, rng) if isinstance(v, dict) else
                (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32) if k in NORMS else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    cfg = jax_get_config(request.param, reduced=True)
    jmodel = build_model(cfg)
    np_params = perturb_norms(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                              np.random.default_rng(0))
    jparams = jax.tree.map(jax.numpy.asarray, np_params)
    tmodel = DecoderLM(get_config(request.param, reduced=True), device="cpu")
    return cfg, jmodel, jparams, tmodel, from_jax(np_params)


def _engines(weights, **kw):
    cfg, jmodel, jparams, tmodel, tparams = weights
    return (jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=MAX_SEQ, **kw),
            teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=MAX_SEQ, device="cpu",
                               **kw))


def _prompts(cfg, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in LENS]


def _requests(mod, prompts):
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]


def _tokens(stats):
    return [r.tokens.tolist() for r in stats.results]


@pytest.mark.parametrize("spec_k", [0, 2])
def test_serve_paged_tokens_equal_jax(weights, spec_k):
    cfg = weights[0]
    jengine, tengine = _engines(weights)
    prompts = _prompts(cfg)
    kw = dict(PAGED, spec_k=spec_k, spec_ngram=1)
    want = jengine.serve_paged(_requests(jeng, prompts), **kw)
    got = tengine.serve_paged(_requests(teng, prompts), **kw)
    assert _tokens(got) == _tokens(want)
    assert [len(t) for t in _tokens(got)] == list(MAX_NEW)
    assert got.prefill_launches == want.prefill_launches >= 4     # several boundaries
    assert got.steps == want.steps and got.spec_stats == want.spec_stats


def test_serve_paged_int8_pool_tokens_equal_jax(weights):
    cfg = weights[0]
    jengine, tengine = _engines(weights, kv_dtype="int8")
    prompts = _prompts(cfg, seed=8)
    want = jengine.serve_paged(_requests(jeng, prompts), **PAGED)
    got = tengine.serve_paged(_requests(teng, prompts), **PAGED)
    assert _tokens(got) == _tokens(want)
    assert got.kv_bytes_per_token == want.kv_bytes_per_token
