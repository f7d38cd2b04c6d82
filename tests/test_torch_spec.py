"""Speculative decoding in the port against the JAX package.

The plain ``spec_verify`` against the Pallas kernel in interpret mode over
the JAX suite's cases (``tests/test_spec_decode.py``), the drafter and the
draft ledger against their JAX originals, ``attn_decode_spec`` and
``DecoderLM.decode_spec`` against the JAX model on the same weights, and
``serve_paged(spec_k > 0)`` tokens and draft ledger against the JAX engine.
Kernel outputs agree to 5e-5 (float32, the JAX suite's tolerance), logits
to 1e-4 (summation order differs), greedy tokens exactly.

One case the port does not copy: the JAX module writes a window's pad rows
through the page table with the page index clamped to the table's last
column, so a request whose pad positions run past ``max_seq`` overwrites a
committed row there, and its speculative tokens can then differ from its
plain ones.  The port writes pad rows into the scratch page; the tests at
the end hold spec equal to non-spec at that edge.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.spec_verify import spec_verify as pallas_spec
from repro.models import build_model
from repro.models import modules as jmod
from repro.serve import engine as jeng
from repro.serve import scheduler as jsch
from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import spec_verify as sv_mod
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM, from_jax
from repro_torch.models import modules as tmod
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsch

TOL = dict(rtol=5e-5, atol=5e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PAGE = 8


def _close(port, jax_out, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# spec_verify: the CASES of tests/test_spec_decode.py
# ---------------------------------------------------------------------------
def _windows(rows, W, seed, kvh=2, h=4, d=16, max_pages=6, num_pages=32):
    """(committed, window_len) rows; each row's pages cover committed plus
    in-flight tokens, and window starts are not page-aligned."""
    rng = np.random.default_rng(seed)
    b = len(rows)
    tables = np.zeros((b, max_pages), np.int32)
    nxt = 1
    for i, (L, wl) in enumerate(rows):
        for j in range((L + wl + PAGE - 1) // PAGE):
            tables[i, j] = nxt
            nxt += 1
    assert nxt <= num_pages
    mk = lambda shape: rng.normal(size=shape).astype(np.float32)
    return (mk((b, W, h, d)), mk((num_pages, PAGE, kvh, d)), mk((num_pages, PAGE, kvh, d)),
            tables, np.array([r[0] for r in rows], np.int32),
            np.array([r[1] for r in rows], np.int32))


CASES = [
    # ragged window lens, page straddles, idle rows
    ([(13, 4), (7, 2), (0, 0)], 4),
    ([(15, 3), (8, 1)], 3),            # a window opens a brand-new page
    ([(5, 5), (22, 1), (11, 3)], 5),
    ([(0, 2)], 2),                     # no committed context at all
]


@pytest.mark.parametrize("rows,W", CASES)
@pytest.mark.parametrize("window", [None, 5])
def test_spec_verify_matches_pallas(rows, W, window):
    args = _windows(rows, W, seed=W + len(rows))
    want = pallas_spec(*map(jnp.asarray, args), window=window)
    targs = tuple(map(torch.from_numpy, args))
    _close(ref.spec_verify(*targs, window=window), want)
    _close(ops.spec_verify(*targs, window=window), want)


def test_spec_verify_softcap_matches_pallas():
    args = _windows([(9, 3), (4, 2)], 3, seed=1)
    want = pallas_spec(*map(jnp.asarray, args), softcap=11.0)
    _close(ops.spec_verify(*map(torch.from_numpy, args), softcap=11.0), want)


def test_spec_verify_pages_bound_matches_pallas():
    """A bound covering committed plus in-flight pages is exact; a tighter
    one cuts the same pages in both packages."""
    args = _windows([(13, 3), (6, 2)], 3, seed=2)
    jargs = tuple(map(jnp.asarray, args))
    targs = tuple(map(torch.from_numpy, args))
    _close(ops.spec_verify(*targs, pages_bound=2), pallas_spec(*jargs))
    _close(ops.spec_verify(*targs, pages_bound=1), pallas_spec(*jargs, pages_bound=1))


def test_spec_verify_pad_rows_are_exact_zeros():
    args = _windows([(13, 2), (0, 0)], 4, seed=3)
    for out in (np.asarray(pallas_spec(*map(jnp.asarray, args))),
                ref.spec_verify(*map(torch.from_numpy, args)).numpy()):
        assert np.all(out[0, 2:] == 0.0)     # window pad
        assert np.all(out[1] == 0.0)         # idle slot


def test_spec_verify_rows_match_one_token_decode():
    """Window row w scores like a one-token paged decode at length
    committed + w + 1."""
    rows = [(13, 4), (7, 3)]
    q, kp, vp, tables, lens, wlens = map(torch.from_numpy, _windows(rows, 4, seed=4))
    full = ref.spec_verify(q, kp, vp, tables, lens, wlens)
    for i, (L, wl) in enumerate(rows):
        for w in range(wl):
            one = ref.paged_attention(q[i : i + 1, w : w + 1], kp, vp, tables[i : i + 1],
                                      torch.tensor([L + w + 1], dtype=torch.int32))
            torch.testing.assert_close(full[i, w], one[0, 0], rtol=2e-6, atol=2e-6)


def test_spec_verify_wrapper_counts_no_cpu_launch():
    args = tuple(map(torch.from_numpy, _windows([(5, 3)], 3, seed=5)))
    before = sv_mod.launches
    torch.testing.assert_close(sv_mod.spec_verify(*args), ref.spec_verify(*args))
    assert sv_mod.launches == before


def test_c_signatures_match_the_ctypes_bindings():
    """Every ``extern "C"`` entry point in csrc/ takes exactly the argument
    kinds its ctypes signature declares (pointer, int, float), in order:
    a mismatch would pass garbage to the kernel, and only the card runs it."""
    kinds = {"const void*": "P", "void*": "P", "int": "I", "float": "F", "long long": "L"}
    names = {_build._P: "P", _build._I: "I", _build._F: "F", _build._LL: "L"}
    found = {}
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()[:-1]) for p in m.group(2).split(",")]
            found[m.group(1)] = [kinds[p] for p in params]
    assert set(found) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert [names[a] for a in argtypes] == found[name], name


# ---------------------------------------------------------------------------
# the drafter and the draft ledger are copies
# ---------------------------------------------------------------------------
NGRAM_CONTEXTS = [
    ([1, 2, 3, 9, 1, 2, 3, 5, 7, 1, 2, 3], ((3, 2), (3, 5), (3, 8), (4, 4), (3, 0), (1, 3))),
    ([2, 3, 8, 2, 3, 6, 2, 3], ((2, 1), (2, 4), (1, 2))),
    ([9, 4, 5, 4, 5, 4, 5, 4, 5], ((2, 4), (1, 6), (3, 2))),
    ([1, 2, 3], ((3, 4), (2, 1))),
]


@pytest.mark.parametrize("ctx,queries", NGRAM_CONTEXTS)
def test_ngram_propose_matches_jax(ctx, queries):
    c = np.asarray(ctx, np.int32)
    for ngram, k in queries:
        assert teng.ngram_propose(c, ngram, k) == jeng.ngram_propose(c, ngram, k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ngram_propose_matches_jax_on_random_context(seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, (40,)).astype(np.int32)      # tiny alphabet: many matches
    for ngram in (1, 2, 3):
        for k in (1, 3, 5):
            assert teng.ngram_propose(c, ngram, k) == jeng.ngram_propose(c, ngram, k)


def test_spec_ledger_matches_jax():
    ledgers = [jsch.SpecLedger(), tsch.SpecLedger()]
    rng = np.random.default_rng(0)
    for _ in range(30):
        rid, prop = int(rng.integers(4)), int(rng.integers(5))
        acc = int(rng.integers(prop + 1))
        spec, pages = bool(rng.integers(2)), int(rng.integers(3))
        for lg in ledgers:
            lg.record(rid, prop, acc)
            lg.record_launch(spec)
            lg.record_rollback(pages)
    assert ledgers[0].stats() == ledgers[1].stats()
    assert [ledgers[0].of(r) for r in range(5)] == [ledgers[1].of(r) for r in range(5)]
    for lg in ledgers:
        with pytest.raises(ValueError, match="draft accounting"):
            lg.record(0, 1, 2)
        with pytest.raises(ValueError, match="negative"):
            lg.record_rollback(-1)


# ---------------------------------------------------------------------------
# the model: attn_decode_spec and decode_spec against JAX
# ---------------------------------------------------------------------------
PS, MAX_PAGES, NUM_PAGES = 4, 6, 16


@pytest.fixture(scope="module")
def models():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg, backend="pallas")
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, np_params), tmodel, from_jax(np_params)


def _pools(tmodel, seed):
    shape = tmodel.paged_cache_defs(NUM_PAGES, PS)["k_pages"]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


# slot 0 straddles into a fresh page, slot 1 has pad rows, slot 2 is idle
SPEC_TABLE = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 0, 0, 0, 0], [0] * 6], np.int32)
SPEC_LENS = np.array([10, 5, 0], np.int32)
SPEC_WLENS = np.array([4, 2, 0], np.int32)


def test_attn_decode_spec_matches_jax(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    kp, vp = _pools(tmodel, 1)
    W = 4
    xw = np.random.default_rng(2).normal(size=(3, W, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda t: t[0], jparams["blocks"]["attn"])
    y_j, kp_j, vp_j = jmod.attn_decode_spec(
        p_j, jnp.asarray(xw), jnp.asarray(kp[0]), jnp.asarray(vp[0]), jnp.asarray(SPEC_TABLE),
        jnp.asarray(SPEC_LENS), jnp.asarray(SPEC_WLENS), cfg, backend="pallas", pages_bound=4)
    kp_t, vp_t = torch.from_numpy(kp[0].copy()), torch.from_numpy(vp[0].copy())
    y_t = tmod.attn_decode_spec(
        tparams["blocks"][0]["attn"], torch.from_numpy(xw), kp_t, vp_t,
        torch.from_numpy(SPEC_TABLE), torch.from_numpy(SPEC_LENS),
        torch.from_numpy(SPEC_WLENS), cfg, pages_bound=4)
    # attention of the real rows (pad rows feed nothing downstream)
    for b, wl in enumerate(SPEC_WLENS):
        np.testing.assert_allclose(y_t.numpy()[b, :wl], np.asarray(y_j)[b, :wl], **LOGIT_TOL)
    # the real window rows land at the same pool rows in both packages
    for b, (L, wl) in enumerate(zip(SPEC_LENS, SPEC_WLENS)):
        for pos in range(L, L + wl):
            page, off = SPEC_TABLE[b, pos // PS], pos % PS
            for t, j in ((kp_t, kp_j), (vp_t, vp_j)):
                np.testing.assert_allclose(t.numpy()[page, off], np.asarray(j)[page, off], **TOL)
    # every other live page row is untouched: pad rows went to scratch page 0
    touched = {(SPEC_TABLE[b, p // PS], p % PS)
               for b, (L, wl) in enumerate(zip(SPEC_LENS, SPEC_WLENS)) for p in range(L, L + wl)}
    for page in range(1, NUM_PAGES):
        for off in range(PS):
            if (page, off) not in touched:
                assert np.array_equal(kp_t.numpy()[page, off], kp[0][page, off])


def test_decode_spec_logits_match_jax(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    kp, vp = _pools(tmodel, 3)
    W = 4
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, W)).astype(np.int32)
    jcache = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)}
    lj, _ = jmodel.decode_spec(jparams, jnp.asarray(tokens), jcache, jnp.asarray(SPEC_TABLE),
                               jnp.asarray(SPEC_LENS), jnp.asarray(SPEC_WLENS), pages_bound=4)
    tcache = {"k_pages": torch.from_numpy(kp.copy()), "v_pages": torch.from_numpy(vp.copy())}
    lt = tmodel.decode_spec(tparams, torch.from_numpy(tokens), tcache,
                            torch.from_numpy(SPEC_TABLE), torch.from_numpy(SPEC_LENS),
                            torch.from_numpy(SPEC_WLENS), pages_bound=4)
    assert lt.shape == (3, W, cfg.vocab_size) and lt.dtype == torch.float32
    for b, wl in enumerate(SPEC_WLENS):
        np.testing.assert_allclose(lt.numpy()[b, :wl], np.asarray(lj)[b, :wl], **LOGIT_TOL)


# ---------------------------------------------------------------------------
# serve_paged with speculation against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    return cfg, jmodel, jparams, tmodel, from_jax(jax.tree.map(np.asarray, jparams))


def _engines(weights, max_seq, slots):
    cfg, jmodel, jparams, tmodel, tparams = weights
    return (jeng.ServingEngine(jmodel, jparams, max_batch=slots, max_seq=max_seq),
            teng.ServingEngine(tmodel, tparams, max_batch=slots, max_seq=max_seq, device="cpu"))


def _serve(mod, engine, prompts, max_new, **kw):
    return engine.serve_paged(
        [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(prompts, max_new))], **kw)


def _same_tokens(a, b):
    return all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a.results, b.results))


def test_serve_paged_spec_tokens_equal_jax(weights):
    """The setup of test_serve_paged_spec_bit_identical: random-init greedy
    continuations cycle, so prompt lookup really accepts drafts."""
    cfg = weights[0]
    jengine, tengine = _engines(weights, 128, 3)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 7, 4)]
    max_new = (24, 16, 30, 12)
    kw = dict(num_slots=3, page_size=4, prefill_budget=16)
    want = _serve(jeng, jengine, prompts, max_new, spec_k=3, **kw)
    got = _serve(teng, tengine, prompts, max_new, spec_k=3, **kw)
    plain = _serve(teng, tengine, prompts, max_new, **kw)
    assert _same_tokens(got, want) and _same_tokens(got, plain)
    assert got.spec_k == 3 and plain.spec_stats == {}
    assert got.spec_stats == want.spec_stats
    assert got.spec_stats["draft_accepted"] > 0          # speculation really fired
    assert got.steps == want.steps < plain.steps
    assert got.total_tokens == plain.total_tokens
    assert [(r.draft_proposed, r.draft_accepted) for r in got.results] == \
        [(r.draft_proposed, r.draft_accepted) for r in want.results]


def test_serve_paged_spec_rejection_rollback_equals_jax(weights):
    """The setup of test_serve_paged_spec_rejection_rollback: a tiny
    alphabet makes drafts that are rejected mid-window, and page_size 2
    makes the rejected suffixes open pages that roll back."""
    jengine, tengine = _engines(weights, 64, 3)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 4, (12,)).astype(np.int32) for _ in range(3)]
    kw = dict(num_slots=3, page_size=2, prefill_budget=8, spec_k=3, spec_ngram=1)
    want = _serve(jeng, jengine, prompts, (14,) * 3, **kw)
    got = _serve(teng, tengine, prompts, (14,) * 3, **kw)
    assert _same_tokens(got, want)
    for key, value in want.spec_stats.items():
        assert got.spec_stats[key] == value, key
    assert got.spec_stats["draft_proposed"] > got.spec_stats["draft_accepted"]
    assert got.spec_stats["rollback_pages"] > 0
    for name in ("steps", "peak_pages_in_use", "total_tokens", "prefill_launches"):
        assert getattr(got, name) == getattr(want, name), name


def test_serve_paged_spec_ledger_accounting(weights):
    cfg = weights[0]
    _, tengine = _engines(weights, 128, 3)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (6,)).astype(np.int32) for _ in range(3)]
    budgets = (20, 3, 1)
    stats = _serve(teng, tengine, prompts, budgets, num_slots=3, page_size=4,
                   prefill_budget=16, spec_k=4)
    s = stats.spec_stats
    assert s["draft_accepted"] <= s["draft_proposed"]
    assert s["draft_proposed"] == sum(r.draft_proposed for r in stats.results)
    assert s["draft_accepted"] == sum(r.draft_accepted for r in stats.results)
    assert [len(r.tokens) for r in stats.results] == list(budgets)
    assert stats.results[2].draft_proposed == 0      # done at prefill: never drafted


def test_serve_paged_rejects_bad_spec_args(weights):
    _, tengine = _engines(weights, 32, 2)
    with pytest.raises(ValueError, match="spec_k"):
        tengine.serve_paged([], spec_k=-1)
    with pytest.raises(ValueError, match="spec_ngram"):
        tengine.serve_paged([], spec_k=2, spec_ngram=0)


# ---------------------------------------------------------------------------
# the max_seq edge: pad rows past the table never touch a live page
# ---------------------------------------------------------------------------
def _edge_draws():
    """Six draws of two prompts (12 and 14 tokens over {0..3}) from one
    generator; each request fills max_seq 32 exactly.  In the JAX engine
    the third draw's spec run differs from its plain run."""
    rng = np.random.default_rng(5)
    return [[rng.integers(0, 4, (12,)).astype(np.int32),
             rng.integers(0, 4, (14,)).astype(np.int32)] for _ in range(6)]


@pytest.mark.parametrize("draw", range(6))
def test_spec_equals_plain_at_the_max_seq_edge(weights, draw):
    _, tengine = _engines(weights, 32, 2)
    prompts = _edge_draws()[draw]
    max_new = [32 - len(p) for p in prompts]
    kw = dict(num_slots=2, page_size=4, prefill_budget=16)
    plain = _serve(teng, tengine, prompts, max_new, **kw)
    spec = _serve(teng, tengine, prompts, max_new, spec_k=4, spec_ngram=1, **kw)
    assert _same_tokens(spec, plain)
    assert [len(r.tokens) for r in spec.results] == max_new


def _overhang_step(weights):
    """A verify step whose slot 0 sits 2 tokens short of a 4-page table:
    its window of 1 real token has 3 pad rows past the table's end."""
    cfg, jmodel, jparams, tmodel, tparams = weights
    W, ps, max_pages, num_pages = 4, 4, 4, 10
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
    lens, wlens = np.array([14, 5], np.int32), np.array([1, 2], np.int32)
    rng = np.random.default_rng(8)
    shape = (cfg.num_layers, num_pages, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    kp, vp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    tokens = rng.integers(0, cfg.vocab_size, (2, W)).astype(np.int32)
    committed = [(table[b, p // ps], p % ps) for b in range(2) for p in range(lens[b])]
    return jmodel, jparams, tmodel, tparams, (tokens, table, lens, wlens), kp, vp, committed


def test_verify_step_leaves_committed_rows_when_pad_rows_overhang(weights):
    jmodel, jparams, tmodel, tparams, args, kp, vp, committed = _overhang_step(weights)
    cache = {"k_pages": torch.from_numpy(kp.copy()), "v_pages": torch.from_numpy(vp.copy())}
    tokens, table, lens, wlens = map(torch.from_numpy, args)
    tmodel.decode_spec(tparams, tokens, cache, table, lens, wlens, pages_bound=4)
    for name, before in (("k_pages", kp), ("v_pages", vp)):
        after = cache[name].numpy()
        for page, off in committed:
            assert np.array_equal(after[:, page, off], before[:, page, off]), (name, page, off)


def test_jax_reference_pad_rows_overwrite_a_committed_row(weights):
    """The reference's behaviour, recorded: slot 0's pad positions 16 and 17
    lie past its 4-page table; the page index clamps to the last column
    (page 4), so they overwrite committed positions 12 and 13 there."""
    jmodel, jparams, tmodel, tparams, args, kp, vp, committed = _overhang_step(weights)
    tokens, table, lens, wlens = map(jnp.asarray, args)
    _, jcache = jmodel.decode_spec(jparams, tokens, {"k_pages": jnp.asarray(kp),
                                                     "v_pages": jnp.asarray(vp)},
                                   table, lens, wlens, pages_bound=4)
    after = np.asarray(jcache["k_pages"])
    changed = [(p, o) for p, o in committed if not np.array_equal(after[:, p, o], kp[:, p, o])]
    assert changed == [(4, 0), (4, 1)]


def test_driver_runs_spec_on_cpu(capsys):
    assert tlaunch.main([
        "--device", "cpu", "--requests", "3", "--prompt-len", "10",
        "--prompt-len-min", "4", "--max-new-tokens", "6", "--engine-batch", "2",
        "--page-size", "4", "--max-seq", "24", "--spec-k", "3", "--spec-ngram", "1",
    ]) == 0
    out = capsys.readouterr().out
    assert "spec_k 3" in out and "draft_proposed" in out
    assert "generated_tokens     18" in out
