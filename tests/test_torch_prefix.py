"""The prefix cache with copy-on-write in the port against the JAX package.

``PrefixCache`` against the reference class under the same operations (the
cases of ``tests/test_prefix_cache.py`` run on both classes, and random
sequences of lookups, inserts, releases and evictions that must leave the
same pages, refcounts and stats); ``copy_pages`` against
``repro.kernels.ops.copy_pages`` on full-precision and int8/fp8 pools; and
``serve_paged(prefix_cache=True)`` against the JAX engine on the same
weights (reduced glm4-9b): tokens, saved prompt tokens, copies, the cache's
stats and the ``prefix:*`` events, over packed and chunked prefill with and
without speculation, a full hit, eviction under pressure and preemption of
a request admitted on a hit.  Tokens must also equal the port's cache-off
run, and the prompt-token ledger must balance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import analysis as janalysis
from repro.core import tracing as jtracing
from repro.kernels import kvquant as jkvq
from repro.kernels import ops as jops
from repro.models import build_model
from repro.serve import engine as jeng
from repro.serve import page_table as jpt
from repro_torch.configs import get_config
from repro_torch.core import analysis as tanalysis
from repro_torch.core import tracing as ttracing
from repro_torch.kernels import ops
from repro_torch.models import DecoderLM, from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve import page_table as tpt

PKGS = pytest.mark.parametrize("pt", [jpt, tpt], ids=["jax", "torch"])


# ---------------------------------------------------------------------------
# PrefixCache: the reference's cases on both classes
# ---------------------------------------------------------------------------
def _prompt(*blocks):
    return np.concatenate([np.asarray(b, np.int32) for b in blocks])


@PKGS
def test_prefix_cache_lookup_longest_chain(pt):
    pool = pt.PagePool(num_pages=16, page_size=4)
    cache = pt.PrefixCache(pool)
    b0, b1, b2 = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]
    pages = pool.alloc(3)
    cache.insert(_prompt(b0, b1, b2), pages)
    assert all(pool.refcount(p) == 2 for p in pages)
    assert cache.lookup(_prompt(b0, b1, [9, 9, 9, 9], [1])) == (pages[:2], 8)
    assert cache.lookup(_prompt(b0, b1, b2)) == (pages, 12)
    assert cache.lookup(_prompt([7, 7, 7, 7])) == ([], 0)
    assert cache.lookup(_prompt(b1, b2))[0] == []      # not reached through the chain
    assert cache.lookup(_prompt(b0, [5, 6])) == (pages[:1], 4)
    s = cache.stats()
    assert s["lookups"] == 5.0 and s["hits"] == 3.0 and s["full_hits"] == 1.0


@PKGS
def test_prefix_cache_eviction_lru_leaf_first(pt):
    pool = pt.PagePool(num_pages=16, page_size=4)
    cache = pt.PrefixCache(pool)
    chain_a, chain_b = pool.alloc(2), pool.alloc(2)
    cache.insert(_prompt([1, 2, 3, 4], [5, 6, 7, 8]), chain_a)
    cache.insert(_prompt([9, 9, 9, 9], [8, 8, 8, 8]), chain_b)
    pool.free(chain_a)
    pool.free(chain_b)
    assert cache.evictable == 4
    cache.lookup(_prompt([1, 2, 3, 4], [5, 6, 7, 8]))
    assert cache.evict(1) == 1
    assert pool.refcount(chain_b[1]) == 0 and pool.refcount(chain_b[0]) == 1
    assert cache.evict(10) == 3
    assert len(cache) == 0 and pool.num_free == pool.capacity


@PKGS
def test_prefix_cache_eviction_skips_referenced_pages(pt):
    pool = pt.PagePool(num_pages=16, page_size=4)
    cache = pt.PrefixCache(pool)
    pages = pool.alloc(2)
    cache.insert(_prompt([1, 2, 3, 4], [5, 6, 7, 8]), pages)
    assert cache.evictable == 0 and cache.evict(5) == 0
    assert pool.refcount(pages[0]) == 2
    pool.free(pages)
    assert cache.evict(5) == 2
    assert cache.stats()["evicted_pages"] == 2.0


@PKGS
def test_prefix_cache_insert_is_first_writer_wins(pt):
    pool = pt.PagePool(num_pages=16, page_size=4)
    cache = pt.PrefixCache(pool)
    first, second = pool.alloc(1), pool.alloc(1)
    assert cache.insert(_prompt([1, 2, 3, 4]), first) == 1
    assert cache.insert(_prompt([1, 2, 3, 4]), second) == 0
    assert cache.lookup(_prompt([1, 2, 3, 4]))[0] == first
    assert pool.refcount(second[0]) == 1


@PKGS
def test_pool_refcounts_and_replace(pt):
    pool = pt.PagePool(num_pages=8, page_size=4)
    pages = pool.alloc(3)
    pool.incref(pages[:2])
    assert pool.num_shared == 2 and pool.free(pages[:2]) == []
    assert sorted(pool.free(pages)) == sorted(pages)
    with pytest.raises(ValueError, match="double free"):
        pool.free(pages[:1])
    table = pt.PageTable(num_slots=2, max_pages=4)
    table.assign(0, [5, 6, 7])
    assert table.replace(0, 1, 9) == 6 and table.pages_of(0) == [5, 9, 7]
    with pytest.raises(ValueError, match="no logical page"):
        table.replace(0, 3, 2)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_random_operations_match(seed):
    """Random admissions (match, incref, record), prefills (alloc, insert),
    releases and evictions on both packages' pools and caches: every result,
    refcount, free list and stats dict stays equal."""
    rng = np.random.default_rng(seed)
    pools = [jpt.PagePool(40, 4), tpt.PagePool(40, 4)]
    caches = [jpt.PrefixCache(pools[0]), tpt.PrefixCache(pools[1])]
    stems = [rng.integers(0, 6, (12,)).astype(np.int32) for _ in range(3)]
    held = []                               # live requests' pages
    for _ in range(80):
        op = rng.integers(4)
        if op <= 1:
            stem = stems[rng.integers(3)]
            prompt = np.concatenate([stem[: 4 * rng.integers(0, 4)],
                                     rng.integers(0, 6, (rng.integers(1, 9),)).astype(np.int32)])
            outs = []
            for pool, cache in zip(pools, caches):
                hit, cached = cache.match(prompt)
                n = pool.pages_needed(len(prompt)) - len(hit)
                if hit:
                    pool.incref(hit)
                evicted = cache.evict(max(n - pool.num_free, 0))
                fresh = pool.alloc(n)
                if fresh is None:
                    if hit:
                        pool.free(hit)
                    outs.append((hit, cached, evicted, None))
                    continue
                cache.record(len(prompt), hit)
                added = cache.insert(prompt, hit + fresh)
                outs.append((hit, cached, evicted, fresh, added))
            assert outs[0] == outs[1]
            if outs[0][3] is not None:
                held.append(outs[0][0] + outs[0][3])
        elif op == 2 and held:
            pages = held.pop(int(rng.integers(len(held))))
            assert pools[0].free(pages) == pools[1].free(pages)
        else:
            need = int(rng.integers(1, 6))
            assert caches[0].evict(need) == caches[1].evict(need)
        assert pools[0]._free == pools[1]._free and pools[0]._ref == pools[1]._ref
        assert caches[0].stats() == caches[1].stats()
        assert caches[0].evictable == caches[1].evictable


# ---------------------------------------------------------------------------
# copy_pages against the JAX op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [None, "bfloat16", "int8", "fp8"])
def test_copy_pages_matches_jax(mode):
    rng = np.random.default_rng(0)
    shape = (3, 10, 4, 2, 8)                    # (L, num_pages, page_size, kvh, d)
    kv = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    src, dst = np.array([2, 5, 7], np.int32), np.array([9, 1, 4], np.int32)
    if mode in ("int8", "fp8"):
        pairs = [jkvq.quantize(jnp.asarray(t), jkvq.pool_dtype(mode)) for t in kv]
        jargs = [q for q, _ in pairs] + [jnp.asarray(src), jnp.asarray(dst)] + [
            s for _, s in pairs]
        to_t = ((lambda a: torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(
            torch.float8_e4m3fn)) if mode == "fp8" else (lambda a: torch.from_numpy(
                np.asarray(a).copy())))
        pools = [to_t(q) for q, _ in pairs] + [torch.from_numpy(np.asarray(s).copy())
                                               for _, s in pairs]
    else:
        jdt = jnp.bfloat16 if mode else jnp.float32
        jargs = [jnp.asarray(t, jdt) for t in kv] + [jnp.asarray(src), jnp.asarray(dst)]
        pools = [torch.from_numpy(t.copy()).to(torch.bfloat16 if mode else torch.float32)
                 for t in kv]
    want = jops.copy_pages(*jargs)
    before = [p.clone() for p in pools]
    ptrs = [p.data_ptr() for p in pools]
    assert ops.copy_pages(pools[0], pools[1], src, dst, *pools[2:]) is None
    assert [p.data_ptr() for p in pools] == ptrs          # in place, no new pools
    for t, j, b in zip(pools, want, before):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j).astype(np.float32))
        np.testing.assert_array_equal(t[:, dst].float().numpy(), b[:, src].float().numpy())


# ---------------------------------------------------------------------------
# serve_paged with the cache on, against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    cache = {}

    def make(max_seq, num_slots=4, kv_dtype=None):
        key = (max_seq, num_slots, kv_dtype)
        if key not in cache:
            cache[key] = (
                jeng.ServingEngine(jmodel, jparams, max_batch=num_slots, max_seq=max_seq,
                                   kv_dtype=kv_dtype),
                teng.ServingEngine(tmodel, tparams, max_batch=num_slots, max_seq=max_seq,
                                   device="cpu", kv_dtype=kv_dtype))
        return cache[key]
    return cfg, make


def _shared(cfg, seed, page=8, n=8, gen=5):
    """A shared 3-page prefix with unique tails, and verbatim page-aligned
    repeats of the prefix (full hits), as tests/test_prefix_cache.py builds
    them."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (3 * page,)).astype(np.int32)
    prompts = [prefix.copy() if i % 3 == 2 else
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (5,)).astype(np.int32)])
               for i in range(n)]
    return lambda mod: [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=gen)
                        for i, p in enumerate(prompts)]


def _tokens(stats):
    return {r.request_id: r.tokens.tolist() for r in stats.results}


def _ledger_exact(stats):
    assert stats.prompt_tokens_admitted == (
        stats.prefill_tokens + stats.saved_prefill_tokens + stats.prefill_tokens_dropped)


COUNTS = ("steps", "preemptions", "prefill_launches", "prefill_tokens", "saved_prefill_tokens",
          "prefill_tokens_dropped", "prompt_tokens_admitted", "cow_copies", "cache_evictions",
          "peak_pages_in_use")


def _same_as_jax(got, want):
    assert _tokens(got) == _tokens(want)
    for name in COUNTS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.prefix_stats == want.prefix_stats
    assert got.prefill_budget_stats == want.prefill_budget_stats
    assert got.spec_stats == want.spec_stats


@pytest.mark.parametrize("prefill_mode", ["packed", "chunked"])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_prefix_cache_matches_jax(engines, prefill_mode, spec_k):
    cfg, make = engines
    jengine, tengine = make(96)
    reqs = _shared(cfg, 11)
    kw = dict(num_slots=4, page_size=8, prefill_mode=prefill_mode, spec_k=spec_k,
              prefill_chunk=16, prefill_budget=32)
    want = jengine.serve_paged(reqs(jeng), prefix_cache=True, **kw)
    on = tengine.serve_paged(reqs(teng), prefix_cache=True, **kw)
    off = tengine.serve_paged(reqs(teng), **kw)
    _same_as_jax(on, want)
    assert _tokens(on) == _tokens(off)
    assert on.prefix_stats["hits"] > 0 and on.prefix_stats["full_hits"] > 0
    assert on.cow_copies > 0 and on.saved_prefill_tokens > 0
    assert on.prefill_tokens < off.prefill_tokens
    assert off.saved_prefill_tokens == 0 and off.prefix_stats == {} and not off.prefix_cache
    _ledger_exact(on)
    _ledger_exact(off)
    if prefill_mode == "packed":
        b = on.prefill_budget_stats
        assert b["cached_tokens"] == on.saved_prefill_tokens
        assert b["granted_tokens"] + on.saved_prefill_tokens == on.prompt_tokens_admitted


def test_full_hit_replays_through_decode(engines):
    """One slot, three identical page-aligned prompts: the second and third
    fully hit, skip prefill and copy the shared last page before their
    first decode step."""
    cfg, make = engines
    jengine, tengine = make(96)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (16,)).astype(np.int32)
    reqs = lambda mod: [mod.ServeRequest(request_id=i, prompt=prompt.copy(), max_new_tokens=4)
                        for i in range(3)]
    want = jengine.serve_paged(reqs(jeng), num_slots=1, page_size=8, prefix_cache=True)
    on = tengine.serve_paged(reqs(teng), num_slots=1, page_size=8, prefix_cache=True)
    off = tengine.serve_paged(reqs(teng), num_slots=1, page_size=8)
    _same_as_jax(on, want)
    assert _tokens(on) == _tokens(off)
    assert on.prefix_stats["full_hits"] == 2.0 and on.cow_copies == 2
    assert on.prefill_tokens == 16
    _ledger_exact(on)


def test_eviction_under_pressure_never_frees_a_referenced_page(engines):
    cfg, make = engines
    jengine, tengine = make(64, num_slots=2)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, (24,)).astype(np.int32) for _ in range(6)]
    reqs = lambda mod: [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=4)
                        for i, p in enumerate(prompts)]
    kw = dict(num_slots=2, page_size=8, num_pages=14)
    want = jengine.serve_paged(reqs(jeng), prefix_cache=True, **kw)
    on = tengine.serve_paged(reqs(teng), prefix_cache=True, **kw)
    off = tengine.serve_paged(reqs(teng), **kw)
    _same_as_jax(on, want)
    assert _tokens(on) == _tokens(off)
    assert on.cache_evictions > 0
    assert on.prefix_stats["evicted_pages"] == float(on.cache_evictions)
    assert on.peak_pages_in_use <= on.num_pages
    _ledger_exact(on)


def test_preemption_of_a_hit_request(engines):
    cfg, make = engines
    jengine, tengine = make(48, num_slots=3)
    rng = np.random.default_rng(17)
    prefix = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32)])
               for _ in range(4)]
    reqs = lambda mod: [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, (10, 8, 12, 6)))]
    kw = dict(num_slots=3, page_size=4, num_pages=13, overcommit=10.0, prefill_budget=8)
    want = jengine.serve_paged(reqs(jeng), prefix_cache=True, **kw)
    on = tengine.serve_paged(reqs(teng), prefix_cache=True, **kw)
    off = tengine.serve_paged(reqs(teng), **kw)
    assert on.preemptions > 0
    _same_as_jax(on, want)
    assert _tokens(on) == _tokens(off)
    _ledger_exact(on)
    _ledger_exact(off)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_prefix_cache_copies_scales(engines, mode):
    """On an int8/fp8 pool the copy-on-write moves the scale rows with the
    codes: cache-on tokens equal cache-off, and JAX's."""
    cfg, make = engines
    jengine, tengine = make(64, num_slots=3, kv_dtype=mode)
    reqs = _shared(cfg, 5, n=6)
    kw = dict(num_slots=3, page_size=8, num_pages=40)
    want = jengine.serve_paged(reqs(jeng), prefix_cache=True, **kw)
    on = tengine.serve_paged(reqs(teng), prefix_cache=True, **kw)
    off = tengine.serve_paged(reqs(teng), **kw)
    assert on.cow_copies > 0
    assert _tokens(on) == _tokens(off) == _tokens(want)
    assert on.cow_copies == want.cow_copies


def test_prefix_events_and_summary_match_jax(engines):
    cfg, make = engines
    jengine, tengine = make(96)
    reqs = _shared(cfg, 11, n=6)
    spans = {}
    for mod, tr, eng in ((jeng, jtracing, jengine), (teng, ttracing, tengine)):
        server = tr.TracingServer()
        stats = eng.serve_paged(reqs(mod), num_slots=2, page_size=8, prefix_cache=True,
                                tracer=tr.Tracer("t", server))
        spans[mod] = (server.timeline("t"), stats)
    jspans, jstats = spans[jeng]
    tspans, tstats = spans[teng]
    pick = lambda ss: [(s.name, s.tags) for s in ss if s.name.startswith("prefix:")]
    assert pick(tspans) == pick(jspans) and pick(tspans)
    summary = tanalysis.prefix_cache_summary(tspans)
    assert summary == janalysis.prefix_cache_summary(jspans)
    assert summary["lookups"] == tstats.prefix_stats["lookups"]
    assert summary["saved_prefill_tokens"] == float(tstats.saved_prefill_tokens)
    assert summary["cow_copies"] == float(tstats.cow_copies) > 0
