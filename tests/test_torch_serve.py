"""The port's paged serving loop against the JAX engine.

Setup of ``tests/test_varlen_prefill.py``: reduced glm4-9b, ``page_size=4``,
ragged prompts and a prefill budget small enough that prompts span several
boundaries.  Both engines run the same weights (JAX ``model.init`` bridged
with ``from_jax``); greedy tokens must be exactly equal and the prompt-token
ledger must balance.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.serve import engine as jeng
from repro.serve import page_table as jpt
from repro.serve import scheduler as jsch
from repro_torch.configs import get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM, from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve import page_table as tpt
from repro_torch.serve import scheduler as tsch


@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jengine = jeng.ServingEngine(jmodel, jparams, max_batch=3, max_seq=32)
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    tengine = teng.ServingEngine(tmodel, tparams, max_batch=3, max_seq=32, device="cpu")
    return cfg, jengine, tengine


def _requests(mod, cfg, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


SERVE_CASES = [
    # prompt lengths, max new tokens, prefill budget, slots, seed
    ((5, 9, 7, 4), (6, 4, 8, 3), 8, 3, 7),
    ((13, 3, 11, 6, 9), (4, 7, 2, 5, 6), 12, 2, 11),
    ((20, 2, 8), (3, 9, 5), 16, 3, 3),
]


@pytest.mark.parametrize("lens,max_new,budget,slots,seed", SERVE_CASES)
def test_serve_paged_tokens_equal_jax(engines, lens, max_new, budget, slots, seed):
    cfg, jengine, tengine = engines
    kw = dict(num_slots=slots, page_size=4, prefill_budget=budget)
    want = jengine.serve_paged(_requests(jeng, cfg, lens, max_new, seed), **kw)
    got = tengine.serve_paged(_requests(teng, cfg, lens, max_new, seed), **kw)
    for r_t, r_j in zip(got.results, want.results):
        assert r_t.request_id == r_j.request_id
        np.testing.assert_array_equal(r_t.tokens, r_j.tokens)
    assert got.prompt_tokens_admitted == (
        got.prefill_tokens + got.saved_prefill_tokens + got.prefill_tokens_dropped)
    assert got.prompt_tokens_admitted == sum(lens)
    # the same schedule: launches, spans, decode steps and the budget ledger
    for name in ("prefill_launches", "prefill_chunks", "prefill_tokens",
                 "prefill_padded_tokens", "steps", "peak_pages_in_use",
                 "peak_slot_occupancy", "total_tokens"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.prefill_budget_stats == want.prefill_budget_stats


def test_serve_paged_prompts_span_several_boundaries(engines):
    cfg, _, tengine = engines
    stats = tengine.serve_paged(
        _requests(teng, cfg, (20,), (2,), seed=1), num_slots=2, page_size=4,
        prefill_budget=8,
    )
    assert stats.prefill_launches >= 3          # 20 tokens / 8-token budget
    assert stats.prefill_budget_stats["granted_tokens"] == 20.0
    assert stats.prefill_budget_stats["starved_tokens"] > 0
    assert stats.kv_dtype == "float32"


def test_serve_paged_validates_requests(engines):
    cfg, _, tengine = engines
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tengine.serve_paged(_requests(teng, cfg, (30,), (5,), seed=0), page_size=4)
    assert tengine.serve_paged([]).results == []


def test_entry_points_default_to_cuda():
    """Without a card, asking for the default device raises; nothing falls
    back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("glm4-9b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderLM(cfg)
    model = DecoderLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.ServingEngine(model, model.init(), max_batch=2, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--requests", "1"])


def test_engine_rejects_model_on_another_device():
    model = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        teng.ServingEngine(model, model.init(), max_batch=2, max_seq=16, device="meta")


def test_driver_runs_on_cpu(capsys):
    assert tlaunch.main([
        "--device", "cpu", "--requests", "4", "--prompt-len", "12",
        "--prompt-len-min", "3", "--max-new-tokens", "3", "--engine-batch", "2",
        "--page-size", "4", "--max-seq", "24", "--prefill-budget", "8",
    ]) == 0
    out = capsys.readouterr().out
    assert "generated_tokens     12" in out
    assert "ttft_p99_ms" in out


# ---------------------------------------------------------------------------
# the bookkeeping copies behave like the originals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 5, 16, 17, 100])
def test_bucket_and_pages_needed_match(n):
    assert teng.bucket_pow2(n, floor=4, cap=64) == jeng.bucket_pow2(n, floor=4, cap=64)
    assert tpt.pages_needed(n, 16) == jpt.pages_needed(n, 16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_and_table_copies_match(seed):
    """A random sequence of allocations, shares, frees and table edits leaves
    the two packages' pools and tables in the same state."""
    rng = np.random.default_rng(seed)
    pools = [jpt.PagePool(20, 4), tpt.PagePool(20, 4)]
    tables = [jpt.PageTable(3, 5), tpt.PageTable(3, 5)]
    held = {s: [] for s in range(3)}
    for _ in range(60):
        s = int(rng.integers(3))
        op = rng.integers(3)
        if op == 0 and len(held[s]) < 5:
            got = [p.alloc(1) for p in pools]
            assert got[0] == got[1]
            if got[0] is not None:
                for t in tables:
                    t.append(s, got[0][0])
                held[s].append(got[0][0])
        elif op == 1 and held[s]:
            for p in pools:
                p.incref(held[s][:1])
                assert p.free(held[s][:1]) == []
        elif held[s]:
            pages = [t.clear(s) for t in tables]
            assert pages[0] == pages[1] == held[s]
            assert pools[0].free(pages[0]) == pools[1].free(pages[1])
            held[s] = []
        assert pools[0].num_free == pools[1].num_free
        assert pools[0].peak_in_use == pools[1].peak_in_use
        np.testing.assert_array_equal(tables[0].table, tables[1].table)


def test_prefill_budget_and_slot_pool_copies_match():
    budgets = [jsch.PrefillBudget(16), tsch.PrefillBudget(16)]
    for b in budgets:
        b.begin_step()
        b.grant(10)
        b.grant(10)
        b.defer(3)
        b.begin_step()
        b.grant(4)
        b.credit(2)
    assert budgets[0].stats() == budgets[1].stats()
    assert budgets[0].granted_series == budgets[1].granted_series
    slot_pools = [jsch.PagedSlotPool(2, jpt.PagePool(8, 4)),
                  tsch.PagedSlotPool(2, tpt.PagePool(8, 4))]
    for sp in slot_pools:
        a = sp.admit_paged("a", 3)
        b = sp.admit_paged("b", 3)
        assert sp.admit_paged("c", 1) is None    # no free slot
        sp.release_paged(a[0], a[1], preempted=True)
        sp.record_occupancy(1)
    assert [sp.preemptions for sp in slot_pools] == [1, 1]
    assert slot_pools[0].pages_in_use_series == slot_pools[1].pages_in_use_series
