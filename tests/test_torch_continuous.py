"""The port's dense-cache engines (static ``generate`` and
``serve_continuous``), its request scheduler and its driver, against the
JAX engine and within the port.

Seeds and shapes are those of ``tests/test_serve_and_sharding.py``: reduced
glm4-9b, ``max_batch`` 2, ``max_seq`` 32.  Both engines run the same
weights (JAX ``model.init`` bridged with ``from_jax``); the JAX model is
built with ``backend="pallas"`` (interpret mode on the CPU).  Greedy tokens
must be exactly equal, with the same admission steps, slots and step
counts; inside the port the JAX suite's invariants hold bit for bit.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import analysis as janalysis
from repro.core import workload as jworkload
from repro.models import build_model
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.core import analysis as tanalysis
from repro_torch.core import workload as tworkload
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM, from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsch


@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg, backend="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jengine = jeng.ServingEngine(jmodel, jparams, max_batch=2, max_seq=32)
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    tengine = teng.ServingEngine(tmodel, tparams, max_batch=2, max_seq=32, device="cpu")
    return cfg, jengine, tengine


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]


def _requests(mod, prompts, max_new):
    return [mod.ServeRequest(request_id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


class VirtualClock:
    """A clock that advances one unit per read: deterministic timings."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# generate (the static engine)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lens,seed", [((7, 7), 0), ((3, 11), 5), ((16,), 6)])
def test_generate_tokens_equal_jax(engines, lens, seed):
    cfg, jengine, tengine = engines
    prompts = _prompts(cfg, lens, seed)
    want = jengine.generate(prompts, max_new_tokens=4)
    got = tengine.generate(prompts, max_new_tokens=4)
    assert got.tokens.shape == (len(lens), 4) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens_per_s > 0 and got.prefill_s > 0 and got.first_token_s > 0


def test_generate_first_token_is_forward_argmax(engines):
    cfg, _, tengine = engines
    prompts = _prompts(cfg, (7, 7), 0)
    res = tengine.generate(prompts, max_new_tokens=4)
    logits, _ = tengine.model.forward(tengine.params,
                                      {"tokens": torch.from_numpy(np.stack(prompts))})
    assert int(res.tokens[0, 0]) == int(logits[0, -1].argmax())
    assert int(res.tokens[1, 0]) == int(logits[1, -1].argmax())


def test_generate_pads_to_a_pow2_bucket_and_checks_limits(engines):
    _, jengine, tengine = engines
    prompts = [np.arange(5, dtype=np.int32), np.arange(9, dtype=np.int32)]
    for eng in (jengine, tengine):
        tokens, lens = eng._pad_prompts(prompts, max_new_tokens=4)
        assert tokens.shape == (2, 16) and lens.tolist() == [5, 9]
        assert eng._kv_bucket(17) == 32 and eng._kv_bucket(3) == 16
    with pytest.raises(ValueError, match="max_batch"):
        tengine.generate(prompts * 2, max_new_tokens=2)
    with pytest.raises(ValueError, match="max_seq"):
        tengine.generate(prompts, max_new_tokens=24)


# ---------------------------------------------------------------------------
# serve_continuous
# ---------------------------------------------------------------------------
def _schedule(stats):
    return [(r.request_id, r.slot, r.admit_step, r.finish_step, r.tokens.tolist())
            for r in stats.results]


@pytest.mark.parametrize("lens,max_new,slots,seed", [
    ((5, 5, 5), (2, 6, 3), 2, 1),                 # slot reuse
    ((5, 9, 7, 4), (6, 4, 8, 3), 2, 7),
    ((13, 3, 11, 6, 9), (4, 7, 2, 5, 6), 3, 11),
])
def test_serve_continuous_equals_jax(engines, lens, max_new, slots, seed):
    cfg, jengine, tengine = engines
    prompts = _prompts(cfg, lens, seed)
    want = jengine.serve_continuous(_requests(jeng, prompts, max_new), num_slots=slots,
                                    clock=VirtualClock())
    got = tengine.serve_continuous(_requests(teng, prompts, max_new), num_slots=slots,
                                   clock=VirtualClock())
    assert _schedule(got) == _schedule(want)
    for name in ("steps", "total_tokens", "mean_slot_occupancy", "wall_s"):
        assert getattr(got, name) == getattr(want, name), name
    for r_t, r_j in zip(got.results, want.results):
        assert (r_t.ttft_s, r_t.latency_s) == (r_j.ttft_s, r_j.latency_s)


def test_serve_continuous_slot_reuse(engines):
    """A queued prompt is admitted into the slot freed by a finished
    sequence, at a decode-step boundary."""
    cfg, _, tengine = engines
    prompts = _prompts(cfg, (5, 5, 5), 1)
    stats = tengine.serve_continuous(_requests(teng, prompts, (2, 6, 3)), num_slots=2,
                                     clock=VirtualClock())
    by_id = {r.request_id: r for r in stats.results}
    assert by_id[0].admit_step == 0 and by_id[1].admit_step == 0
    assert by_id[2].admit_step == by_id[0].finish_step > 0
    assert by_id[2].slot == by_id[0].slot
    for r in stats.results:
        assert len(r.tokens) == (2, 6, 3)[r.request_id]
        assert r.ttft_s > 0 and r.latency_s >= r.ttft_s
    assert stats.total_tokens == 2 + 6 + 3
    assert 1.0 <= stats.mean_slot_occupancy <= 2.0
    assert stats.prefill_tokens == 15


def test_serve_continuous_single_token_budget(engines):
    """A request whose whole budget is the prefill token retires without a
    decode step appending a second token."""
    _, _, tengine = engines
    stats = tengine.serve_continuous(
        [teng.ServeRequest(request_id=0, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=1)], num_slots=2)
    assert len(stats.results[0].tokens) == 1
    assert stats.total_tokens == 1 and stats.steps == 0


def test_serve_continuous_rejects_overlong_requests(engines):
    _, _, tengine = engines
    with pytest.raises(ValueError, match="max_seq"):
        tengine.serve_continuous([teng.ServeRequest(0, np.arange(30, dtype=np.int32), 4)])
    assert tengine.serve_continuous([]).results == []


def test_serve_continuous_matches_static_generate(engines):
    cfg, _, tengine = engines
    prompts = _prompts(cfg, (6, 6), 2)
    static = tengine.generate(prompts, max_new_tokens=4)
    cont = tengine.serve_continuous(_requests(teng, prompts, (4, 4)), num_slots=2)
    for i, r in enumerate(cont.results):
        np.testing.assert_array_equal(r.tokens, static.tokens[i])


def test_serve_paged_matches_continuous(engines):
    """The paged engine emits exactly the dense continuous engine's tokens
    on the JAX suite's requests: the two cache layouts are bit-compatible."""
    cfg, _, tengine = engines
    prompts = _prompts(cfg, (5, 9, 7, 4), 7)
    max_new = (6, 4, 8, 3)
    cont = tengine.serve_continuous(_requests(teng, prompts, max_new), num_slots=2)
    paged = tengine.serve_paged(_requests(teng, prompts, max_new), num_slots=3, page_size=4,
                                prefill_budget=8)
    by_id = {r.request_id: r for r in cont.results}
    for r in paged.results:
        np.testing.assert_array_equal(r.tokens, by_id[r.request_id].tokens)
    assert paged.total_tokens == cont.total_tokens == 6 + 4 + 8 + 3


def test_dense_engines_call_only_the_dense_kernels(engines, monkeypatch):
    """generate and serve_continuous reach flash_attention once per layer
    per prefill and decode_attention once per layer per decode step, and no
    paged kernel (on the card chip_smoke.py counts the launches)."""
    from repro_torch.kernels import ops

    cfg, _, tengine = engines
    calls = []
    for name in ("paged_attention", "varlen_prefill", "spec_verify", "flash_attention",
                 "decode_attention"):
        fn = getattr(ops, f"_{name}")
        monkeypatch.setattr(ops, f"_{name}",
                            lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    tengine.generate(_prompts(cfg, (5, 7), 3), max_new_tokens=3)
    cont = tengine.serve_continuous(_requests(teng, _prompts(cfg, (4, 6, 5), 4), (2, 3, 2)))
    L = cfg.num_layers
    # generate: one prefill pass and 3 decode steps; continuous: 3 admissions
    assert calls.count("flash_attention") == L * (1 + 3)
    assert calls.count("decode_attention") == L * (3 + cont.steps)
    assert len(calls) == L * (1 + 3 + 3 + cont.steps)


# ---------------------------------------------------------------------------
# the request scheduler (FIFO threaded core)
# ---------------------------------------------------------------------------
def test_scheduler_coalesces_fifo_batches():
    seen = []

    def execute(batch):
        seen.append([r.payload for r in batch])
        return [r.payload * 10 for r in batch]

    sched = tsch.RequestScheduler(execute, tsch.SchedulerConfig(max_batch=3,
                                                                batch_timeout_ms=50)).start()
    futs = [sched.submit(payload=i) for i in range(7)]
    assert [f.result(timeout=10) for f in futs] == [i * 10 for i in range(7)]
    sched.stop()
    flat = [p for b in seen for p in b]
    assert flat == list(range(7))                      # arrival order
    assert all(len(b) <= 3 for b in seen)
    stats = sched.stats()
    assert stats["submitted"] == stats["completed"] == 7.0
    assert stats["batches"] == len(seen) and stats["mean_batch_occupancy"] == 7 / len(seen)
    for f in futs:
        r = f.request
        assert r.status == "completed" and r.end_s >= r.start_s >= r.arrival_s
        assert r.latency_s == r.end_s - r.arrival_s


def test_scheduler_waits_for_stragglers_within_the_timeout():
    gate = threading.Event()
    sizes = []

    def execute(batch):
        gate.wait(5)
        sizes.append(len(batch))

    sched = tsch.RequestScheduler(execute, tsch.SchedulerConfig(max_batch=4,
                                                                batch_timeout_ms=300)).start()
    futs = [sched.submit(payload=0)]
    time.sleep(0.02)
    futs.append(sched.submit(payload=1))     # within the window: same batch
    gate.set()
    for f in futs:
        f.result(timeout=10)
    sched.stop()
    assert sizes == [2]


def test_scheduler_stamps_requests_with_perf_counter():
    sched = tsch.RequestScheduler(lambda batch: None, tsch.SchedulerConfig(max_batch=2)).start()
    t0 = time.perf_counter()
    futs = [sched.submit(payload=i) for i in range(3)]
    for f in futs:
        f.result(timeout=10)
    sched.stop()
    t1 = time.perf_counter()
    assert sched._thread is None                         # stop() joined the worker
    for f in futs:
        r = f.request
        assert t0 <= r.arrival_s <= r.start_s <= r.end_s <= t1


def test_scheduler_failures_and_admission_control():
    def execute(batch):
        raise RuntimeError("boom")

    sched = tsch.RequestScheduler(execute, tsch.SchedulerConfig(queue_depth=1))
    fut = sched.submit(payload=0)
    with pytest.raises(RuntimeError, match="not running"):
        fut.result()
    with pytest.raises(tsch.SchedulerQueueFull):
        sched.submit(payload=1, block=False)
    assert sched.rejected == 1 and sched.stats()["submitted"] == 1.0
    sched.start()
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=10)
    sched.stop()
    assert fut.request.status == "failed"
    with pytest.raises(ValueError, match="max_batch"):
        tsch.RequestScheduler(execute, tsch.SchedulerConfig(max_batch=0))


# ---------------------------------------------------------------------------
# the copies of repro.core the driver uses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,rate,seed", [(16, 20.0, 0), (5, 3.5, 7)])
def test_poisson_load_copy_matches(n, rate, seed):
    want = [(r.request_id, r.arrival_s, r.batch_size)
            for r in jworkload.PoissonLoad(n, rate, seed=seed).requests()]
    got = [(r.request_id, r.arrival_s, r.batch_size)
           for r in tworkload.PoissonLoad(n, rate, seed=seed).requests()]
    assert got == want
    with pytest.raises(ValueError, match="rate_hz"):
        tworkload.PoissonLoad(1, 0.0)


@pytest.mark.parametrize("values", [[0.3], [0.5, 0.1, 0.9, 0.2, 0.4, 0.7], list(np.linspace(0, 1, 11))])
def test_latency_summary_copy_matches(values):
    assert tanalysis.latency_summary(values) == janalysis.latency_summary(values)
    for pct in (0.0, 50.0, 99.0, 100.0):
        assert tanalysis.percentile(values, pct) == janalysis.percentile(values, pct)
    assert tanalysis.trimmed_mean(values) == janalysis.trimmed_mean(values)
    assert teng.percentile is tanalysis.percentile


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def test_driver_static_on_cpu(capsys):
    assert tlaunch.main([
        "--device", "cpu", "--engine", "static", "--requests", "5", "--prompt-len", "12",
        "--prompt-len-min", "3", "--max-new-tokens", "3", "--engine-batch", "2",
        "--page-size", "4", "--max-seq", "24", "--rate-hz", "500",
    ]) == 0
    out = capsys.readouterr().out
    assert "engine static" in out and "[serve] batch of " in out
    assert "generated_tokens     15" in out and "sched_completed      5.00" in out
    assert "ttft_p99_ms" in out and "decode_step_ms" in out


def test_driver_continuous_on_cpu(capsys):
    assert tlaunch.main([
        "--device", "cpu", "--engine", "continuous", "--requests", "4", "--prompt-len", "10",
        "--prompt-len-min", "2", "--max-new-tokens", "3", "--engine-batch", "2",
        "--page-size", "4", "--max-seq", "24",
    ]) == 0
    out = capsys.readouterr().out
    assert "engine continuous" in out and "[serve] req 3: slot " in out
    assert "generated_tokens     12" in out and "mean_slot_occupancy" in out


def test_static_run_reports_every_request(engines):
    cfg, _, tengine = engines
    prompts = _prompts(cfg, (4, 9, 6), 8)
    run = tlaunch.serve_static(tengine, prompts, [0.0, 0.0, 0.05], 2, batch_timeout_ms=1.0,
                               log=lambda _: None)
    assert len(run.tokens) == 3 and all(len(t) == 2 for t in run.tokens)
    assert sum(b[0] for b in run.batches) == 3 and sum(b[1] for b in run.batches) == 19
    assert all(0 < t <= l for t, l in zip(run.ttfts_s, run.latencies_s))
    assert run.sched_stats["completed"] == 3.0


def test_driver_rejects_paged_options_on_dense_engines():
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--engine", "static", "--spec-k", "2"])


# ---------------------------------------------------------------------------
# the end-to-end metrics (one definition for the driver and chip_smoke.py)
# ---------------------------------------------------------------------------
def test_static_metrics_definitions():
    run = tlaunch.StaticRun(
        tokens=[np.zeros(4, np.int32)] * 3, latencies_s=[0.5, 0.7, 0.9],
        ttfts_s=[0.1, 0.3, 0.2], batches=[(1, 10, 0.2, 0.4), (2, 30, 0.3, 0.8)],
        max_new_tokens=4, wall_s=2.0, sched_stats={})
    m = tlaunch.static_metrics(run)
    assert m["requests"] == 3 and m["generated_tokens"] == 12 and m["tokens_per_s"] == 6.0
    assert m["prefill_tok_per_s"] == pytest.approx(40 / 0.5, rel=1e-12)
    assert m["decode_steps"] == 8
    assert m["decode_step_ms"] == pytest.approx(1.2 / 8 * 1e3, rel=1e-12)
    assert m["decode_tok_per_s"] == pytest.approx(12 / 1.2, rel=1e-12)
    assert (m["ttft_p50_ms"], m["ttft_p99_ms"]) == (200.0, 300.0)
    assert m["p90_ms"] == tanalysis.latency_summary(run.latencies_s)["p90_ms"]


@pytest.mark.parametrize("engine_kind", ["continuous", "paged"])
def test_engine_metrics_definitions(engines, engine_kind):
    cfg, _, tengine = engines
    reqs = _requests(teng, _prompts(cfg, (5, 9, 7), 3), (3, 2, 4))
    if engine_kind == "continuous":
        stats = tengine.serve_continuous(reqs, num_slots=2)
    else:
        stats = tengine.serve_paged(reqs, num_slots=2, page_size=4, prefill_budget=8)
    m = tlaunch.engine_metrics(stats)
    assert m["requests"] == 3 and m["generated_tokens"] == stats.total_tokens == 9
    assert m["decode_steps"] == stats.steps > 0
    assert m["prefill_tok_per_s"] == stats.prefill_tokens / stats.prefill_s
    assert m["decode_tok_per_s"] == (9 - 3) / stats.decode_s
    assert m["decode_step_ms"] == stats.decode_s / stats.steps * 1e3
    ttfts = [r.ttft_s * 1e3 for r in stats.results]
    assert m["ttft_p99_ms"] == max(ttfts) and m["ttft_p50_ms"] in ttfts
