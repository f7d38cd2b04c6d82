"""The port's ``FleetRouter`` against the JAX package's, over stub engines.

The reference's router tests (``tests/test_fleet.py``, the drain/join cases
of ``tests/test_recovery.py``) run on the port's router, over a stub engine
that raises the port's ``WorkerCrash``, under a virtual clock; the same
scripted scenarios go through both routers (each over a stub of its own
package) and must give equal per-request results, equal ``FleetStats``
counters and equal fleet summaries.  Then what the port does differently:
an exception other than a crash inside a worker ends ``serve()`` with that
exception, sequential and parallel (the reference's parallel mode hides it
behind a lapsed lease).  A straggler hedged on real engines dedupes, and
the kernel library's first load is taken once under a lock however many
workers' threads ask for it.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import analysis as janalysis
from repro.core import tracing as jtracing
from repro.serve import engine as jeng
from repro.serve import faults as jfaults
from repro.serve import fleet as jfleet
from repro_torch.core import analysis as tanalysis
from repro_torch.core import tracing as ttracing
from repro_torch.kernels import _build
from repro_torch.serve import engine as teng
from repro_torch.serve import faults as tfaults
from repro_torch.serve import fleet as tfleet

# (fleet module, faults module, engine module, analysis, tracing) per package
JAX = (jfleet, jfaults, jeng, janalysis, jtracing)
TORCH = (tfleet, tfaults, teng, tanalysis, ttracing)


class VirtualTime:
    def __init__(self):
        self.t = 0.0
        self._lock = threading.Lock()

    def clock(self):
        with self._lock:
            return self.t

    def sleep(self, dt):
        with self._lock:
            self.t += dt


def make_stub(faults):
    """A ``serve_paged`` stand-in of one package: one request finishes per
    boundary, the fault hook runs at every boundary, and a crash carries the
    resumable snapshot the real engine attaches."""

    class StubEngine:
        def __init__(self, vt, max_seq=64, max_batch=4, page_size=8, boundary_s=0.0):
            self.vt = vt
            self.max_seq = max_seq
            self.max_batch = max_batch
            self.page_size = page_size
            self.boundary_s = boundary_s
            self.calls = 0

        @staticmethod
        def tokens_for(req):
            return np.arange(req.max_new_tokens, dtype=np.int32) + req.request_id

        def serve_paged(self, reqs, clock=None, tracer=None, fault_hook=None, **kwargs):
            self.calls += 1
            finished, pending, step = [], list(reqs), 0
            while pending:
                if self.boundary_s:
                    self.vt.sleep(self.boundary_s)
                if fault_hook is not None:
                    try:
                        fault_hook(faults.FaultContext(step=step, clock=self.vt.clock,
                                                       tracer=tracer))
                    except faults.WorkerCrash as crash:
                        crash.results = list(finished)
                        crash.pending = list(pending)
                        if hasattr(fault_hook, "release"):
                            fault_hook.release()
                        raise
                req = pending.pop(0)
                finished.append(SimpleNamespace(request_id=req.request_id,
                                                tokens=self.tokens_for(req)))
                step += 1
            if fault_hook is not None and hasattr(fault_hook, "release"):
                fault_hook.release()
            return SimpleNamespace(results=finished)

    return StubEngine


StubEngine = make_stub(tfaults)
STUBS = {jfleet: make_stub(jfaults), tfleet: StubEngine}


def _reqs(n, prompt_len=16, gen=6, eng=teng):
    return [eng.ServeRequest(request_id=i, prompt=np.zeros((prompt_len,), np.int32),
                             max_new_tokens=gen) for i in range(n)]


def _router(vt, n_workers, plan=None, cfg=None, **stub_kw):
    engines = [StubEngine(vt, **stub_kw) for _ in range(n_workers)]
    return tfleet.FleetRouter(engines, cfg or tfleet.FleetConfig(), fault_plan=plan,
                              clock=vt.clock, sleep=vt.sleep)


def _expected(r):
    return StubEngine.tokens_for(SimpleNamespace(request_id=r.request_id, max_new_tokens=6))


# ---------------------------------------------------------------------------
# the reference's router cases on the port's router
# ---------------------------------------------------------------------------
def test_degrade_ladder_hysteresis():
    vt = VirtualTime()
    ladder = tfleet.DegradeLadder(high=0.8, low=0.5, clock=vt.clock)
    seq = [ladder.update(p) for p in (0.9, 0.9, 0.9, 0.9, 0.7, 0.4, 0.4, 0.4)]
    assert seq == [1, 2, 3, 3, 3, 2, 1, 0]
    assert ladder.max_level == 3
    assert tfleet.DEGRADE_LEVELS[3] == "shed"
    assert len(ladder.transitions) == 6
    with pytest.raises(ValueError):
        tfleet.DegradeLadder(high=0.4, low=0.5)


def test_degrade_hysteresis_never_oscillates_within_a_crossing():
    vt = VirtualTime()
    ladder = tfleet.DegradeLadder(high=0.85, low=0.60, clock=vt.clock)
    assert ladder.update(0.9) == 1
    for p in (0.84, 0.61, 0.70, 0.84, 0.60, 0.75) * 5:
        vt.sleep(0.01)
        ladder.update(p)
    assert ladder.level == 1 and len(ladder.transitions) == 1
    assert ladder.update(0.59) == 0 and len(ladder.transitions) == 2


def test_fault_free_fleet_completes_everything():
    vt = VirtualTime()
    stats = _router(vt, 3).serve(_reqs(9))
    assert stats.completed == 9
    assert stats.failed == stats.rejected == stats.deaths == 0
    assert stats.goodput == 1.0
    for r in stats.results:
        assert np.array_equal(r.tokens, _expected(r))


def test_requeue_on_death_replays_on_survivors():
    vt = VirtualTime()
    router = _router(vt, 3, plan=tfaults.FaultPlan([tfaults.FaultSpec("crash", 1, 1)]))
    stats = router.serve(_reqs(9))
    assert stats.deaths == 1 and stats.requeued > 0
    assert stats.completed == 9 and stats.failed == stats.rejected == 0
    assert len(stats.recovery_s) == 1
    assert any(r.attempts == 2 for r in stats.results)
    assert [w.index for w in router.workers if not w.alive] == [1]
    assert all(np.array_equal(r.tokens, _expected(r)) for r in stats.results)


def test_all_workers_dead_fails_attributed_not_hangs():
    vt = VirtualTime()
    stats = _router(vt, 1, plan=tfaults.FaultPlan([tfaults.FaultSpec("crash", 0, 0)])).serve(
        _reqs(4))
    assert stats.deaths == 1
    assert stats.completed + stats.failed == 4
    assert {r.reason for r in stats.results if r.status == "failed"} <= {"no-workers-left"}
    assert stats.failed > 0


def test_retries_exhausted_is_attributed():
    vt = VirtualTime()
    plan = tfaults.FaultPlan([tfaults.FaultSpec("crash", 0, 0), tfaults.FaultSpec("crash", 1, 0)])
    stats = _router(vt, 3, plan=plan, cfg=tfleet.FleetConfig(max_retries=1)).serve(_reqs(1))
    r = stats.results[0]
    assert (r.status, r.reason, r.attempts) == ("failed", "retries-exhausted", 2)
    assert stats.deaths == 2


def test_deadline_enforced_and_goodput_accounted():
    vt = VirtualTime()
    router = _router(vt, 1, cfg=tfleet.FleetConfig(deadline_s=1.5), max_batch=1, boundary_s=0.5)
    stats = router.serve(_reqs(5, gen=4))
    assert stats.completed + stats.failed == 5
    failed = [r for r in stats.results if r.status == "failed"]
    assert failed and all(r.reason == "deadline" for r in failed)
    assert [r for r in stats.results if r.status == "completed" and not r.within_deadline]
    assert 0.0 < stats.goodput < 1.0


def test_oversize_request_fails_up_front():
    vt = VirtualTime()
    reqs = _reqs(3, prompt_len=16, gen=6)
    reqs[1] = teng.ServeRequest(request_id=1, prompt=np.zeros((40,), np.int32), max_new_tokens=8)
    stats = _router(vt, 2, max_seq=32).serve(reqs)
    assert (stats.result_of(1).status, stats.result_of(1).reason) == ("failed", "oversize")
    assert stats.completed == 2
    with pytest.raises(KeyError):
        stats.result_of(99)


def test_duplicate_request_ids_rejected():
    vt = VirtualTime()
    reqs = _reqs(2)
    reqs[1] = teng.ServeRequest(request_id=0, prompt=reqs[1].prompt, max_new_tokens=6)
    with pytest.raises(ValueError, match="duplicate request_id"):
        _router(vt, 1).serve(reqs)


def test_engine_kwargs_may_not_override_the_routers_own():
    vt = VirtualTime()
    for key in ("clock", "tracer", "fault_hook"):
        with pytest.raises(ValueError, match="may not override"):
            tfleet.FleetRouter([StubEngine(vt)], engine_kwargs={key: None})
    with pytest.raises(ValueError, match="at least one engine"):
        tfleet.FleetRouter([])


def test_commit_is_idempotent():
    vt = VirtualTime()
    router = _router(vt, 1)
    stats = router.serve(_reqs(2))
    assert stats.duplicate_commits == 0
    t = router._by_id[0]
    before = (t.result.tokens, t.result.worker)
    assert router._commit(t, np.zeros((6,), np.int32), worker=0, now=vt.clock()) is False
    assert router._dups == 1
    assert t.result.tokens is before[0] and t.result.worker == before[1]


def _overload(vt, reqs, cfg=None):
    router = tfleet.FleetRouter(
        [StubEngine(vt)], cfg or tfleet.FleetConfig(),
        engine_kwargs={"num_pages": 7, "num_slots": 1, "page_size": 8},
        clock=vt.clock, sleep=vt.sleep)
    return router, router.serve(reqs)


def test_sustained_overload_sheds_explicitly():
    vt = VirtualTime()
    _, stats = _overload(vt, _reqs(10))
    assert stats.max_degrade_level == 3 and stats.rejected > 0
    assert all(r.reason == "shed" for r in stats.results if r.status == "rejected")
    assert stats.completed + stats.failed + stats.rejected == 10
    assert [(frm, to) for _, frm, to, _ in stats.degrade_transitions] == \
        [(0, 1), (1, 2), (2, 3)]


def test_priority_aware_shed_drops_best_effort_tier_first():
    vt = VirtualTime()
    reqs = _reqs(10)
    for r in reqs[:5]:
        r.priority = 0
    for r in reqs[5:]:
        r.priority = 2
    router, stats = _overload(vt, reqs)
    assert stats.max_degrade_level == 3
    shed = [r for r in stats.results if r.status == "rejected"]
    assert shed and all(r.reason == "shed" for r in shed)
    assert {r.request_id for r in shed} <= {0, 1, 2, 3, 4}
    assert {5, 6, 7, 8, 9} <= {r.request_id for r in stats.results if r.status == "completed"}
    assert router.tenant_ledger.stats()["default"]["shed"] == len(shed)


def test_fleet_fairness_off_keeps_fifo_packing():
    vt = VirtualTime()
    reqs = _reqs(6)
    for r in reqs[:3]:
        r.priority = 0
    router = tfleet.FleetRouter([StubEngine(vt) for _ in range(2)],
                                tfleet.FleetConfig(fairness=False),
                                clock=vt.clock, sleep=vt.sleep)
    assert router.serve(reqs).completed == 6
    assert router.tenant_ledger.stats() == {}


def test_fleet_events_flow_to_analysis():
    vt = VirtualTime()
    server = ttracing.TracingServer()
    router = tfleet.FleetRouter([StubEngine(vt) for _ in range(3)], tfleet.FleetConfig(),
                                fault_plan=tfaults.FaultPlan([tfaults.FaultSpec("crash", 1, 1)]),
                                clock=vt.clock, sleep=vt.sleep,
                                tracer=ttracing.Tracer("t-fleet", server))
    stats = router.serve(_reqs(9))
    summary = tanalysis.fleet_summary(server.timeline("t-fleet"))
    assert summary["deaths"] == 1.0 and summary["faults_crash"] == 1.0
    assert summary["completed"] == float(stats.completed)
    assert summary["requeued"] == float(stats.requeued)
    assert summary["goodput"] == 1.0 and summary["recoveries"] == 1.0
    assert summary["rounds"] == float(stats.rounds)
    assert tanalysis.fleet_section(server.timeline("t-fleet")).startswith("metric")
    assert tanalysis.fleet_summary([]) == {} and tanalysis.fleet_section([]) == ""


def test_drain_is_not_a_death_and_requeues_everything():
    vt = VirtualTime()
    router = tfleet.FleetRouter([StubEngine(vt) for _ in range(3)], tfleet.FleetConfig(),
                                clock=vt.clock, sleep=vt.sleep)
    router.drain(1, at_step=1)
    stats = router.serve(_reqs(9))
    assert stats.completed == 9
    assert stats.drains == 1 and stats.deaths == 0
    assert stats.failed == stats.rejected == 0 and stats.requeued > 0


def test_drain_validates_worker_index():
    vt = VirtualTime()
    router = tfleet.FleetRouter([StubEngine(vt)], tfleet.FleetConfig(),
                                clock=vt.clock, sleep=vt.sleep)
    with pytest.raises(ValueError, match="no worker"):
        router.drain(3)


def test_join_adds_a_worker_mid_serve():
    vt = VirtualTime()
    late = StubEngine(vt)
    router = tfleet.FleetRouter([StubEngine(vt)], tfleet.FleetConfig(),
                                clock=vt.clock, sleep=vt.sleep)
    assert router.join(late, at_round=1) == 1
    stats = router.serve(_reqs(10))
    assert stats.completed == 10 and stats.joins == 1 and stats.num_workers == 2
    assert late.calls > 0


def test_drain_then_join_rolls_the_fleet():
    vt = VirtualTime()
    router = tfleet.FleetRouter([StubEngine(vt) for _ in range(2)], tfleet.FleetConfig(),
                                clock=vt.clock, sleep=vt.sleep)
    router.drain(0, at_step=0)
    router.join(StubEngine(vt), at_round=1)
    stats = router.serve(_reqs(8))
    assert stats.completed == 8
    assert stats.drains == 1 and stats.joins == 1 and stats.deaths == 0


# ---------------------------------------------------------------------------
# the same scripted scenarios through both routers
# ---------------------------------------------------------------------------
# name: (workers, fault plan, FleetConfig kwargs, stub kwargs, request count,
#        request gen, drains [(worker, step)], joins [at_round], priorities)
SCENARIOS = {
    "fault-free": (3, "", {}, {}, 9, 6, [], [], None),
    "crash": (3, "crash@1:1", {}, {}, 9, 6, [], [], None),
    "two crashes, one retry": (3, "crash@0:0,crash@1:0", {"max_retries": 1}, {}, 1, 6, [], [],
                               None),
    "all dead": (1, "crash@0:0", {}, {}, 4, 6, [], [], None),
    "stall past the deadline": (1, "stall@0:1:0.7", {"deadline_s": 1.5},
                                {"max_batch": 1, "boundary_s": 0.5}, 5, 4, [], [], None),
    "backoff with jitter": (3, "crash@1:1,crash@2:2", {"backoff_base_s": 0.05,
                                                       "backoff_jitter": 0.5, "seed": 3},
                            {}, 12, 6, [], [], None),
    "pressure": (2, "pressure@0:1:4x2", {}, {}, 6, 6, [], [], None),
    "drain and join": (2, "", {}, {}, 8, 6, [(0, 0)], [1], None),
    "overload shed by tier": (1, "", {}, {}, 10, 6, [], [], [0] * 5 + [2] * 5),
}


def _scripted(pkg, name):
    fleet, faults, eng, analysis, tracing = pkg
    n, plan, cfg_kw, stub_kw, nreq, gen, drains, joins, prios = SCENARIOS[name]
    vt = VirtualTime()
    stub = STUBS[fleet]
    engine_kwargs = ({"num_pages": 7, "num_slots": 1, "page_size": 8}
                     if name.startswith("overload") else {})
    server = tracing.TracingServer()
    router = fleet.FleetRouter([stub(vt, **stub_kw) for _ in range(n)],
                               fleet.FleetConfig(**cfg_kw), engine_kwargs=engine_kwargs,
                               fault_plan=faults.FaultPlan.parse(plan),
                               clock=vt.clock, sleep=vt.sleep,
                               tracer=tracing.Tracer("t", server))
    for w, s in drains:
        router.drain(w, s)
    for rnd in joins:
        router.join(stub(vt, **stub_kw), at_round=rnd)
    reqs = _reqs(nreq, gen=gen, eng=eng)
    for r, p in zip(reqs, prios or []):
        r.priority = p
    stats = router.serve(reqs)
    spans = server.timeline("t")
    return stats, analysis.fleet_summary(spans), analysis.recovery_summary(spans)


COUNTERS = ("num_workers", "wall_s", "rounds", "completed", "failed", "rejected", "deaths",
            "requeued", "hedged", "duplicate_commits", "total_tokens", "throughput_tps",
            "goodput", "recovery_s", "degrade_transitions", "max_degrade_level", "per_worker",
            "migrated", "migrated_tokens", "recomputed_prefill_tokens", "bytes_moved",
            "checkpoints_saved", "checkpoint_bytes", "checksum_failures", "drains", "joins")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scripted_scenarios_match_the_reference_router(name):
    want, jsum, jrec = _scripted(JAX, name)
    got, tsum, trec = _scripted(TORCH, name)
    outcome = lambda r: (r.request_id, r.status, r.worker, r.attempts, r.reason, r.latency_s,
                         r.within_deadline,
                         None if r.tokens is None else np.asarray(r.tokens).tolist())
    assert [outcome(r) for r in got.results] == [outcome(r) for r in want.results]
    for field in COUNTERS:
        assert getattr(got, field) == getattr(want, field), field
    assert tsum == jsum and trec == jrec


# ---------------------------------------------------------------------------
# the port's one difference: a worker's own exception ends serve()
# ---------------------------------------------------------------------------
class FailingEngine(StubEngine):
    """A worker whose serve_paged raises what a failed kernel launch raises."""

    def serve_paged(self, reqs, **kw):
        self.calls += 1
        raise RuntimeError("rmsnorm kernel launch failed with CUDA error 700")


class SlowEngine(StubEngine):
    """A worker that takes a while on the host clock, then finishes."""

    def serve_paged(self, reqs, **kw):
        time.sleep(0.2)
        out = super().serve_paged(reqs, **kw)
        self.finished = True
        return out


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_a_worker_error_ends_serve(parallel):
    """Only a WorkerCrash is a death: any other exception in a worker (a
    CUDA error) ends the run instead of being hedged onto the survivors, and
    in parallel mode the round's other threads end first."""
    vt = VirtualTime()
    slow, failing = SlowEngine(vt), FailingEngine(vt)
    router = tfleet.FleetRouter([slow, failing], tfleet.FleetConfig(parallel=parallel),
                                clock=vt.clock, sleep=vt.sleep)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        router.serve(_reqs(6))
    assert failing.calls == 1
    assert slow.calls == 1 and getattr(slow, "finished", False)


def test_a_straggler_error_ends_serve():
    """A detached straggler that later raises (not a crash) ends the run
    when the router collects it."""
    router = tfleet.FleetRouter([StubEngine(VirtualTime())], tfleet.FleetConfig(parallel=True))
    th = threading.Thread(target=lambda: None)
    th.start()
    router._inflight[0] = {"thread": th, "batch": [], "outcome": None,
                           "error": RuntimeError("CUDA error 719")}
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        router._collect_stragglers(block=True)


# ---------------------------------------------------------------------------
# parallel mode on real engines: a hedged straggler dedupes
# ---------------------------------------------------------------------------
def test_parallel_hedge_duplicates_dedupe():
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM

    cfg = get_config("glm4-9b", reduced=True)
    model = DecoderLM(cfg, device="cpu")
    params = model.init(seed=0)
    engines = [teng.ServingEngine(model, params, max_batch=4, max_seq=64, page_size=8,
                                  device="cpu") for _ in range(3)]
    rng = np.random.default_rng(0)
    gens = [2, 2, 8, 2, 8, 2]     # worker 1 gets one short and one long request
    prompts = [rng.integers(0, cfg.vocab_size, (12,)).astype(np.int32) for _ in gens]
    reqs = lambda: [teng.ServeRequest(request_id=i, prompt=p, max_new_tokens=g)
                    for i, (p, g) in enumerate(zip(prompts, gens))]
    kw = dict(engine_kwargs=dict(num_slots=4, page_size=8))
    base = tfleet.FleetRouter(engines, tfleet.FleetConfig(), **kw).serve(reqs())
    router = tfleet.FleetRouter(
        engines, tfleet.FleetConfig(parallel=True, hedge=True, lease_ttl_s=0.4),
        fault_plan=tfaults.FaultPlan.parse("stall@1:4:1.5"), **kw)
    stats = router.serve(reqs())
    assert stats.completed == len(gens)
    assert stats.hedged > 0 and stats.duplicate_commits >= 1
    for a, b in zip(stats.results, base.results):
        assert np.array_equal(a.tokens, b.tokens)


# ---------------------------------------------------------------------------
# the kernel library's first load, from many threads
# ---------------------------------------------------------------------------
def _race(fn, n=4):
    out, go = [None] * n, threading.Barrier(n)

    def run(i):
        go.wait()
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


def test_library_loads_once_across_threads(monkeypatch):
    calls = []

    def slow_load():
        calls.append(1)
        time.sleep(0.05)
        lib = object()
        monkeypatch.setattr(_build, "_lib", lib)
        return lib

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_load", slow_load)
    got = _race(_build.library)
    assert len(calls) == 1
    assert all(g is got[0] for g in got)


def test_a_cached_library_compiles_nothing(monkeypatch, tmp_path):
    """With the library of these sources already built, threads racing to
    the first call build nothing and load it once."""
    out_dir = tmp_path / _build.source_hash()
    out_dir.mkdir()
    (out_dir / _build.LIB_NAME).write_bytes(b"")
    (out_dir / "build.log").write_text("cached")
    compiles, loads = [], []

    class FakeLib:
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn

    def fake_cdll(path):
        loads.append(path)
        time.sleep(0.05)
        return FakeLib()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_info", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_compile", lambda d: compiles.append(d) or "")
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    got = _race(_build.library)
    assert compiles == [] and len(loads) == 1
    assert all(g is got[0] for g in got)
    info = _build.build_info()
    assert not info.built and info.log == "cached"
    assert all(hasattr(got[0], name) for name in _build.SIGNATURES)
