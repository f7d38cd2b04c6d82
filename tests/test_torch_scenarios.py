"""The port's scenarios and request scheduler against ``repro.core.scenarios``
and ``repro.serve.scheduler``.

Every scenario kind runs in both packages under a fake clock, with a
predict that advances that clock by a fixed cost per batch: the metrics
(scheduler stats included) and the trace the scenario publishes must be
equal key for key and span for span.  Both sides compute the same floats
from the same float operations, so the tolerance is zero (the dicts are
compared through ``json.dumps``, which also equates NaN with NaN).  The
synchronous drive must form the same batches, in the same order, at the
same times, with the same terminal statuses.
"""
import json

import numpy as np
import pytest

from repro.core import scenarios as rscen
from repro.core import tracing as rtracing
from repro.serve import scheduler as rsched
from repro_torch.core import scenarios as tscen
from repro_torch.core import tracing as ttracing
from repro_torch.serve import scheduler as tsched

PKGS = [(rscen, rtracing, rsched), (tscen, ttracing, tsched)]


class VirtualTime:
    """A deterministic clock + sleep pair."""

    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _cost(bs):
    return 0.004 + 0.0015 * bs


def _run(pkg, spec_kw, sched_kw=None, fail_every=0, level="FULL"):
    """One scenario on a fake clock; returns (metrics, spans as dicts)."""
    scen, tracing, sched = pkg
    vt = VirtualTime()
    server = tracing.TracingServer()
    tracer = tracing.Tracer("t", server, tracing.TraceLevel.parse(level), clock=vt.clock)
    calls = [0]

    def predict(bs):
        calls[0] += 1
        vt.t += _cost(bs)
        if fail_every and calls[0] % fail_every == 0:
            raise RuntimeError(f"injected failure on call {calls[0]}")

    cfg = sched.SchedulerConfig(**sched_kw) if sched_kw is not None else None
    metrics = scen.run_scenario(scen.ScenarioSpec(**spec_kw), predict, tracer, clock=vt.clock,
                                sleep=vt.sleep, scheduler=cfg)
    spans = [(s.name, int(s.level), s.begin, s.end, s.tags) for s in server.timeline("t")]
    return metrics, spans


TENANTS = [
    {"name": "chat", "priority": 2, "weight": 2.0, "rate_tokens_per_s": 4000.0,
     "burst_tokens": 600.0, "slo_ms": 60.0, "prompt_len": 64, "gen_tokens": 16},
    {"name": "batch", "priority": 0, "weight": 1.0, "rate_tokens_per_s": 2000.0,
     "prompt_len": 512, "gen_tokens": 128, "rate_hz": 40.0},
    {"name": "std", "priority": 1, "slo_ms": 30.0},
]

CASES = [
    ("online", dict(kind="online", num_requests=12, rate_hz=80.0, warmup=2, seed=1), None, 0),
    ("online-sched", dict(kind="online", num_requests=8, rate_hz=500.0, warmup=0),
     dict(max_batch=4, batch_timeout_ms=5.0), 0),
    ("batched", dict(kind="batched", num_requests=3, batch_sizes=[1, 2, 4, 8], warmup=1),
     None, 0),
    ("trace", dict(kind="trace", arrivals=[0.0, 0.001, 0.5, 0.502, 0.9], batch_size=2,
                   warmup=1), None, 0),
    ("trace-prefix", dict(kind="trace", arrivals=[0.0, 0.01, 0.02, 0.4], prefix_len=32,
                          prefix_share=0.5, prefix_groups=2, suffix_len=4, seed=3, warmup=0),
     None, 0),
    ("single_stream", dict(kind="single_stream", num_requests=9, warmup=2), None, 0),
    ("server", dict(kind="server", num_requests=40, rate_hz=1200.0, warmup=1, slo_ms=20.0,
                    seed=2), None, 0),
    ("server-sched", dict(kind="server", num_requests=32, rate_hz=120.0, warmup=1,
                          slo_ms=250.0), dict(max_batch=4, batch_timeout_ms=2.0), 0),
    ("server-fifo", dict(kind="server", num_requests=30, rate_hz=1200.0, warmup=0, slo_ms=15.0,
                         fairness=False), None, 0),
    ("server-tenants", dict(kind="server", num_requests=36, rate_hz=1000.0, warmup=1,
                            slo_ms=50.0, tenants=TENANTS, seed=4), None, 0),
    ("server-priority-mix", dict(kind="server", num_requests=30, rate_hz=1200.0, warmup=0,
                                 slo_ms=20.0, seed=5,
                                 priority_mix={"best_effort": 0.25, "standard": 0.5,
                                               "premium": 0.25}), None, 0),
    ("server-prefix", dict(kind="server", num_requests=24, rate_hz=150.0, warmup=1,
                           prefix_len=64, prefix_share=0.75, prefix_groups=3, suffix_len=8,
                           seed=6), None, 0),
    ("server-deadline", dict(kind="server", num_requests=24, rate_hz=500.0, warmup=0,
                             slo_ms=1000.0), dict(max_batch=2, deadline_ms=15.0,
                                                  slo_shed=False), 0),
    ("offline", dict(kind="offline", num_requests=20, warmup=1), None, 0),
    ("offline-sched", dict(kind="offline", num_requests=19, batch_size=2, warmup=1),
     dict(max_batch=4, batch_timeout_ms=0.0), 0),
    ("offline-retries", dict(kind="offline", num_requests=16, warmup=0),
     dict(max_batch=4, batch_timeout_ms=0.0, max_retries=2, backoff_base_ms=5.0,
          backoff_cap_ms=20.0, backoff_jitter=0.5, retry_seed=9), 3),
]


@pytest.mark.parametrize("name,spec_kw,sched_kw,fail_every", CASES, ids=[c[0] for c in CASES])
def test_run_scenario_matches_the_reference(name, spec_kw, sched_kw, fail_every):
    ref_m, ref_spans = _run(PKGS[0], spec_kw, sched_kw, fail_every)
    port_m, port_spans = _run(PKGS[1], spec_kw, sched_kw, fail_every)
    assert ref_m["scenario"] == spec_kw["kind"]
    assert sorted(port_m) == sorted(ref_m)
    assert json.dumps(port_m, sort_keys=True) == json.dumps(ref_m, sort_keys=True)
    assert json.dumps(port_spans) == json.dumps(ref_spans)


def test_cases_exercise_the_policy():
    """The cases above reach shedding, tenants, deadlines and retries, so
    their equality covers those paths."""
    for i in (6, 8):     # overloaded: a plain request carries no SLO, so none is shed
        late = _run(PKGS[1], CASES[i][1])[0]
        assert late["slo_attainment"] < 0.5 and late["sched_max_queue_depth"] > 4
    shed = _run(PKGS[1], CASES[10][1])[0]
    assert shed["sched_shed"] > 0 and shed["rejected"] == shed["sched_shed"]
    tenants = _run(PKGS[1], CASES[9][1])[0]
    assert set(tenants["tenant_stats"]) == {"chat", "batch", "std"}
    assert tenants["sched_deferred"] > 0 and tenants["rejected"] > 0
    assert 0.0 < tenants["jain_index"] < 1.0
    assert _run(PKGS[1], CASES[12][1], CASES[12][2])[0]["sched_deadline_failures"] > 0
    retried = _run(PKGS[1], CASES[15][1], CASES[15][2], CASES[15][3])[0]
    assert retried["sched_retries"] > 0


def _drive(sched_mod, seed, fairness, slo_shed, max_batch):
    """Pre-submitted random arrivals from several tenants through the
    synchronous drive; returns each batch's (request ids, start, end) and
    each request's terminal status and times."""
    rng = np.random.default_rng(seed)
    vt = VirtualTime()
    batches = []

    def execute(batch):
        vt.t += _cost(sum(r.batch_size for r in batch))
        batches.append(([r.request_id for r in batch], vt.t))
        return [r.request_id * 10 for r in batch]

    tenants = [sched_mod.TenantSpec(name="a", priority=2, weight=3.0, rate_tokens_per_s=900.0,
                                    burst_tokens=200.0, slo_ms=40.0),
               sched_mod.TenantSpec(name="b", priority=1, rate_tokens_per_s=300.0),
               sched_mod.TenantSpec(name="c", priority=0, weight=0.5, slo_ms=25.0)]
    cfg = sched_mod.SchedulerConfig(max_batch=max_batch, batch_timeout_ms=3.0,
                                    fairness=fairness, slo_shed=slo_shed)
    s = sched_mod.RequestScheduler(execute, cfg, clock=vt.clock, sleep=vt.sleep,
                                   tenants=tenants)
    t = 0.0
    futs = []
    for _ in range(60):
        t += float(rng.exponential(1 / 250.0))
        futs.append(s.submit(batch_size=int(rng.integers(1, 4)), arrival_s=t,
                             tenant=str(rng.choice(["a", "b", "c", "d"])),
                             cost_tokens=float(rng.integers(10, 200))))
    served = s.run_until_idle()
    reqs = [(f.request.request_id, f.request.status, f.request.start_s, f.request.end_s,
             f.request.tenant, f.request.priority) for f in futs]
    return served, batches, reqs, s.stats(), s.ledger.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fairness,slo_shed,max_batch", [(True, True, 4), (True, False, 3),
                                                         (False, True, 8)])
def test_sync_drive_forms_the_reference_batches(seed, fairness, slo_shed, max_batch):
    ref = _drive(rsched, seed, fairness, slo_shed, max_batch)
    port = _drive(tsched, seed, fairness, slo_shed, max_batch)
    assert ref[0] > 0 and len(ref[1]) > 1
    assert port == ref


def test_closed_loop_future_drives_the_scheduler():
    """``result()`` on a scheduler that is not running drives it until that
    request completes, as the reference's closed-loop scenarios rely on."""
    for mod in (rsched, tsched):
        vt = VirtualTime()
        s = mod.RequestScheduler(lambda b: vt.sleep(0.01) or [r.payload for r in b],
                                 mod.SchedulerConfig(max_batch=2, batch_timeout_ms=0.0),
                                 clock=vt.clock, sleep=vt.sleep)
        futs = [s.submit(payload=i, arrival_s=0.005 * i) for i in range(5)]
        assert futs[2].result() == 2 and s.pending == 2
        assert [f.result() for f in futs] == list(range(5))
        assert [f.request.end_s for f in futs] == pytest.approx([0.01, 0.02, 0.02, 0.03, 0.03])


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_config_dicts_round_trip_between_packages(direction):
    src, dst = (PKGS[0], PKGS[1]) if direction == "ref-to-port" else (PKGS[1], PKGS[0])
    cfg = src[2].SchedulerConfig(max_batch=3, batch_timeout_ms=1.5, queue_depth=64, num_slots=4,
                                 page_size=8, spec_k=2, prefix_cache=True, deadline_ms=40.0,
                                 max_retries=1, backoff_jitter=0.25, retry_seed=3,
                                 fairness=False, slo_shed=False)
    assert len(cfg.to_dict()) == 19
    assert dst[2].SchedulerConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
    spec = src[0].ScenarioSpec(kind="server", num_requests=7, rate_hz=12.5, warmup=1,
                               batch_sizes=[1, 4], arrivals=[0.1], seed=3, slo_ms=80.0,
                               prefix_len=16, tenants=[dict(TENANTS[0])],
                               priority_mix={"premium": 1.0}, fairness=False)
    assert dst[0].ScenarioSpec.from_dict(spec.to_dict()).to_dict() == spec.to_dict()
    tenant = src[2].TenantSpec(name="x", priority=2, weight=1.5, rate_tokens_per_s=10.0)
    assert dst[2].TenantSpec.from_dict(tenant.to_dict()).to_dict() == tenant.to_dict()


def test_registry_of_kinds_and_errors():
    assert tscen.scenario_kinds() == rscen.scenario_kinds()
    assert set(tscen.scenario_kinds()) >= {"online", "batched", "trace", "single_stream",
                                           "server", "offline"}
    with pytest.raises(ValueError, match="unknown scenario kind"):
        tscen.run_scenario(tscen.ScenarioSpec(kind="bogus"), lambda b: None,
                           ttracing.NullTracer())
    with pytest.raises(ValueError, match="arrivals"):
        tscen.run_scenario(tscen.ScenarioSpec(kind="trace"), lambda b: None,
                           ttracing.NullTracer())
    assert tsched.backoff_delay(3, 0.01, 1.0) == rsched.backoff_delay(3, 0.01, 1.0) == 0.04
