"""Tenants, priorities, fair share, token buckets and deadlines in the port's
``serve_paged`` against the JAX engine.

Both engines serve the same requests on the same weights (reduced glm4-9b)
under one injected clock: a tick clock that advances 10 ms at every read,
so admission decisions, deadlines, the decode-rate estimate behind SLO
shedding and every latency are the same numbers in both packages when the
port reads the clock where the reference does.  Per request the status,
reason, tenant, priority, within-deadline flag, admission and finish steps
and tokens must be equal; per run the completed, rejected and deferred
counts, goodput, preemptions, the ``sched:tenant``/``sched:defer`` events
and ``slo_summary``.  The scenarios mirror the scheduler cases of
``tests/test_slo_serving.py`` (FIFO when untagged, priority tiers, weighted
fair share, a noisy neighbour's token bucket, SLO shedding) and the
deadline cases of ``tests/test_scheduler.py``, on the engine.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import analysis as janalysis
from repro.core import tracing as jtracing
from repro.models import build_model
from repro.serve import engine as jeng
from repro.serve import scheduler as jsch
from repro_torch.configs import get_config
from repro_torch.core import analysis as tanalysis
from repro_torch.core import tracing as ttracing
from repro_torch.models import DecoderLM, from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsch

PKGS = ((jeng, jsch, jtracing, janalysis), (teng, tsch, ttracing, tanalysis))


class Tick:
    """A clock that advances ``dt`` seconds at every read."""

    def __init__(self, dt=0.01):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, (jeng.ServingEngine(jmodel, jparams, max_batch=2, max_seq=32),
                 teng.ServingEngine(tmodel, tparams, max_batch=2, max_seq=32, device="cpu"))


def _requests(mod, cfg, tags, seed=0, max_new=4):
    """One request per ``(tenant, priority, slo_ms)`` tag, prompts of 5-9
    tokens from ``seed``."""
    rng = np.random.default_rng(seed)
    return [mod.ServeRequest(request_id=i,
                             prompt=rng.integers(0, cfg.vocab_size,
                                                 (int(rng.integers(5, 10)),)).astype(np.int32),
                             max_new_tokens=max_new, tenant=t, priority=p, slo_ms=slo)
            for i, (t, p, slo) in enumerate(tags)]


def _serve(engines, tags, tenants=(), seed=0, **kw):
    """The same run in both packages; returns ((stats, spans), ...) JAX first."""
    cfg, pair = engines
    out = []
    for (mod, sch, tr, _), engine in zip(PKGS, pair):
        server = tr.TracingServer()
        clock = Tick()
        specs = [sch.TenantSpec(**t) for t in tenants] or None
        stats = engine.serve_paged(_requests(mod, cfg, tags, seed), page_size=4,
                                   clock=clock, tracer=tr.Tracer("t", server, clock=clock),
                                   tenants=specs, **kw)
        out.append((stats, server.timeline("t")))
    return out


FIELDS = ("request_id", "status", "reason", "tenant", "priority", "within_deadline",
          "admit_step", "finish_step", "slot", "ttft_s", "latency_s")
EVENTS = ("sched:tenant", "sched:defer")


def _same(runs):
    (jstats, jspans), (tstats, tspans) = runs
    for rj, rt in zip(jstats.results, tstats.results):
        for f in FIELDS:
            assert getattr(rt, f) == getattr(rj, f), (rt.request_id, f)
        assert rt.tokens.tolist() == rj.tokens.tolist()
    for f in ("completed", "rejected", "deferred", "goodput", "preemptions", "steps",
              "deadline_ms", "total_tokens"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    pick = lambda spans: [(s.name, s.begin, s.end, s.tags) for s in spans if s.name in EVENTS]
    assert pick(tspans) == pick(jspans)
    summary = tanalysis.slo_summary(tspans)
    assert summary == janalysis.slo_summary(jspans)
    return tstats, summary


def _admission_order(stats):
    return [r.request_id for r in sorted(stats.results, key=lambda r: (r.admit_step, r.slot))]


@pytest.mark.parametrize("fairness", [True, False])
def test_untagged_requests_are_fifo(engines, fairness):
    stats, summary = _same(_serve(engines, [("default", 1, 0.0)] * 5, num_slots=1,
                                  fairness=fairness))
    assert _admission_order(stats) == list(range(5))
    assert stats.completed == 5 and stats.rejected == 0 and stats.goodput == 1.0
    assert summary["requests"] == 5.0 and summary["tenants"] == 1.0


def test_priority_tiers_admit_premium_first(engines):
    tenants = [dict(name="be", priority=0), dict(name="std", priority=1),
               dict(name="prem", priority=2)]
    tags = [("be", 0, 0.0), ("be", 0, 0.0), ("std", 1, 0.0), ("prem", 2, 0.0),
            ("std", 1, 0.0), ("prem", 2, 0.0)]
    stats, _ = _same(_serve(engines, tags, tenants, num_slots=1))
    order = _admission_order(stats)
    assert order[:2] == [3, 5] and set(order[2:4]) == {2, 4} and order[4:] == [0, 1]


def test_fairness_off_keeps_fifo_with_tenants(engines):
    tenants = [dict(name="be", priority=0), dict(name="prem", priority=2)]
    tags = [("be", 0, 0.0), ("prem", 2, 0.0), ("be", 0, 0.0), ("prem", 2, 0.0)]
    stats, _ = _same(_serve(engines, tags, tenants, num_slots=1, fairness=False))
    assert _admission_order(stats) == [0, 1, 2, 3]


def test_weighted_fair_share(engines):
    tenants = [dict(name="a", weight=2.0), dict(name="b")]
    tags = [("a", 1, 0.0)] * 4 + [("b", 1, 0.0)] * 2
    stats, _ = _same(_serve(engines, tags, tenants, num_slots=1))
    by_id = {r.request_id: r.tenant for r in stats.results}
    served = [by_id[i] for i in _admission_order(stats)]
    assert served.count("a") == 4 and served[:3].count("a") == 2


def test_token_bucket_contains_a_noisy_neighbour(engines):
    tenants = [dict(name="noisy", rate_tokens_per_s=10.0, burst_tokens=14.0),
               dict(name="victim")]
    tags = [("noisy", 1, 0.0)] * 3 + [("victim", 1, 0.0)] * 2
    stats, summary = _same(_serve(engines, tags, tenants, num_slots=1))
    by_id = {r.request_id: r.tenant for r in stats.results}
    served = [by_id[i] for i in _admission_order(stats)]
    assert served[0] == "noisy" and served[1:3] == ["victim", "victim"]
    assert served.count("noisy") == 3          # work-conserving: never starved
    assert stats.deferred > 0 and summary["deferred"] == float(stats.deferred)


def test_deadline_rejects_queued_work(engines):
    """A 30 ms TTL passes while five requests still queue behind the first:
    they are rejected for the deadline (never dropped silently), and the
    first completes late, out of goodput."""
    stats, summary = _same(_serve(engines, [("default", 1, 0.0)] * 6, num_slots=1,
                                  deadline_ms=30.0))
    assert [r.reason for r in stats.results] == [""] + ["deadline"] * 5
    assert stats.completed == 1 and stats.rejected == 5 and stats.goodput == 0.0
    assert not stats.results[0].within_deadline
    assert summary["rejected"] == 5.0 and summary["goodput_slo"] == 0.0
    assert all(len(r.tokens) == 0 and r.slot == -1 for r in stats.results[1:])


@pytest.mark.parametrize("slots,deadline_ms", [(1, 500.0), (2, 400.0)])
def test_slo_unmeetable_sheds_after_the_rate_is_measured(engines, slots, deadline_ms):
    """Once decode steps have measured the rate, admission sheds queued
    requests whose optimistic finish lands past the deadline; a request
    that finishes after it stays completed but leaves goodput."""
    stats, _ = _same(_serve(engines, [("default", 1, 0.0)] * 6, num_slots=slots,
                            deadline_ms=deadline_ms, prefill_budget=8))
    assert any(r.reason == "slo-unmeetable" for r in stats.results)
    assert any(r.status == "completed" and not r.within_deadline for r in stats.results)
    assert stats.completed + stats.rejected == 6
    assert stats.goodput == sum(r.within_deadline for r in stats.results) / 6 < 1.0


def test_per_request_slo_counts_in_the_summary(engines):
    tags = [("a", 1, 400.0), ("a", 1, 400.0), ("b", 1, 5000.0), ("b", 1, 5000.0)]
    stats, summary = _same(_serve(engines, tags, num_slots=1))
    assert stats.completed == 4 and stats.goodput == 1.0   # no deadline: all in goodput
    assert summary["goodput_slo"] < 1.0                    # a's SLO is missed
    assert summary["b_completed"] == 2.0


def test_preemption_takes_the_lowest_tier_first(engines):
    """Overcommit on a cut pool: the best-effort request is preempted before
    the premium ones, as in JAX."""
    tenants = [dict(name="be", priority=0), dict(name="prem", priority=2)]
    tags = [("prem", 2, 0.0), ("be", 0, 0.0), ("prem", 2, 0.0)]
    runs = _serve(engines, tags, tenants, seed=3, num_slots=2, num_pages=6, overcommit=10.0,
                  prefill_budget=8)
    stats, _ = _same(runs)
    assert stats.preemptions > 0 and stats.completed == 3
