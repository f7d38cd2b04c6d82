"""The port's fleet against the JAX package's fleet, on the same weights.

Reduced glm4-9b in float32, the port's weights converted from the JAX
model's with ``from_jax``; three workers a fleet in each package, the same
requests, fault plans and drains: fault-free, a crash with migration, the
crash with replay, a drain (with a worker joining), and a corrupted
checkpoint before a crash.  Completed tokens must be equal, and so must
each request's (status, worker, attempts, reason), the ``FleetStats``
counters (``bytes_moved`` and the checkpoint bytes included: the snapshots
hold the same float32 bytes) and the count fields of ``fleet_summary`` and
``recovery_summary``.  Then a migration across the frameworks: a
``PageSnapshot`` the JAX engine checkpointed, rebuilt as the port's from
the same bytes (the checksums must agree), is restored by the port's engine
and decodes on to the tokens of the JAX engine's undisturbed run.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import analysis as janalysis
from repro.core import tracing as jtracing
from repro.models import build_model
from repro.serve import engine as jeng
from repro.serve import faults as jfaults
from repro.serve import fleet as jfleet
from repro_torch.configs import get_config
from repro_torch.core import analysis as tanalysis
from repro_torch.core import tracing as ttracing
from repro_torch.models import DecoderLM, from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve import faults as tfaults
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import page_table as tpt

NUM_SLOTS, PAGE_SIZE, MAX_SEQ = 4, 8, 64
N_REQS, GEN = 8, 8
PROMPT_LENS = [12, 5, 17, 9, 12, 20, 3, 14]

# name: (recovery, checkpoint_every, fault plan, drain (worker, step) or None)
SCENARIOS = {
    "fault-free": ("migrate", 2, "", None),
    "crash, migrate": ("migrate", 1, "crash@1:3", None),
    "crash, replay": ("replay", 0, "crash@1:3", None),
    "drain": ("migrate", 0, "", (1, 2)),
    "corrupt": ("migrate", 3, "corrupt@1:4,crash@1:5", None),
}
# timing fields of the summaries (host clocks differ); every other field is a count
TIMED = {"latency_p90_ms", "recovery_mean_s", "recovery_max_s", "restore_mean_s"}
COUNTERS = ("num_workers", "rounds", "completed", "failed", "rejected", "deaths", "requeued",
            "hedged", "duplicate_commits", "total_tokens", "goodput", "max_degrade_level",
            "migrated", "migrated_tokens", "recomputed_prefill_tokens", "bytes_moved",
            "checkpoints_saved", "checkpoint_bytes", "checksum_failures", "drains", "joins")


@pytest.fixture(scope="module")
def fleets():
    cfg = jax_get_config("glm4-9b", reduced=True)
    jmodel = build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_config("glm4-9b", reduced=True), device="cpu")
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    kw = dict(max_batch=NUM_SLOTS, max_seq=MAX_SEQ, page_size=PAGE_SIZE)
    jax_engines = [jeng.ServingEngine(jmodel, jparams, **kw) for _ in range(4)]
    torch_engines = [teng.ServingEngine(tmodel, tparams, device="cpu", **kw) for _ in range(4)]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in PROMPT_LENS]
    return {"jax": (jfleet, jfaults, jeng, janalysis, jtracing, jax_engines),
            "torch": (tfleet, tfaults, teng, tanalysis, ttracing, torch_engines)}, prompts


def _run(pkg, prompts, name):
    fleet, faults, eng, analysis, tracing, engines = pkg
    recovery, every, plan, drain = SCENARIOS[name]
    server = tracing.TracingServer()
    router = fleet.FleetRouter(
        engines[:3], fleet.FleetConfig(recovery=recovery, checkpoint_every=every),
        engine_kwargs=dict(num_slots=NUM_SLOTS, page_size=PAGE_SIZE, prefix_cache=True),
        fault_plan=faults.FaultPlan.parse(plan), tracer=tracing.Tracer("t", server))
    if drain:
        router.drain(*drain)
        router.join(engines[3], at_round=1)
    stats = router.serve([eng.ServeRequest(request_id=i, prompt=p, max_new_tokens=GEN)
                          for i, p in enumerate(prompts)])
    spans = server.timeline("t")
    return stats, analysis.fleet_summary(spans), analysis.recovery_summary(spans)


def _counts(summary):
    return {k: v for k, v in summary.items() if k not in TIMED}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_fleet_matches_the_jax_fleet(fleets, name):
    pkgs, prompts = fleets
    want, jfs, jrs = _run(pkgs["jax"], prompts, name)
    got, tfs, trs = _run(pkgs["torch"], prompts, name)
    assert got.completed == want.completed == N_REQS
    outcome = lambda r: (r.request_id, r.status, r.worker, r.attempts, r.reason)
    assert [outcome(r) for r in got.results] == [outcome(r) for r in want.results]
    for a, b in zip(got.results, want.results):
        assert np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens)), a.request_id
    for field in COUNTERS:
        assert getattr(got, field) == getattr(want, field), field
    assert [(w["worker"], w["alive"], w["served"], w["deaths"]) for w in got.per_worker] == \
        [(w["worker"], w["alive"], w["served"], w["deaths"]) for w in want.per_worker]
    assert _counts(tfs) == _counts(jfs)
    assert _counts(trs) == _counts(jrs)
    recovery, _, plan, drain = SCENARIOS[name]
    if plan.startswith("crash"):
        assert got.deaths == 1
        assert (got.migrated > 0) == (recovery == "migrate")
        assert (got.recomputed_prefill_tokens > 0) == (recovery == "replay")
    if drain:
        assert got.drains == 1 and got.migrated > 0 and got.joins == 1
    if name == "corrupt":
        assert got.checksum_failures >= 1


def _jax_to_port(snap):
    """The JAX engine's snapshot as the port's: the same bytes in host
    tensors, the same tokens and ledger."""
    tens = lambda a: None if a is None else torch.from_numpy(np.array(a, copy=True))
    return tpt.PageSnapshot(
        request_id=snap.request_id, prompt_len=snap.prompt_len, length=snap.length,
        tokens=np.asarray(snap.tokens, np.int32), k=tens(snap.k), v=tens(snap.v),
        k_scales=tens(snap.k_scales), v_scales=tens(snap.v_scales),
        checksums=list(snap.checksums), step=snap.step, kv_dtype=snap.kv_dtype)


@pytest.mark.parametrize("crash_step", [1, 4])
def test_a_jax_checkpoint_restores_in_the_port(fleets, crash_step):
    pkgs, prompts = fleets
    jengines, tengines = pkgs["jax"][5], pkgs["torch"][5]
    reqs = lambda eng: [eng.ServeRequest(request_id=i, prompt=p, max_new_tokens=GEN)
                        for i, p in enumerate(prompts)]
    undisturbed = jengines[0].serve_paged(reqs(jeng), num_slots=NUM_SLOTS)

    def crash(ctx):
        if ctx.step >= crash_step:
            raise jfaults.WorkerCrash(0, ctx.step)

    store = {}
    with pytest.raises(jfaults.WorkerCrash):
        jengines[1].serve_paged(reqs(jeng), num_slots=NUM_SLOTS, checkpoint_every=1,
                                checkpoints=store, fault_hook=crash)
    assert store
    restores = {}
    for rid, snap in store.items():
        port = _jax_to_port(snap)
        assert tpt.page_checksums(port.k, port.v) == snap.checksums
        assert port.verify() and port.nbytes == snap.nbytes
        restores[rid] = port
    n = len(restores)
    stats = tengines[1].serve_paged(reqs(teng), num_slots=NUM_SLOTS, restores=restores)
    assert stats.restored_requests == n and stats.checksum_failures == 0
    for a, b in zip(stats.results, undisturbed.results):
        assert np.array_equal(a.tokens, np.asarray(b.tokens)), a.request_id
