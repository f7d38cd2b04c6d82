"""Live KV migration in the port: page export/import, snapshots through the
engine, checkpoint/restore in ``serve_paged`` and the recovery matrix.

``ops.export_pages``/``ops.import_pages`` against the JAX ops on float32,
int8 (codes and scales) and bf16 pools; a snapshot the engine checkpoints
verifies, and any flipped byte of it fails only its page; the checkpoint
knobs are validated as the reference validates them; a request restored on
a second engine decodes on to the undisturbed run's tokens, and a restored
slot that is preempted charges no prompt tokens to the ledger; then the
reference's recovery matrix {crash, stall, drain, corrupt} x ``spec_k``
{0, 2} x prefix cache {on, off} x pool {float32, int8} over the port's
reduced glm4-9b fleet, every completed request bit-identical to the
port's fault-free run.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.core.analysis import recovery_section, recovery_summary
from repro_torch.core.tracing import Tracer, TracingServer
from repro_torch.kernels import ops
from repro_torch.models import DecoderLM
from repro_torch.serve.engine import ServeRequest, ServingEngine
from repro_torch.serve.faults import FaultContext, FaultPlan, WorkerCrash
from repro_torch.serve.fleet import FleetConfig, FleetRouter
from repro_torch.serve.page_table import page_checksums

L, P, S, H, D = 2, 6, 4, 2, 3
SRC, DST = [3, 1, 4], [2, 5, 1]


def _pools(mode, rng):
    if mode == "int8":
        kv = [rng.integers(-128, 128, (L, P, S, H, D)).astype(np.int8) for _ in range(2)]
        return kv + [rng.random((L, P, S, H)).astype(np.float32) for _ in range(2)]
    if mode == "bf16":
        return [rng.normal(size=(L, P, S, H, D)).astype(ml_dtypes.bfloat16) for _ in range(2)]
    return [rng.random((L, P, S, H, D)).astype(np.float32) for _ in range(2)]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _raw(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"])
def test_export_import_roundtrip_matches_jax(mode):
    """Export pages out of one pool and import them into another: the same
    bytes as the JAX ops, only the addressed pages written, and the
    destination pools written in place."""
    arrs = _pools(mode, np.random.default_rng(0))
    src = [_torch(a) for a in arrs]
    want = jops.export_pages(*(jnp.asarray(a) for a in arrs[:2]), jnp.asarray(SRC, jnp.int32),
                             *(jnp.asarray(a) for a in arrs[2:]))
    got = ops.export_pages(src[0], src[1], SRC, *src[2:])
    assert len(got) == len(want) == len(arrs)
    for g, w in zip(got, want):
        assert torch.equal(_raw(g), _raw(_torch(np.asarray(w))))
        assert tuple(g.shape) == tuple(w.shape)
    dst = [torch.zeros_like(t) for t in src]
    ptrs = [t.data_ptr() for t in dst]
    ops.import_pages(dst[0], dst[1], DST, got[0], got[1], *dst[2:], *got[2:])
    assert [t.data_ptr() for t in dst] == ptrs
    untouched = [p for p in range(P) if p not in DST]
    for t, s in zip(dst, src):
        assert torch.equal(_raw(t[:, DST]), _raw(s[:, SRC]))
        assert not _raw(t[:, untouched]).any()
    jdst = jops.import_pages(*(jnp.zeros_like(jnp.asarray(a)) for a in arrs[:2]),
                             jnp.asarray(DST, jnp.int32), want[0], want[1],
                             *(jnp.zeros_like(jnp.asarray(a)) for a in arrs[2:]), *want[2:])
    for t, j in zip(dst, jdst):
        assert torch.equal(_raw(t), _raw(_torch(np.asarray(j))))


# ---------------------------------------------------------------------------
# the engine: knobs, snapshots, restore, the ledger
# ---------------------------------------------------------------------------
NUM_SLOTS, PAGE_SIZE, MAX_SEQ = 4, 8, 64
N_REQS, PROMPT_LEN, GEN = 6, 12, 8


@pytest.fixture(scope="module", params=["float32", "int8"], ids=["f32", "int8"])
def fleet_engines(request):
    cfg = get_config("glm4-9b", reduced=True)
    model = DecoderLM(cfg, device="cpu")
    params = model.init(seed=0)
    kv_dtype = None if request.param == "float32" else request.param
    # 3 fleet workers + 1 spare for the join of the drain scenario
    engines = [ServingEngine(model, params, max_batch=NUM_SLOTS, max_seq=MAX_SEQ,
                             page_size=PAGE_SIZE, device="cpu", kv_dtype=kv_dtype)
               for _ in range(4)]
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, (PROMPT_LEN - 8,))
                               .astype(np.int32)]) for _ in range(N_REQS)]
    return request.param, engines, prompts


def _requests(prompts, gen=GEN):
    return [ServeRequest(request_id=i, prompt=p, max_new_tokens=gen)
            for i, p in enumerate(prompts)]


def test_checkpoint_knob_validation(fleet_engines):
    _, engines, prompts = fleet_engines
    with pytest.raises(ValueError, match="checkpoint_every must be >= 0"):
        engines[0].serve_paged([], checkpoint_every=-1)
    with pytest.raises(ValueError, match="needs a checkpoints dict"):
        engines[0].serve_paged([], checkpoint_every=2)
    with pytest.raises(ValueError, match="needs a checkpoints dict"):
        engines[0].serve_paged(_requests(prompts[:1]), checkpoint_every=1)


def _crash_at(step):
    def hook(ctx):
        if ctx.step >= step:
            raise WorkerCrash(0, ctx.step)
    return hook


def _checkpointed(engine, prompts, step, every=1):
    """Serve ``prompts`` with a checkpoint every ``every`` steps and a crash
    at ``step``: the snapshots and the crash."""
    store = {}
    with pytest.raises(WorkerCrash) as e:
        engine.serve_paged(_requests(prompts), num_slots=NUM_SLOTS, checkpoint_every=every,
                           checkpoints=store, fault_hook=_crash_at(step))
    return store, e.value


def test_engine_snapshots_verify_and_catch_any_flip(fleet_engines):
    dtype, engines, prompts = fleet_engines
    store, crash = _checkpointed(engines[0], prompts, 3)
    # the slots decoding at step 3 (the rest still queued), none finished
    assert sorted(store) == list(range(NUM_SLOTS))
    assert crash.results == []
    assert [r.request_id for r in crash.pending] == list(range(N_REQS))
    for snap in store.values():
        assert snap.verify() and snap.step == 3 and snap.kv_dtype == dtype
        assert snap.length == PROMPT_LEN + len(snap.tokens) - 1
        assert snap.num_pages == -(-snap.length // PAGE_SIZE)
        assert snap.k.device.type == "cpu" and snap.k.dtype == (
            torch.float32 if dtype == "float32" else torch.int8)
        assert (snap.k_scales is None) == (dtype == "float32")
    snap = store[0]
    tensors = [snap.k, snap.v] + ([snap.k_scales, snap.v_scales] if snap.k_scales is not None
                                  else [])
    for i in range(len(tensors)):
        for page in range(snap.num_pages):
            bad = [t.clone() for t in tensors]
            flat = bad[i].view(torch.uint8).reshape(bad[i].shape[0], snap.num_pages, -1)
            flat[1, page, 5] ^= 0x40
            sums = page_checksums(*bad[:2], *(bad[2:] or [None, None]))
            assert [a != b for a, b in zip(sums, snap.checksums)] == [
                p == page for p in range(snap.num_pages)]


def test_restore_continues_the_undisturbed_run(fleet_engines):
    """Snapshots from engine 0's crashed run, restored on engine 1, decode
    on to the tokens of an undisturbed run; restored requests prefill
    nothing, and their prompts never enter engine 1's ledger."""
    _, engines, prompts = fleet_engines
    base = engines[2].serve_paged(_requests(prompts), num_slots=NUM_SLOTS)
    store, _ = _checkpointed(engines[0], prompts, 3)
    lengths = sum(s.length for s in store.values())
    nbytes = sum(s.nbytes for s in store.values())
    server = TracingServer()
    stats = engines[1].serve_paged(_requests(prompts), num_slots=NUM_SLOTS, restores=store,
                                   tracer=Tracer("t-restore", server))
    assert store == {}                 # every snapshot consumed
    for a, b in zip(stats.results, base.results):
        assert np.array_equal(a.tokens, b.tokens)
    queued = N_REQS - NUM_SLOTS        # had no snapshot: prefilled from the prompt
    assert stats.restored_requests == NUM_SLOTS and stats.checksum_failures == 0
    assert stats.prompt_tokens_admitted == stats.prefill_tokens == queued * PROMPT_LEN
    assert (stats.restored_tokens, stats.restore_bytes) == (lengths, nbytes)
    summary = recovery_summary(server.timeline("t-restore"))
    assert summary["migrated"] == NUM_SLOTS and summary["bytes_moved"] == nbytes
    assert recovery_section(server.timeline("t-restore"))


def test_a_restored_slot_preempted_charges_no_prompt_tokens(fleet_engines):
    """The ``restored_slots`` exclusion: an overcommitted pool preempts a
    restored request, which requeues and prefills from its prompt; the
    prompt-token ledger still balances, and the tokens equal the
    undisturbed run's."""
    _, engines, prompts = fleet_engines
    reqs = lambda: _requests(prompts[:3], gen=24)
    base = engines[2].serve_paged(reqs(), num_slots=3)
    store = {}
    with pytest.raises(WorkerCrash):
        engines[0].serve_paged(reqs(), num_slots=3, checkpoint_every=1, checkpoints=store,
                               fault_hook=_crash_at(2))
    restores = {rid: store[rid] for rid in (0, 1)}
    stats = engines[1].serve_paged(reqs(), num_slots=3, num_pages=8, overcommit=10.0,
                                   restores=restores)
    assert stats.restored_requests == 2 and stats.preemptions > 0
    assert stats.prompt_tokens_admitted == (stats.prefill_tokens + stats.saved_prefill_tokens
                                            + stats.prefill_tokens_dropped)
    for a, b in zip(stats.results, base.results):
        assert np.array_equal(a.tokens, b.tokens)


def test_a_corrupted_restore_replays_from_the_prompt(fleet_engines):
    _, engines, prompts = fleet_engines
    base = engines[2].serve_paged(_requests(prompts), num_slots=NUM_SLOTS)
    store, _ = _checkpointed(engines[0], prompts, 2)
    store[3].corrupt(page=1)
    stats = engines[1].serve_paged(_requests(prompts), num_slots=NUM_SLOTS, restores=store)
    assert stats.checksum_failures == 1 and stats.restored_requests == NUM_SLOTS - 1
    replayed = N_REQS - NUM_SLOTS + 1
    assert stats.prompt_tokens_admitted == stats.prefill_tokens == replayed * PROMPT_LEN
    for a, b in zip(stats.results, base.results):
        assert np.array_equal(a.tokens, b.tokens)


def test_drain_hook_snapshots_every_decoding_slot(fleet_engines):
    from repro_torch.serve.faults import WorkerDrain

    _, engines, prompts = fleet_engines

    def drain(ctx):
        if ctx.step >= 2:
            raise WorkerDrain(0, ctx.step)

    store = {}
    with pytest.raises(WorkerDrain):
        engines[0].serve_paged(_requests(prompts), num_slots=NUM_SLOTS, checkpoints=store,
                               fault_hook=drain)
    assert sorted(store) == list(range(NUM_SLOTS))   # the slots decoding at step 2
    assert all(s.step == 2 and s.verify() for s in store.values())


def test_fault_context_carries_the_run(fleet_engines):
    _, engines, prompts = fleet_engines
    seen = []

    def hook(ctx):
        assert isinstance(ctx, FaultContext)
        seen.append((ctx.step, ctx.pool.capacity, ctx.checkpoints is store))

    hook.release = lambda: seen.append("released") or 0
    store = {}
    engines[0].serve_paged(_requests(prompts[:2]), num_slots=NUM_SLOTS, checkpoint_every=3,
                           checkpoints=store, fault_hook=hook)
    assert seen[-1] == "released"
    assert [s for s, _, _ in seen[:-1]] == sorted(s for s, _, _ in seen[:-1])
    assert all(same for _, _, same in seen[:-1]) and sorted(store) == [0, 1]


# ---------------------------------------------------------------------------
# the recovery matrix over the port's fleet
# ---------------------------------------------------------------------------
# every scenario runs recovery="migrate"; the corrupt cell needs a cadence
# GAP between the corruption and the crash (a refresh in between would heal
# the snapshot)
SCENARIOS = {
    "crash": dict(plan="crash@1:2", checkpoint_every=1),
    "stall": dict(plan="stall@1:1:0.02", checkpoint_every=1),
    "drain": dict(plan="", checkpoint_every=0, drain=(1, 2)),
    "corrupt": dict(plan="corrupt@1:4,crash@1:5", checkpoint_every=3),
}
_oracles = {}


def _fleet(engines, prompts, plan, spec_k, prefix, tracer=None, **cfg_kw):
    router = FleetRouter(
        engines[:3], FleetConfig(recovery="migrate", **cfg_kw),
        engine_kwargs=dict(num_slots=NUM_SLOTS, page_size=PAGE_SIZE, spec_k=spec_k,
                           prefix_cache=prefix),
        fault_plan=FaultPlan.parse(plan) if plan else None, tracer=tracer)
    return router, _requests(prompts)


def _oracle(fleet_engines, spec_k, prefix):
    dtype, engines, prompts = fleet_engines
    key = (dtype, spec_k, prefix)
    if key not in _oracles:
        router, reqs = _fleet(engines, prompts, "", spec_k, prefix)
        base = router.serve(reqs)
        assert base.completed == N_REQS
        _oracles[key] = {r.request_id: r.tokens for r in base.results}
    return _oracles[key]


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "noprefix"])
@pytest.mark.parametrize("spec_k", [0, 2], ids=["spec0", "spec2"])
@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_recovery_matrix_bit_identity(fleet_engines, kind, spec_k, prefix):
    dtype, engines, prompts = fleet_engines
    oracle = _oracle(fleet_engines, spec_k, prefix)
    sc = SCENARIOS[kind]
    server = TracingServer()
    router, reqs = _fleet(engines, prompts, sc["plan"], spec_k, prefix,
                          tracer=Tracer("t", server), checkpoint_every=sc["checkpoint_every"])
    if "drain" in sc:
        router.drain(*sc["drain"])
        router.join(engines[3], at_round=1)
    stats = router.serve(reqs)
    label = f"{kind}/{dtype}/spec{spec_k}/prefix={prefix}"
    assert stats.completed == N_REQS, (
        f"{label}: {[(r.request_id, r.status, r.reason) for r in stats.results]}")
    for r in stats.results:
        assert np.array_equal(r.tokens, oracle[r.request_id]), f"{label}: request {r.request_id}"
    if kind == "crash":
        assert stats.deaths == 1 and stats.migrated > 0 and stats.bytes_moved > 0, label
        assert stats.recomputed_prefill_tokens == 0 and stats.checksum_failures == 0, label
        assert stats.migrated_tokens > 0
    elif kind == "stall":
        assert stats.deaths == 0 and stats.migrated == 0, label
        assert stats.checkpoints_saved > 0 and stats.checksum_failures == 0, label
    elif kind == "drain":
        assert stats.drains == 1 and stats.deaths == 0, label
        assert stats.joins == 1 and stats.num_workers == 4, label
        assert stats.migrated > 0 and stats.recomputed_prefill_tokens == 0, label
    else:
        assert stats.deaths == 1 and stats.checksum_failures >= 1, label
        # nothing it rejected was restored: those requests replayed
        of = lambda name: {s.tags["request"] for s in server.timeline("t") if s.name == name}
        assert of("migrate:checksum_fail") and not (
            of("migrate:checksum_fail") & of("migrate:restore")), label


def test_recovery_events_flow_to_analysis(fleet_engines):
    dtype, engines, prompts = fleet_engines
    server = TracingServer()
    router, reqs = _fleet(engines, prompts, "crash@1:2", 0, False,
                          tracer=Tracer("t-recovery", server), checkpoint_every=1)
    stats = router.serve(reqs)
    assert stats.migrated > 0
    summary = recovery_summary(server.timeline("t-recovery"))
    # the dead worker's counters are lost with its raised serve, its
    # ckpt:save events are not: traced >= folded
    assert summary["checkpoints_saved"] >= float(stats.checkpoints_saved) > 0
    assert summary["checkpoint_bytes"] >= float(stats.checkpoint_bytes) > 0
    assert summary["migrated"] == float(stats.migrated)
    assert summary["migrated_tokens"] == float(stats.migrated_tokens)
    assert summary["bytes_moved"] == float(stats.bytes_moved)
    assert summary["recomputed_prefill_tokens"] == float(stats.recomputed_prefill_tokens)
    assert summary["checksum_failures"] == 0.0
    assert summary["migrated_token_fraction"] == 1.0
    assert summary["restore_mean_s"] >= 0.0
    assert recovery_summary([]) == {}
