"""The port's fault plan, page checksums and snapshots against the JAX package.

``repro_torch.serve.faults`` and the snapshot half of
``repro_torch.serve.page_table`` are copies of the reference's pure-Python
modules.  The reference's unit tests of the fault plan, the boundary hook
and the corrupt fault run here on both packages; the port's plan must
describe and serialize to the reference's for the same text and seed, and
its CRC32 ledger must equal the reference's on the same bytes, float32,
int8, bf16 and fp8 (bf16 and fp8 have no numpy dtype in torch: the port
hashes a ``uint8`` view, the reference the ``ml_dtypes`` array's bytes).
"""
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serve import faults as jfaults
from repro.serve import page_table as jpt
from repro_torch.serve import faults as tfaults
from repro_torch.serve import page_table as tpt

FAULTS = pytest.mark.parametrize("fm", [jfaults, tfaults], ids=["jax", "torch"])
PLANS = ["crash@1:6,stall@0:3:0.05,pressure@2:4:6x2", "corrupt@1:4,crash@1:5",
         "stall@2:1:1.5;pressure@0:2:3", "", "none", "crash@0:2,crash@1:2"]


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


# ---------------------------------------------------------------------------
# FaultPlan / FaultSpec / the hook: the reference's cases on both packages
# ---------------------------------------------------------------------------
@FAULTS
def test_fault_plan_parse_describe_roundtrip(fm):
    text = "crash@1:6,stall@0:3:0.05,pressure@2:4:6x2"
    plan = fm.FaultPlan.parse(text)
    assert len(plan.specs) == 3
    assert fm.FaultPlan.parse(plan.describe()).describe() == plan.describe()
    assert not fm.FaultPlan.parse("")
    assert not fm.FaultPlan.parse("none")
    with pytest.raises(ValueError, match="bad fault-plan item"):
        fm.FaultPlan.parse("explode@0:1")
    with pytest.raises(ValueError, match="bad fault-plan item"):
        fm.FaultPlan.parse("crash@0")


@FAULTS
def test_fault_spec_validation(fm):
    with pytest.raises(ValueError):
        fm.FaultSpec("explode", 0, 1)
    with pytest.raises(ValueError):
        fm.FaultSpec("crash", -1, 1)
    with pytest.raises(ValueError):
        fm.FaultSpec("pressure", 0, 1, pages=0)
    with pytest.raises(ValueError):
        fm.FaultSpec("stall", 0, 1, duration_s=-1.0)


@FAULTS
def test_fault_plan_generate_is_seed_deterministic(fm):
    a = fm.FaultPlan.generate(4, seed=7, crashes=2, stalls=1, pressures=1)
    b = fm.FaultPlan.generate(4, seed=7, crashes=2, stalls=1, pressures=1)
    c = fm.FaultPlan.generate(4, seed=8, crashes=2, stalls=1, pressures=1)
    assert a.describe() == b.describe()
    assert a.describe() != c.describe()
    with pytest.raises(ValueError):
        fm.FaultPlan.generate(0)


@FAULTS
def test_hook_fires_once_and_only_for_its_worker(fm):
    plan = fm.FaultPlan([fm.FaultSpec("stall", 1, 2, duration_s=0.5)])
    assert plan.hook_for(0) is None
    vt = VirtualTime()
    hook = plan.hook_for(1, sleep=vt.sleep)
    for step in range(6):
        hook(fm.FaultContext(step=step, clock=vt.clock))
    assert [s.step for s in hook.fired] == [2]
    assert vt.t == pytest.approx(0.5)


@FAULTS
def test_crash_hook_raises_its_worker_crash(fm):
    hook = fm.FaultPlan.parse("crash@3:2").hook_for(3)
    hook(fm.FaultContext(step=1))
    with pytest.raises(fm.WorkerCrash) as e:
        hook(fm.FaultContext(step=2))
    assert (e.value.worker, e.value.step, e.value.reason) == (3, 2, "injected-crash")
    assert e.value.results == [] and e.value.pending == []


@FAULTS
def test_pressure_hook_seizes_and_returns_pages(fm):
    pt = jpt if fm is jfaults else tpt
    pool = pt.PagePool(num_pages=9, page_size=4)
    hook = fm.FaultPlan.parse("pressure@0:1:5x2").hook_for(0)
    hook(fm.FaultContext(step=1, pool=pool))
    assert pool.num_free == pool.capacity - 5
    hook(fm.FaultContext(step=2, pool=pool))     # held for two boundaries
    assert pool.num_free == pool.capacity - 5
    hook(fm.FaultContext(step=3, pool=pool))
    assert pool.num_free == pool.capacity
    hook2 = fm.FaultPlan.parse("pressure@0:0:3x9").hook_for(0)
    hook2(fm.FaultContext(step=0, pool=pool))
    assert hook2.release() == 3 and pool.num_free == pool.capacity


@FAULTS
def test_duplicate_fault_plan_entries_rejected(fm):
    with pytest.raises(ValueError, match="duplicate fault"):
        fm.FaultPlan.parse("crash@1:2,corrupt@1:2")
    with pytest.raises(ValueError, match="duplicate fault"):
        fm.FaultPlan.parse("stall@0:3:0.1,stall@0:3:0.2")
    assert len(fm.FaultPlan.parse("crash@0:2,crash@1:2").specs) == 2
    plan = fm.FaultPlan.parse("corrupt@1:4,crash@1:5")
    assert fm.FaultPlan.parse(plan.describe()).describe() == plan.describe()


@FAULTS
def test_worker_drain_is_a_planned_crash(fm):
    drain = fm.WorkerDrain(2, 7)
    assert isinstance(drain, fm.WorkerCrash) and isinstance(drain, fm.FaultError)
    assert drain.reason == "drain"
    assert (drain.worker, drain.step) == (2, 7)


def test_the_port_raises_its_own_classes():
    """The router catches the port's WorkerCrash alone: the port's hook must
    never raise the reference's (nor the other way round)."""
    assert not issubclass(tfaults.WorkerCrash, jfaults.WorkerCrash)
    assert not issubclass(jfaults.WorkerCrash, tfaults.WorkerCrash)
    with pytest.raises(tfaults.WorkerCrash):
        tfaults.FaultPlan.parse("crash@0:0").hook_for(0)(tfaults.FaultContext(step=0))


# ---------------------------------------------------------------------------
# parity: describe / to_dict / generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", PLANS)
@pytest.mark.parametrize("seed", [0, 11])
def test_fault_plan_describe_and_to_dict_match_the_reference(text, seed):
    j, t = jfaults.FaultPlan.parse(text, seed=seed), tfaults.FaultPlan.parse(text, seed=seed)
    assert t.describe() == j.describe()
    assert t.to_dict() == j.to_dict()
    assert bool(t) == bool(j)
    for w in range(3):
        assert [s.to_dict() for s in t.for_worker(w)] == [s.to_dict() for s in j.for_worker(w)]


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_fault_plan_generate_matches_the_reference(seed):
    kw = dict(max_step=9, crashes=2, stalls=2, pressures=1, stall_s=0.2, pages=3, hold_steps=4)
    j = jfaults.FaultPlan.generate(3, seed=seed, **kw)
    t = tfaults.FaultPlan.generate(3, seed=seed, **kw)
    assert t.describe() == j.describe() and t.to_dict() == j.to_dict()


# ---------------------------------------------------------------------------
# page checksums: equal bytes give the reference's CRCs
# ---------------------------------------------------------------------------
L, PS, H, D = 2, 4, 2, 3

# (numpy dtype of the reference's arrays, torch dtype, the int view both share)
STORES = {
    "f32": (np.float32, torch.float32, np.int32),
    "int8": (np.int8, torch.int8, np.int8),
    "bf16": (ml_dtypes.bfloat16, torch.bfloat16, np.int16),
    "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, np.int8),
}


def _bits(shape, view, rng):
    info = np.iinfo(view)
    return rng.integers(info.min, info.max, shape, dtype=np.int64).astype(view)


def _pair(store, pages=3, seed=0):
    """The same random bytes as the reference's numpy arrays and as the
    port's tensors: (jax arrays, torch tensors), each [k, v] (+ scales for
    int8/fp8)."""
    np_dt, t_dt, view = STORES[store]
    rng = np.random.default_rng(seed)
    raw = [_bits((L, pages, PS, H, D), view, rng) for _ in range(2)]
    jarr = [r.view(np_dt) for r in raw]
    tarr = [torch.from_numpy(r.copy()).view(t_dt) for r in raw]
    if store in ("int8", "fp8"):
        sc = [rng.random((L, pages, PS, H)).astype(np.float32) for _ in range(2)]
        jarr += sc
        tarr += [torch.from_numpy(s.copy()) for s in sc]
    return jarr, tarr


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("pages", [1, 3])
def test_page_checksums_equal_the_references_on_the_same_bytes(store, pages):
    jarr, tarr = _pair(store, pages)
    want = jpt.page_checksums(*jarr)
    assert tpt.page_checksums(*tarr) == want
    assert len(want) == pages and all(0 <= c <= 0xFFFFFFFF for c in want)


def _snapshot(store="f32", pages=3, seed=0):
    _, t = _pair(store, pages, seed)
    ks, vs = (t[2], t[3]) if len(t) == 4 else (None, None)
    return tpt.PageSnapshot(
        request_id=7, prompt_len=5, length=9, tokens=np.arange(4, dtype=np.int32),
        k=t[0], v=t[1], k_scales=ks, v_scales=vs,
        checksums=tpt.page_checksums(t[0], t[1], ks, vs), kv_dtype=store)


@pytest.mark.parametrize("store", list(STORES))
def test_page_checksums_catch_any_byte_flip(store):
    snap = _snapshot(store)
    assert snap.verify()
    names = ("k", "v") + (("k_scales", "v_scales") if snap.k_scales is not None else ())
    for name in names:
        arr = getattr(snap, name).clone()
        arr.view(torch.uint8).reshape(arr.shape[0], arr.shape[1], -1)[1, 2, -1] ^= 0x01
        fresh = {n: getattr(snap, n) for n in ("k", "v", "k_scales", "v_scales")}
        fresh[name] = arr
        sums = tpt.page_checksums(fresh["k"], fresh["v"], fresh["k_scales"], fresh["v_scales"])
        assert sums[2] != snap.checksums[2], name
        assert sums[:2] == snap.checksums[:2], name


@pytest.mark.parametrize("store", list(STORES))
def test_snapshot_corrupt_bites_a_copy(store):
    """``corrupt`` flips one page of a copy: the tensor it held before (which
    a pool, a checkpoint store and the router may all share) keeps its
    bytes, the ledger stays stale, and verify catches it."""
    snap = _snapshot(store)
    before = snap.k
    raw = lambda t: t.view(torch.uint8)
    kept = raw(before).clone()
    snap.corrupt(page=0)
    assert snap.k is not before and torch.equal(raw(before), kept)
    assert not snap.verify()
    assert not torch.equal(raw(snap.k)[:, 0], kept[:, 0])
    assert torch.equal(raw(snap.k)[:, 1:], kept[:, 1:])
    assert snap.num_pages == 3
    n = sum(t.numel() * t.element_size() for t in (snap.k, snap.v))
    if snap.k_scales is not None:
        n += 2 * snap.k_scales.numel() * 4
    assert snap.nbytes == n


SNAPSHOTS = pytest.mark.parametrize("fm,make", [
    (jfaults, lambda seed: _jax_snapshot(seed)),
    (tfaults, lambda seed: _snapshot(seed=seed)),
], ids=["jax", "torch"])


@SNAPSHOTS
def test_corrupt_fault_defers_until_a_snapshot_exists(fm, make):
    hook = fm.FaultPlan([fm.FaultSpec("corrupt", 0, 1)]).hook_for(0)
    store = {}
    for step in (1, 2):
        hook(fm.FaultContext(step=step, checkpoints=store))
    assert not hook.fired
    snap = make(0)
    store[snap.request_id] = snap
    hook(fm.FaultContext(step=3, checkpoints=store))
    assert [s.step for s in hook.fired] == [1]
    assert not snap.verify()
    hook(fm.FaultContext(step=4, checkpoints=store))
    assert len(hook.fired) == 1


@SNAPSHOTS
def test_corrupt_bites_the_latest_snapshot(fm, make):
    hook = fm.FaultPlan([fm.FaultSpec("corrupt", 0, 0)]).hook_for(0)
    older, newer = make(1), make(2)
    older.step, newer.step = 2, 5
    older.request_id, newer.request_id = 1, 3
    store = {1: older, 3: newer}
    hook(fm.FaultContext(step=0, checkpoints=store))
    assert older.verify() and not newer.verify()


def _jax_snapshot(seed=0):
    j, _ = _pair("f32", 3, seed)
    return jpt.PageSnapshot(request_id=7, prompt_len=5, length=9,
                            tokens=np.arange(4, dtype=np.int32), k=j[0], v=j[1],
                            checksums=jpt.page_checksums(j[0], j[1]))


@pytest.mark.parametrize("store", list(STORES))
def test_corrupt_flips_the_bytes_the_reference_flips(store):
    """The same corrupt fault on the same bytes leaves the same (stale)
    ledger and the same recomputed checksums in both packages."""
    jarr, tarr = _pair(store)
    jsc = (jarr[2], jarr[3]) if len(jarr) == 4 else (None, None)
    tsc = (tarr[2], tarr[3]) if len(tarr) == 4 else (None, None)
    js = jpt.PageSnapshot(request_id=0, prompt_len=1, length=9, tokens=np.zeros(1, np.int32),
                          k=jarr[0], v=jarr[1], k_scales=jsc[0], v_scales=jsc[1],
                          checksums=jpt.page_checksums(jarr[0], jarr[1], *jsc))
    ts = tpt.PageSnapshot(request_id=0, prompt_len=1, length=9, tokens=np.zeros(1, np.int32),
                          k=tarr[0], v=tarr[1], k_scales=tsc[0], v_scales=tsc[1],
                          checksums=tpt.page_checksums(tarr[0], tarr[1], *tsc))
    assert ts.checksums == js.checksums and ts.nbytes == js.nbytes
    js.corrupt(page=1)
    ts.corrupt(page=1)
    assert tpt.page_checksums(ts.k, ts.v, *tsc) == jpt.page_checksums(js.k, js.v, *jsc)
    assert not ts.verify() and not js.verify()
