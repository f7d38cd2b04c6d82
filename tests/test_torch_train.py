"""The port's training substrate (``repro_torch.train``): every test of
``tests/test_train.py`` on the port, then what the port adds: checkpoints
that cross between the packages, the driver on the CPU (resume gives the
same losses, the evaluation record has the reference's keys), the kernel
ops that refuse gradients they cannot give, and ``moe_apply``'s
differentiable path with the serving path's bits.

The optimizer updates in place, so a test that compares a tree before and
after a step copies it first."""
import gc
import os
import weakref

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.evaldb import EvalDB
from repro_torch.kernels import ops
from repro_torch.launch import train as train_driver
from repro_torch.models import build_model
from repro_torch.models import modules as tmod
from repro_torch.models.params import P
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import (
    RecordIOReader,
    RecordIOWriter,
    SyntheticTokenDataset,
    make_loader,
)
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    init_opt_state,
    lr_at,
    quantize_int8,
)
from repro_torch.train.step import make_grad_fn, make_loss_fn, make_train_step

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: these tensors are tiny, and the suite's
    parallel workers each starting a thread per core oversubscribe the
    cores (this file's tests took twice as long under the full suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone()


# ---------------------------------------------------------------------------
# tests/test_train.py on the port
# ---------------------------------------------------------------------------
def test_adamw_first_step_matches_manual():
    cfg = OptimizerConfig(lr=0.1, beta1=0.9, beta2=0.99, eps=1e-8,
                          weight_decay=0.0, warmup_steps=0, total_steps=10**6,
                          clip_norm=1e9)
    params = {"w": torch.tensor([1.0, -2.0])}
    before = _copy(params)
    grads = {"w": torch.tensor([0.5, 0.5])}
    state = init_opt_state({"w": P((2,))}, cfg, CPU)
    new_params, new_state, _ = adamw_update(params, grads, state, cfg)
    step_delta = float(before["w"][0] - new_params["w"][0])
    manual = 0.1 * ((0.5 / 1.0) / (np.sqrt(0.25 / 1.0) + 1e-8))
    assert step_delta == pytest.approx(manual, rel=1e-5)
    assert int(new_state["step"]) == 1


def test_weight_decay_pulls_to_zero():
    cfg = OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                          total_steps=100, clip_norm=1e9)
    params = {"w": torch.tensor([4.0])}
    grads = {"w": torch.tensor([0.0])}
    state = init_opt_state({"w": P((1,))}, cfg, CPU)
    new_params, _, _ = adamw_update(params, grads, state, cfg)
    assert float(new_params["w"][0]) < 4.0


def test_lr_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    assert float(lr_at(0, cfg)) == 0.0
    assert float(lr_at(5, cfg)) == pytest.approx(0.5)
    assert float(lr_at(10, cfg)) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_at(110, cfg)) == pytest.approx(0.1, rel=1e-3)
    mid = float(lr_at(60, cfg))
    assert 0.1 < mid < 1.0


def test_clip_by_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(5.0)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in clipped.values()))
    assert float(total) == pytest.approx(1.0, rel=1e-5)


@settings(max_examples=20, deadline=None)
@given(scale=st.floats(1e-3, 1e3))
def test_int8_compression_bounded_error(scale):
    g = torch.from_numpy((np.random.default_rng(0).normal(size=(64,)) * scale).astype(np.float32))
    gen = torch.Generator()
    gen.manual_seed(0)
    gq = quantize_int8(g, gen)
    # error bounded by one quantization step (max|g|/127)
    step = float(g.abs().max()) / 127.0
    assert float((gq - g).abs().max()) <= step + 1e-6


def test_microbatched_grads_match_full_batch():
    cfg = get_config("glm4-9b", reduced=True)
    model = build_model(cfg, CPU)
    params = model.init(0)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12)).astype(np.int32))}
    opt_cfg = OptimizerConfig(lr=0.0, warmup_steps=0, total_steps=10, clip_norm=1e9,
                              weight_decay=0.0)
    # lr=0 so params unchanged; compare reported grad_norm across microbatchings
    step1 = make_train_step(model, opt_cfg, microbatches=1, remat=False)
    step4 = make_train_step(model, opt_cfg, microbatches=4, remat=True)
    _, _, m1 = step1(params, init_opt_state(model.param_defs(), opt_cfg, CPU), batch)
    _, _, m4 = step4(params, init_opt_state(model.param_defs(), opt_cfg, CPU), batch)
    assert float(m1["grad_norm"]) == pytest.approx(float(m4["grad_norm"]), rel=1e-3)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-4)
    # and the loss function alone gives the full batch's loss
    loss, _ = make_loss_fn(model)(params, batch)
    assert float(loss) == pytest.approx(float(m1["loss"]), rel=1e-6)


def test_loss_decreases_over_steps():
    cfg = get_config("mamba2-130m", reduced=True)
    model = build_model(cfg, CPU)
    params = model.init(0)
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    opt_state = init_opt_state(model.param_defs(), opt_cfg, CPU)
    step = make_train_step(model, opt_cfg, microbatches=1, remat=False)
    data = SyntheticTokenDataset(cfg.vocab_size, 16, seed=0)
    first = last = None
    for _ in range(8):
        batch = {"tokens": torch.from_numpy(data.batch(0, 4))}  # same batch: must overfit
        params, opt_state, metrics = step(params, opt_state, batch)
        if first is None:
            first = float(metrics["loss"])
        last = float(metrics["loss"])
    assert last < first, (first, last)


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(3)}}
    opt = {"step": torch.tensor(7, dtype=torch.int32),
           "m": {"w": torch.zeros((2, 3)), "nested": {"b": torch.zeros(3)}}}
    for step in (10, 20, 30):
        mgr.save(step, params, opt, extra={"data_cursor": step * 100})
    assert mgr.all_steps() == [20, 30]  # retention pruned step 10
    restored, opt2, meta = mgr.restore(params_template=params, opt_template=opt)
    assert torch.equal(restored["w"], params["w"])
    assert torch.equal(opt2["m"]["nested"]["b"], torch.zeros(3))
    assert int(opt2["step"]) == 7 and opt2["step"].dtype == torch.int32
    assert meta["step"] == 30 and meta["data_cursor"] == 3000


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)})
    cdir = os.path.join(str(tmp_path), "ckpt-000000001")
    shard = [f for f in os.listdir(cdir) if f.startswith("shard")][0]
    with open(os.path.join(cdir, shard), "ab") as f:
        f.write(b"CORRUPT")
    with pytest.raises(ValueError, match="checksum"):
        mgr.restore(params_template={"w": None})


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"w": torch.ones(2)})
    entries = [e for e in os.listdir(str(tmp_path)) if e.startswith(".tmp")]
    assert entries == []


def test_restore_without_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": torch.ones(2)})
    params, opt, meta = mgr.restore()
    assert meta["step"] == 3
    np.testing.assert_array_equal(params["w"].numpy(), np.ones(2, np.float32))


def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "tokens.rio")
    w = RecordIOWriter(path, seq_len=8)
    recs = [np.arange(i, i + 8, dtype=np.int32) for i in range(5)]
    for r in recs:
        w.append(r)
    w.close()
    r = RecordIOReader(path)
    assert len(r) == 5 and r.seq_len == 8
    np.testing.assert_array_equal(r.record(3), recs[3])
    np.testing.assert_array_equal(r.batch(1, 2), np.stack(recs[1:3]))
    # wraparound
    wrap = r.batch(4, 2)
    np.testing.assert_array_equal(wrap[0], recs[4])
    np.testing.assert_array_equal(wrap[1], recs[0])


def test_recordio_rejects_bad_magic(tmp_path):
    path = str(tmp_path / "bad.rio")
    with open(path, "wb") as f:
        f.write(b"NOPE" + b"\x00" * 16)
    with pytest.raises(ValueError, match="magic"):
        RecordIOReader(path)


def test_loader_resume_from_cursor(tmp_path):
    ds = SyntheticTokenDataset(vocab_size=97, seq_len=4, seed=1)
    it = make_loader(ds, batch_size=2)
    cursor1, b1 = next(it)
    cursor2, b2 = next(it)
    assert cursor1 == 2 and cursor2 == 4
    # resume: skipping cursor1 records reproduces the second batch exactly
    it2 = make_loader(ds, batch_size=2, skip=cursor1)
    cursor2b, b2b = next(it2)
    assert cursor2b == cursor2
    np.testing.assert_array_equal(b2["tokens"], b2b["tokens"])


def test_synthetic_to_recordio(tmp_path):
    ds = SyntheticTokenDataset(vocab_size=31, seq_len=6, seed=0)
    path = str(tmp_path / "synth.rio")
    ds.write_recordio(path, 4)
    r = RecordIOReader(path)
    assert len(r) == 4
    assert r.batch(0, 4).max() < 31


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"w": rng.normal(size=(2, 3)).astype(np.float32),
            "blocks": [{"a": rng.normal(size=(4,)).astype(np.float32)} for _ in range(2)],
            "step": np.int32(7)}


def test_float32_checkpoint_crosses_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    # JAX writes, the port restores (into a template and without one)
    JaxCheckpointManager(str(tmp_path / "j")).save(4, tree, extra={"data_cursor": 8})
    mgr = CheckpointManager(str(tmp_path / "j"))
    template = {"w": torch.zeros(2, 3), "blocks": [{"a": torch.zeros(4)}] * 2,
                "step": torch.tensor(0, dtype=torch.int32)}
    got, _, meta = mgr.restore(params_template=template)
    assert meta == {"step": 4, "data_cursor": 8}
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(got["blocks"][1]["a"].numpy(), tree["blocks"][1]["a"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    flat, _, _ = mgr.restore()
    np.testing.assert_array_equal(flat["blocks"]["0"]["a"].numpy(), tree["blocks"][0]["a"])
    # the port writes, JAX restores
    port = {"w": torch.from_numpy(tree["w"]), "blocks": [{"a": torch.from_numpy(b["a"])}
                                                         for b in tree["blocks"]],
            "step": torch.tensor(7, dtype=torch.int32)}
    CheckpointManager(str(tmp_path / "t")).save(5, port)
    back, _, meta = JaxCheckpointManager(str(tmp_path / "t")).restore(params_template=tree)
    assert meta["step"] == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_bf16_leaf_roundtrips_bit_for_bit(tmp_path):
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32))
    w = w.to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, {"w": w, "f": w.float()})
    got, _, _ = mgr.restore(params_template={"w": torch.zeros(1), "f": torch.zeros(1)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(got["f"], w.float())
    assert "bfloat16" in open(os.path.join(path, "manifest.json")).read()


# ---------------------------------------------------------------------------
# the driver on the CPU
# ---------------------------------------------------------------------------
DRIVER = ["--device", "cpu", "--reduced", "--batch", "4", "--seq", "16", "--log-every", "1",
          "--steps", "6"]


def _losses(out):
    return [line.split("loss=")[1].split()[0] for line in out.splitlines()
            if line.startswith("[train] step")]


def test_driver_resume_gives_the_same_losses(tmp_path, capsys):
    assert train_driver.main(DRIVER) == 0
    straight = _losses(capsys.readouterr().out)
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3"]
    with pytest.raises(StopIteration):
        # a run killed after its checkpoint at step 3: the loader stops it
        real = train_driver.make_loader

        def three(*a, **kw):
            it = real(*a, **kw)
            return (next(it) for _ in range(3))

        train_driver.make_loader = three
        try:
            train_driver.main(DRIVER + ckpt)
        finally:
            train_driver.make_loader = real
    first = _losses(capsys.readouterr().out)
    db = str(tmp_path / "eval.db")
    train_driver.main(DRIVER + ckpt + ["--resume", "--evaldb", db])
    out = capsys.readouterr().out
    assert "resumed from step 3 (cursor 12)" in out
    assert len(straight) == 6 and first + _losses(out) == straight
    rec = EvalDB(db).query()[0]
    assert rec.backend == "torch" and rec.scenario == "train" and rec.agent_id == "train-driver"
    assert set(rec.metrics) == {"final_loss", "first_loss"}
    assert rec.model == "mamba2-130m-reduced" and rec.batch_size == 4


def test_driver_trains_encdec_on_zero_frames(capsys):
    code = train_driver.main(["--device", "cpu", "--reduced", "--arch", "whisper-large-v3",
                              "--batch", "2", "--seq", "8", "--steps", "4", "--log-every", "2",
                              "--lr", "1e-2"])
    out = capsys.readouterr().out
    assert "[train] done" in out and code in (0, 1)


# ---------------------------------------------------------------------------
# gradients the kernel ops cannot give, and what the step refuses
# ---------------------------------------------------------------------------
def _serving_calls():
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g)
    q = rn(2, 1, 4, 16).requires_grad_()
    kc, vc = rn(2, 8, 2, 16), rn(2, 8, 2, 16)
    kp, vp = rn(4, 4, 2, 16), rn(4, 4, 2, 16)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([5, 6], dtype=torch.int32)
    qv = rn(6, 4, 16).requires_grad_()
    return {
        "decode_attention": lambda: ops.decode_attention(q, kc, vc, lens),
        "paged_attention": lambda: ops.paged_attention(q, kp, vp, table, lens),
        "spec_verify": lambda: ops.spec_verify(
            rn(2, 2, 4, 16).requires_grad_(), kp, vp, table,
            torch.tensor([3, 4], dtype=torch.int32),
            torch.tensor([2, 1], dtype=torch.int32)),
        "varlen_prefill": lambda: ops.varlen_prefill(
            qv, rn(6, 2, 16), rn(6, 2, 16), kp, vp,
            torch.tensor([0, 6], dtype=torch.int32), torch.tensor([6], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32), table[:1]),
    }


@pytest.mark.parametrize("name", ["decode_attention", "paged_attention", "spec_verify",
                                  "varlen_prefill"])
def test_serving_ops_refuse_gradients(name):
    call = _serving_calls()[name]
    with pytest.raises(NotImplementedError, match=f"{name} has no backward"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call()).all()


def test_train_step_refuses_grad_shardings():
    model = build_model(get_config("glm4-9b", reduced=True), CPU)
    with pytest.raises(NotImplementedError, match="item 9"):
        make_train_step(model, OptimizerConfig(), grad_shardings={})


def test_moe_forward_same_bits_with_and_without_grad():
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True).replace(capacity_factor=0.5)
    model = build_model(cfg, CPU)
    params = model.init(0)
    blk = params["blocks"][0]["mlp"]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32))
    with torch.no_grad():
        want, aux0 = tmod.moe_apply(blk, x, cfg)
    xg = x.clone().requires_grad_()
    got, aux = tmod.moe_apply(blk, xg, cfg)
    assert got.requires_grad and torch.equal(got, want) and torch.equal(aux, aux0)
    (g,) = torch.autograd.grad(got.square().sum(), xg)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        plain, _ = model.forward(params, {"tokens": tokens})
    leaves = {"blocks": [{**b, "mlp": {k: v.clone().requires_grad_() for k, v in b["mlp"].items()}}
                         for b in params["blocks"]]}
    graded, _ = model.forward({**params, **leaves}, {"tokens": tokens})
    assert graded.requires_grad and torch.equal(graded, plain)


def test_grad_fn_matches_autograd_of_the_loss():
    cfg = get_config("glm4-9b", reduced=True)
    model = build_model(cfg, CPU)
    params = model.init(0)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32))}
    grads, _ = make_grad_fn(model, microbatches=2, remat=True)(params, batch)
    leaves = {"embed": params["embed"].clone().requires_grad_()}
    loss, _ = make_loss_fn(model)({**params, **leaves}, batch)
    (want,) = torch.autograd.grad(loss, [leaves["embed"]])
    assert (grads["embed"] - want).abs().max() <= 1e-5 * want.abs().max()


def test_a_step_leaves_no_reference_cycle_holding_its_trees():
    """The gradients a step returns die with their last reference, without
    the garbage collector: at full width a cycle over them held ~24 GB of
    the card until the collector happened to run."""
    cfg = get_config("glm4-9b", reduced=True)
    model = build_model(cfg, CPU)
    params = model.init(0)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))}
    # the first checkpointed call of a process imports torch._dynamo, and
    # that import keeps the calling frames (and their locals) alive
    make_grad_fn(model, microbatches=1, remat=True)(params, batch)
    gc.collect()
    gc.disable()
    try:
        for mb in (1, 2):
            grads, _ = make_grad_fn(model, microbatches=mb, remat=True)(params, batch)
            ref = weakref.ref(grads["embed"])
            del grads
            assert ref() is None, mb
        opt_cfg = OptimizerConfig(warmup_steps=1)
        state = init_opt_state(model.param_defs(), opt_cfg, CPU)
        step = make_train_step(model, opt_cfg, microbatches=2)
        params, state, _ = step(params, state, batch)
        ref = weakref.ref(state["m"]["embed"])
        del state
        assert ref() is None
    finally:
        gc.enable()
