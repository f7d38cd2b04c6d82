"""The Mamba-2 scan's backward: ``ref.ssd_bwd`` (the sequential reverse
recurrence), ``ref.ssd_bwd_chunks`` (the same gradients in the launches of
``csrc/ssd_bwd.cu``) and ``SSDFn`` (``ops.ssd`` with an input that requires
grad) on the CPU against ``jax.vjp`` of the JAX package's
``ssd_chunked_jnp``, from the same numpy inputs, in float32: every gradient
within ``1e-4 * max|g|`` (summation order).  Then ``gradcheck`` of
``SSDFn`` in float64, the plan's shared memory and workspaces at
mamba2-130m's and zamba2-2.7b's widths against the kernel source, and
gpu-marked tests that skip without a card: both routes against
``ref.ssd_bwd``, and ``SSDFn`` keeping the forward's states on the
tensor-core route.  JAX is imported inside the CPU tests only: the card's machine runs
``-m gpu`` without it."""
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssd_bwd as sb_mod
from repro_torch.kernels.ssd import SSDFn

SRC = (_build.CSRC / "ssd_bwd.cu").read_text()
REL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_initial")

# (b, s, h, p, n, chunk)
CASES = [
    pytest.param((2, 37, 3, 16, 16, 8), id="s37-chunk8"),     # 4 chunks and a partial one of 5
    pytest.param((2, 5, 3, 16, 16, 8), id="s5-lt-chunk"),      # one chunk of 5 live rows
    pytest.param((2, 32, 3, 16, 16, 8), id="s32"),             # four whole chunks
]


def _inputs(b, s, h, p, n, seed):
    """numpy x, dt, A, B, C, an initial state, dy and a final-state
    cotangent; dt and A in the ranges mamba2's inits give, wide enough that
    a chunk decays by ~e^-2."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt = rng.uniform(1e-3, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    return dict(x=f(b, s, h, p), dt=dt, A=A, B=f(b, s, n), C=f(b, s, n), s0=f(b, h, p, n),
                dy=f(b, s, h, p), df=f(b, h, p, n))


def _jax_grads(v, chunk, init, fin):
    """The six gradients by ``jax.vjp`` of ``ssd_chunked_jnp`` (the
    initial state's taken at zeros when there is none)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    def f(x, dt, A, B, C, s0):
        return jops.ssd_chunked_jnp(x, dt, A, B, C, chunk=chunk, initial_state=s0,
                                    return_state=True)

    s0 = v["s0"] if init else np.zeros_like(v["s0"])
    _, vjp = jax.vjp(f, *(jnp.asarray(v[k]) for k in ("x", "dt", "A", "B", "C")),
                     jnp.asarray(s0))
    df = v["df"] if fin else np.zeros_like(v["df"])
    return [np.asarray(g) for g in vjp((jnp.asarray(v["dy"]), jnp.asarray(df)))]


def _assert_close(got, want, label):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (label, name)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= REL * scale, (label, name, err, scale)


@pytest.mark.parametrize("fin", [False, True], ids=["no-final", "final"])
@pytest.mark.parametrize("init", [False, True], ids=["zero-init", "init"])
@pytest.mark.parametrize("shape", CASES)
def test_backward_matches_jax_vjp(shape, init, fin):
    b, s, h, p, n, chunk = shape
    v = _inputs(b, s, h, p, n, seed=s + 2 * init + fin)
    want = _jax_grads(v, chunk, init, fin)
    T = {k: torch.from_numpy(a) for k, a in v.items()}
    args = (T["x"], T["dt"], T["A"], T["B"], T["C"], T["dy"])
    opts = dict(initial_state=T["s0"] if init else None, d_final=T["df"] if fin else None)
    _assert_close(ref.ssd_bwd(*args, **opts), want, "ref.ssd_bwd")
    _assert_close(ref.ssd_bwd_chunks(*args, chunk=chunk, **opts), want, "ref.ssd_bwd_chunks")

    # SSDFn through ops.ssd, B and C as strided views of one projection
    x, dt, A = (T[k].clone().requires_grad_() for k in ("x", "dt", "A"))
    proj = torch.cat([T["B"], T["C"]], dim=-1).requires_grad_()
    s0 = T["s0"].clone().requires_grad_() if init else None
    with torch.enable_grad():
        out = ops.ssd(x, dt, A, proj[..., :n], proj[..., n:], chunk=chunk, initial_state=s0,
                      return_state=fin)
        y, sf = out if fin else (out, None)
        assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SSDFnBackward"
        loss = (y * T["dy"]).sum() + ((sf * T["df"]).sum() if fin else 0.0)
        leaves = [x, dt, A, proj] + ([s0] if init else [])
        grads = torch.autograd.grad(loss, leaves)
    dB, dC = grads[3][..., :n], grads[3][..., n:]
    got = list(grads[:3]) + [dB, dC] + ([grads[4]] if init else [])
    _assert_close(got, want, "SSDFn")


def test_ssdfn_gradcheck_float64():
    """The op's analytic gradients against finite differences, float64, a
    partial trailing chunk, an initial state and both outputs."""
    rng = np.random.default_rng(7)
    b, s, h, p, n, chunk = 1, 7, 2, 3, 4, 3
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape)).requires_grad_()
    x, B, C, s0 = f(b, s, h, p), f(b, s, n), f(b, s, n), f(b, h, p, n)
    dt = torch.from_numpy(rng.uniform(0.2, 0.6, (b, s, h))).requires_grad_()
    A = torch.from_numpy(-rng.uniform(0.5, 1.5, (h,))).requires_grad_()
    fn = lambda x, dt, A, B, C, s0: SSDFn.apply(x, dt, A, B, C, s0, chunk, True)
    assert torch.autograd.gradcheck(fn, (x, dt, A, B, C, s0), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_cpu_tensor_runs_the_plain_version():
    """The kernel is the card's: a CPU tensor launches nothing and gets
    ``ref.ssd_bwd``'s bits, whatever the chunk."""
    v = _inputs(2, 11, 2, 8, 16, seed=3)
    T = {k: torch.from_numpy(a) for k, a in v.items()}
    args = (T["x"], T["dt"], T["A"], T["B"], T["C"], T["dy"])
    before = sb_mod.launches
    got = sb_mod.ssd_bwd(*args, chunk=4, initial_state=T["s0"], d_final=T["df"])
    want = ref.ssd_bwd(*args, initial_state=T["s0"], d_final=T["df"])
    assert sb_mod.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ops_ssd_without_grad_is_the_serving_call():
    v = _inputs(1, 9, 2, 8, 16, seed=4)
    x, dt, A, B, C = (torch.from_numpy(v[k]) for k in ("x", "dt", "A", "B", "C"))
    y = ops.ssd(x, dt, A, B, C, chunk=4)
    assert y.grad_fn is None and torch.equal(y, ref.ssd(x, dt, A, B, C))


# ---------------------------------------------------------------------------
# the plan: shared memory and workspaces, and the kernel source
# ---------------------------------------------------------------------------
MAMBA2 = (64, 128, 64)      # p, n, chunk of mamba2-130m
ZAMBA2 = (64, 64, 64)       # of zamba2-2.7b


def test_plan_at_the_training_widths():
    """float32 (csrc/ssd_bwd.cu), mamba2-130m: the chunk-state launch stages
    x, dy (64 x 65) and B, C (64 x 129) floats, two blocks an SM; the
    chunk-gradient launch adds a 64 x 65 scratch, W / S_c (64 x 129) and
    three 64 x 65 matrices, one block an SM.  zamba2-2.7b's n 64 takes less.
    bf16 at these widths takes the tensor-core route (csrc/ssd_bwd_tc.cu):
    bf16 tiles padded by 8, two blocks of either launch an SM."""
    assert sb_mod.plan(torch.float32, *MAMBA2) == sb_mod.Plan("f32", 1, (100096, 200992))
    assert sb_mod.plan(torch.float32, *ZAMBA2).smem_bytes == (67328, 151840)
    assert 2 * (100096 + 1024) <= 228 * 1024 and 200992 <= _build.SMEM_LIMIT
    assert sb_mod.plan(torch.bfloat16, *MAMBA2) == sb_mod.Plan("mma", 2, (54272, 110368))
    assert sb_mod.plan(torch.bfloat16, *ZAMBA2) == sb_mod.Plan("mma", 2, (37888, 77600))
    assert 2 * (110368 + 1024) <= 228 * 1024


def test_plan_refuses_what_the_card_cannot_run():
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        sb_mod.plan(torch.float32, 64, 128, 128)
    with pytest.raises(TypeError, match="not supported"):
        sb_mod.plan(torch.float16, *MAMBA2)


@pytest.mark.parametrize("p, n, chunk", sorted({
    (c.ssm_head_dim, c.ssm_state, c.ssm_chunk) for a in list_archs()
    for c in (get_config(a), get_config(a, reduced=True)) if c.ssm_state}))
def test_the_zoo_plans_within_the_card(p, n, chunk):
    for dtype in (torch.bfloat16, torch.float32):
        assert max(sb_mod.plan(dtype, p, n, chunk).smem_bytes) <= _build.SMEM_LIMIT


def test_workspace_bytes_at_the_training_shapes():
    """The CUDA-core route: cum (b, s, h), chunk states and carried
    cotangents (b, nc, h, p, n), per-head dB and dC (b, s, h, n), dA's parts
    (b, nc, h), all float32: ~403 MB at mamba2's (8, 1024), half that a
    microbatch of 4 (the tensor-core route's: tests/test_torch_ssd_bwd_tc.py)."""
    b, s, h = 8, 1024, 24
    p, n, chunk = MAMBA2
    nc = 16
    want = 4 * (b * s * h + 2 * b * nc * h * p * n + 2 * b * s * h * n + b * nc * h)
    f32 = sb_mod.plan(torch.float32, p, n, chunk)
    assert sb_mod.workspace_bytes(f32, b, s, h, p, n, chunk) == want == 403_451_904
    # a sequence shorter than a chunk is one chunk of its live rows
    pl = sb_mod.plan(torch.bfloat16, 16, 16, 8, 5)
    assert pl.route == "f32" and sb_mod.workspace_bytes(pl, 2, 5, 3, 16, 16, 8) == 4 * (
        2 * 5 * 3 + 2 * 2 * 1 * 3 * 16 * 16 + 2 * 2 * 5 * 3 * 16 + 2 * 1 * 3)


def _c_expr(name):
    body = re.search(r"inline size_t %s\(int Q, int p, int n\) \{\s*return (.*?);" % name, SRC,
                     re.S).group(1)
    return re.sub(r"\(size_t\)", "", " ".join(body.split()))


@pytest.mark.parametrize("p, n, chunk", [MAMBA2, ZAMBA2, (16, 16, 8), (32, 48, 16)])
def test_plan_matches_the_kernel_source(p, n, chunk):
    """The constants and the shared-memory formulas are the source's own,
    the library builds the source and binds its entry point with one
    argument type a parameter."""
    assert re.search(r"constexpr int kGradVecs = %d;" % sb_mod.GRAD_VECS, SRC)
    env = dict(Q=chunk, p=p, n=n, kGradVecs=sb_mod.GRAD_VECS, kWarps=sb_mod.WARPS)
    states, grads = sb_mod.smem_bytes(p, n, chunk)
    assert 4 * eval(_c_expr("states_floats"), {}, env) == states
    assert 4 * eval(_c_expr("grads_floats"), {}, env) == grads
    assert sb_mod.WARPS == 256 // 32 and "constexpr int kThreads = 256;" in \
        (_build.CSRC / "common.cuh").read_text()
    assert "ssd_bwd.cu" in _build.SOURCES
    params = re.search(r'extern "C" int rt_ssd_bwd\((.*?)\)', SRC, re.S).group(1)
    assert len(params.split(",")) == len(_build.SIGNATURES["rt_ssd_bwd"]) == 34


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [pytest.param(torch.float32, id="float32"),
                                   pytest.param(torch.bfloat16, id="bfloat16")])
@pytest.mark.parametrize("shape", [(2, 37, 3, 16, 16, 8), (2, 5, 3, 16, 16, 8),
                                   (2, 130, 4, 64, 128, 64), (1, 70, 3, 64, 64, 64),
                                   (2, 37, 3, 16, 16, 16), (2, 45, 5, 32, 32, 32),
                                   (1, 20, 3, 64, 128, 64)])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, shape):
    """Each gradient within tol * (1 + |plain|) (bf16 2e-2, float32 5e-4,
    the scan's own), B and C strided views of one projection, an initial
    state and a final-state cotangent; two calls give the same bits.  bf16
    at p, n multiples of 16 and chunks 16/32/64 runs the tensor-core route
    (a partial trailing chunk, an odd head count, s below the chunk)."""
    b, s, h, p, n, chunk = shape
    route = sb_mod.plan(dtype, p, n, chunk, s).route
    assert route == ("mma" if dtype == torch.bfloat16 and chunk >= 16 else "f32")
    v = _inputs(b, s, h, p, n, seed=b * s + h)
    T = {k: torch.from_numpy(a).to(cuda) for k, a in v.items()}
    x, dy = T["x"].to(dtype), T["dy"].to(dtype)
    proj = torch.cat([T["B"], T["C"]], dim=-1).to(dtype)
    B, C = proj[..., :n], proj[..., n:]
    args = (x, T["dt"], T["A"], B, C, dy)
    opts = dict(initial_state=T["s0"], d_final=T["df"])
    before = sb_mod.launches
    got = sb_mod.ssd_bwd(*args, chunk=chunk, **opts)
    again = sb_mod.ssd_bwd(*args, chunk=chunk, **opts)
    torch.cuda.synchronize()
    assert sb_mod.launches == before + 2
    want = ref.ssd_bwd(*args, **opts)
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-4
    for name, g, a, w in zip(NAMES, got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        w = w.float().cpu()
        assert bool(((g.float().cpu() - w).abs() <= tol * (1 + w.abs())).all()), name


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 130, 4, 64, 128, 64), (2, 37, 3, 16, 16, 16)])
def test_ssdfn_keeps_the_forwards_states(cuda, shape, monkeypatch):
    """bf16 on the tensor-core route: ``SSDFn`` hands the forward's cum and
    entry states to the backward, and its gradients agree with the call that
    rebuilds them within 2e-2 * (1 + |rebuilt|)."""
    b, s, h, p, n, chunk = shape
    v = _inputs(b, s, h, p, n, seed=s + h)
    T = {k: torch.from_numpy(a).to(cuda) for k, a in v.items()}
    x, B, C = T["x"].bfloat16(), T["B"].bfloat16(), T["C"].bfloat16()
    dy = T["dy"].bfloat16()
    seen = []
    real = sb_mod.ssd_bwd

    def spy(*args, **kw):
        seen.append(kw["states"] is not None and kw["cum"] is not None)
        return real(*args, **kw)

    monkeypatch.setattr(sb_mod, "ssd_bwd", spy)
    leaves = [t.clone().requires_grad_() for t in (x, T["dt"], T["A"], B, C, T["s0"])]
    with torch.enable_grad():
        y, sf = ops.ssd(*leaves[:5], chunk=chunk, initial_state=leaves[5], return_state=True)
        got = torch.autograd.grad((y, sf), leaves, (dy, T["df"].bfloat16()))
    assert seen == [True]
    want = real(x, T["dt"], T["A"], B, C, dy, chunk=chunk, initial_state=T["s0"],
                d_final=T["df"].bfloat16().float())
    for name, g, w in zip(NAMES, got, want):
        w = w.float().cpu()
        assert bool(((g.float().cpu() - w).abs() <= 2e-2 * (1 + w.abs())).all()), name
