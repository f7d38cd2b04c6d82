"""The training backward's plain versions against the JAX package.

``ref.flash_attention_bwd`` (what ``csrc/flash_attention_bwd.cu`` computes)
against the JAX flash path's ``_flash_bwd_core`` and against ``jax.grad``
of ``flash_attention_jnp`` on the same numpy inputs, in float32, within
``1e-5 * max|ref|`` per output (summation order).  A query row with no live
key gives the mean of V in JAX and zero in the port (ROADMAP Queue 3): the
cotangent is zero on such rows, so they move nothing in either package,
and dq is compared on the rows with a live key.  ``ref.attention_lse``
against JAX's ``m + log(l)``; ``FlashAttentionFn`` and ``RMSNormFn`` on the
CPU against torch autograd of ``ref.attention`` and ``ref.rmsnorm``;
``ref.rmsnorm_bwd`` against ``jax.grad`` of ``repro.kernels.ref.rmsnorm``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.rmsnorm import RMSNormFn

BLOCK_K = 8     # the JAX core's key block: several blocks at these lengths
REL = 1e-5

# (b, sq, sk, h, kvh, d, causal, window, softcap, q_offset)
CASES = {
    "causal rep 2 d 16": (2, 24, 24, 4, 2, 16, True, None, 0.0, 0),
    "not causal rep 1 d 64, sq != sk": (2, 20, 28, 2, 2, 64, False, None, 0.0, 0),
    "window 8 q_offset 6 rep 4": (1, 16, 24, 8, 2, 16, True, 8, 0.0, 6),
    "softcap 50 rep 2 d 80": (2, 20, 20, 4, 2, 80, True, None, 50.0, 0),
    "q_offset 18, sq 12 sk 30, rep 4": (1, 12, 30, 4, 1, 16, True, None, 0.0, 18),
    "window 4 not causal, dead rows": (1, 16, 10, 2, 1, 16, False, 4, 0.0, 8),
    "softcap 50 window 6 q_offset 3": (2, 18, 22, 4, 2, 16, True, 6, 50.0, 3),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: these tensors are tiny, and the suite's
    parallel workers each starting a thread per core oversubscribe the
    cores (this file's tests took twice as long under the full suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _live_rows(sq, sk, causal, window, q_offset):
    q_pos = q_offset + np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= (q_pos - k_pos) < window
    return ok.any(axis=1)


def _case(name, seed=0):
    b, sq, sk, h, kvh, d, causal, window, softcap, q_offset = CASES[name]
    rng = np.random.default_rng(seed)
    # larger scores where the cap is on, so that it bends them
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32) * (8.0 if softcap else 1.0)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    live = _live_rows(sq, sk, causal, window, q_offset)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32) * live[None, :, None, None]
    opts = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    return (q, k, v, do), opts, live


def _close(got, want, rows=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if rows is not None:
        got, want = got[:, rows], want[:, rows]
    assert np.abs(got - want).max() <= REL * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_bwd_matches_jax(name):
    (q, k, v, do), opts, live = _case(name)
    d = q.shape[-1]
    scale = d ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, m, l = jops._flash_fwd_core(jq, jk, jv, opts["causal"], opts["window"],
                                      opts["softcap"], opts["q_offset"], BLOCK_K, scale)
    core = jops._flash_bwd_core(jq, jk, jv, jout, m, l, jdo, opts["causal"], opts["window"],
                                opts["softcap"], opts["q_offset"], BLOCK_K, scale)

    def f(q_, k_, v_):
        return jops.flash_attention_jnp(q_, k_, v_, block_k=BLOCK_K, **opts)

    _, vjp = jax.vjp(f, jq, jk, jv)
    grads = vjp(jdo)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.attention_lse(tq, tk, tv, **opts)
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **opts)
    for g, c, gr in zip(got, core, grads):
        rows = live if g.shape[1] == q.shape[1] else None
        _close(g.numpy(), c, rows)
        _close(g.numpy(), gr, rows)
    # the saved statistic is JAX's m + log(l) on live rows, the empty
    # sentinel on the others
    want_lse = np.asarray(m + jnp.log(l)).reshape(lse.shape)
    _close(lse.numpy()[:, :, live], want_lse[:, :, live])
    assert (lse.numpy()[:, :, ~live] == np.float32(ref.LSE_EMPTY)).all()
    assert (got[0].numpy()[:, ~live] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["softcap 50 window 6 q_offset 3",
                                  "q_offset 18, sq 12 sk 30, rep 4"])
def test_flash_attention_fn_matches_autograd(name, dtype):
    (q, k, v, do), opts, _ = _case(name, seed=1)
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, opts["causal"], opts["window"], opts["softcap"],
                                 opts["q_offset"], None)
    assert torch.equal(out, ref.attention(*[t.detach() for t in leaves], **opts))
    cot = torch.from_numpy(do).to(dtype)
    got = torch.autograd.grad(out, leaves, cot)
    plain = [t.detach().float().requires_grad_() for t in leaves]
    want = torch.autograd.grad(ref.attention(*plain, **opts), plain, cot.float())
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert (g.float() - w).abs().max() <= tol * w.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_fn_matches_autograd(dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 5, 48)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(48,)).astype(np.float32) * 0.1).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(3, 5, 48)).astype(np.float32)).to(dtype)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = RMSNormFn.apply(xl, wl, 1e-6)
    assert torch.equal(out, ref.rmsnorm(x, w, 1e-6))
    got = torch.autograd.grad(out, (xl, wl), dy)
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    want = torch.autograd.grad(ref.rmsnorm(xf, wf, 1e-6), (xf, wf), dy.float())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, t in zip(got, want):
        assert g.dtype == dtype
        assert (g.float() - t).abs().max() <= tol * t.abs().max()


def test_rmsnorm_bwd_matches_jax_grad():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6, 64)).astype(np.float32)
    w = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(4, 6, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_: jref.rmsnorm(x_, w_, 1e-5), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = ref.rmsnorm_bwd(*map(torch.from_numpy, (x, w)), 1e-5, torch.from_numpy(dy))
    _close(dx.numpy(), jdx)
    _close(dw.numpy(), jdw)


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256, 40, 290])
def test_bwd_plan_fits_every_head_dim_the_forward_takes(d):
    """The backward's tile fits a block at every bf16 head dim of the
    forward and at float32 head dims up to the forward tile's limit; two
    blocks an SM where they can."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_bwd as fb

    rows, bk = fb.plan(d)
    need = max(fb.dkdv_smem_bytes(rows, bk, d), fb.dq_smem_bytes(rows, bk, d))
    assert need <= _build.SMEM_LIMIT
    if d <= 128:
        assert need <= _build.SMEM_LIMIT // 2


def test_bwd_plan_refuses_a_tile_that_fits_no_block():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_bwd as fb

    with pytest.raises(_build.SharedMemoryError):
        fb.plan(4096)
