"""The port's plain kernel versions against the JAX Pallas kernels.

Inputs come from numpy with a fixed seed and go through both packages.  The
JAX side runs each Pallas kernel as its own suite does on the CPU (interpret
mode, picked by the kernel itself).  float32 tolerance is the JAX suite's
own (rtol = atol = 5e-5).  On the CPU each kernel wrapper of the port runs
its plain version, so the wrappers are held here too; the CUDA kernels
themselves are held against these plain versions in ``test_torch_cuda.py``
and ``chip_smoke.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.varlen_prefill import varlen_prefill as pallas_varlen
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels import rmsnorm as rn_mod
from repro_torch.kernels import varlen_prefill as vp_mod

TOL = dict(rtol=5e-5, atol=5e-5)


def _close(port, jax_out):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out, np.float32), **TOL)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 48), (1, 4096)])
def test_rmsnorm_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    want = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), want)
    _close(ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), want)


def test_rmsnorm_uses_one_plus_w():
    """The weight convention is ``(1 + w)``: zero weights are the identity
    scale, not a zero output."""
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    y = ref.rmsnorm(x, torch.zeros(32))
    torch.testing.assert_close(y, x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6))


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------
def _paged_inputs(b, h, kvh, d, ps, max_pages, lengths, seed):
    rng = np.random.default_rng(seed)
    num_pages = b * max_pages + 1
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kp = rng.normal(size=(num_pages, ps, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(num_pages, ps, kvh, d)).astype(np.float32)
    # a random physical assignment; page 0 is the scratch page
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, max_pages)
    return q, kp, vp, table.astype(np.int32), np.asarray(lengths, np.int32)


PAGED_CASES = [
    # b, h, kvh, d, page_size, max_pages, lengths
    (3, 4, 2, 16, 4, 5, [1, 7, 20]),      # ragged, non-divisible tails, full
    (2, 8, 1, 8, 8, 3, [13, 24]),         # MQA
    (2, 4, 4, 16, 4, 4, [16, 5]),         # MHA
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("opts", [{}, {"softcap": 7.0}, {"window": 5}])
def test_paged_attention_matches_pallas(case, opts):
    b, h, kvh, d, ps, mp, lengths = case
    q, kp, vp, table, lens = _paged_inputs(b, h, kvh, d, ps, mp, lengths, seed=ps + mp)
    want = pallas_paged(*map(jnp.asarray, (q, kp, vp, table, lens)), **opts)
    args = tuple(map(torch.from_numpy, (q, kp, vp, table, lens)))
    _close(ref.paged_attention(*args, **opts), want)
    _close(ops.paged_attention(*args, **opts), want)


def test_paged_attention_pages_bound_matches_pallas():
    """A ``pages_bound`` covering the live pages is exact; both packages cap
    the pages visited the same way."""
    q, kp, vp, table, lens = _paged_inputs(2, 4, 2, 16, 8, 6, [11, 19], seed=5)
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, lens)))
    targs = tuple(map(torch.from_numpy, (q, kp, vp, table, lens)))
    full = pallas_paged(*jargs)
    _close(ops.paged_attention(*targs, pages_bound=3), full)
    _close(ops.paged_attention(*targs, pages_bound=2),
           pallas_paged(*jargs, pages_bound=2))


def test_paged_attention_empty_row_is_zero():
    """A request with no live token (an idle slot at length 0) is exactly 0."""
    q, kp, vp, table, lens = _paged_inputs(2, 4, 2, 16, 4, 3, [0, 6], seed=1)
    want = pallas_paged(*map(jnp.asarray, (q, kp, vp, table, lens)))
    out = ref.paged_attention(*map(torch.from_numpy, (q, kp, vp, table, lens)))
    assert torch.all(out[0] == 0)
    _close(out, want)


# ---------------------------------------------------------------------------
# varlen_prefill: the CASES of tests/test_varlen_prefill.py
# ---------------------------------------------------------------------------
PAGE = 8
CASES = [
    # (chunks [(real_len, ctx_pages)], T): ragged lengths, non-divisible
    # chunk tails, empty chunk rows, context pages, buffer tail pad
    ([(5, 0), (8, 2), (3, 1)], 32),
    ([(13, 1), (0, 0), (7, 0)], 24),
    ([(8, 3), (16, 0), (2, 2), (5, 1)], 40),
    ([(21, 2)], 24),
]


def _pack(chunks, T, seed, kvh=2, h=4, d=16, max_pages=6, num_pages=24):
    rng = np.random.default_rng(seed)
    C = len(chunks)
    cu, lens, pos0 = [0], [], []
    tables = np.zeros((C, max_pages), np.int32)
    nxt = 1
    for c, (n, cp) in enumerate(chunks):
        cu.append(cu[-1] + (n + PAGE - 1) // PAGE * PAGE)
        lens.append(n)
        pos0.append(cp * PAGE)
        for j in range(cp):
            tables[c, j] = nxt
            nxt += 1
    assert cu[-1] <= T and nxt <= num_pages
    mk = lambda shape: rng.normal(size=shape).astype(np.float32)
    return (
        mk((T, h, d)), mk((T, kvh, d)), mk((T, kvh, d)),
        mk((num_pages, PAGE, kvh, d)), mk((num_pages, PAGE, kvh, d)),
        np.array(cu, np.int32), np.array(lens, np.int32),
        np.array(pos0, np.int32), tables,
    )


@pytest.mark.parametrize("chunks,T", CASES)
@pytest.mark.parametrize("opts", [{}, {"window": 5}, {"softcap": 11.0}])
def test_varlen_prefill_matches_pallas(chunks, T, opts):
    args = _pack(chunks, T, seed=T + len(chunks))
    want = pallas_varlen(*map(jnp.asarray, args), **opts)
    targs = tuple(map(torch.from_numpy, args))
    _close(ref.varlen_prefill(*targs, **opts), want)
    _close(ops.varlen_prefill(*targs, **opts), want)


def test_varlen_prefill_pages_bound_matches_pallas():
    args = _pack([(8, 2), (8, 1)], 16, seed=3)
    want = pallas_varlen(*map(jnp.asarray, args), pages_bound=2)
    _close(ops.varlen_prefill(*map(torch.from_numpy, args), pages_bound=2), want)


def test_varlen_prefill_pad_rows_are_exact_zeros():
    """Chunk-pad and buffer-tail rows come back exactly zero in both."""
    args = _pack([(5, 0), (11, 1)], 32, seed=9)
    pallas = np.asarray(pallas_varlen(*map(jnp.asarray, args)))
    port = ref.varlen_prefill(*map(torch.from_numpy, args)).numpy()
    for o in (pallas, port):
        assert np.all(o[5:8] == 0.0)            # chunk 0 pad
        assert np.all(o[8 + 11 : 24] == 0.0)    # chunk 1 pad
        assert np.all(o[24:] == 0.0)            # buffer tail


def test_varlen_prefill_no_cross_chunk_leakage():
    """Perturbing one chunk's K/V leaves the other chunk's output unchanged."""
    q, k, v, kp, vp, cu, lens, pos0, tables = map(
        torch.from_numpy, _pack([(8, 0), (8, 0)], 16, seed=4))
    base = ref.varlen_prefill(q, k, v, kp, vp, cu, lens, pos0, tables)
    k2, v2 = k.clone(), v.clone()
    k2[8:] += 3.7
    v2[8:] -= 1.9
    pert = ref.varlen_prefill(q, k2, v2, kp, vp, cu, lens, pos0, tables)
    assert torch.equal(base[:8], pert[:8])
    assert (base[8:] - pert[8:]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# wrappers on the CPU: plain versions only, no launch counted
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (rn_mod.launches, pa_mod.launches, vp_mod.launches)
    x = torch.randn(2, 16)
    torch.testing.assert_close(rn_mod.rmsnorm(x, torch.zeros(16)), ref.rmsnorm(x, torch.zeros(16)))
    q, kp, vp, table, lens = map(torch.from_numpy, _paged_inputs(1, 2, 1, 8, 4, 2, [5], seed=0))
    pa_mod.paged_attention(q, kp, vp, table, lens)
    vp_mod.varlen_prefill(*map(torch.from_numpy, _pack([(5, 1)], 8, seed=0)))
    assert (rn_mod.launches, pa_mod.launches, vp_mod.launches) == before


def test_wrappers_reject_other_devices():
    """A wrapper takes the CPU (its plain version) and CUDA (its kernel);
    the three on the dry run's path take meta tensors too (the launcher's
    outputs, no launch); every other device is refused."""
    x = torch.zeros(2, 16, device="meta")
    before = rn_mod.launches
    out = rn_mod.rmsnorm(x, torch.zeros(16, device="meta"))
    assert out.device.type == "meta" and out.shape == x.shape and rn_mod.launches == before
    q, kp, vp, table, lens = (torch.from_numpy(a).to("meta")
                              for a in _paged_inputs(1, 2, 1, 8, 4, 2, [5], seed=0))
    with pytest.raises(ValueError, match="unsupported device"):
        pa_mod.paged_attention(q, kp, vp, table, lens)


def test_kernel_build_stays_in_its_checkout(monkeypatch, tmp_path):
    """A package outside ``<checkout>/src/repro_torch`` (an installed copy)
    refuses to build rather than write into a shared environment."""
    from repro_torch.kernels import _build

    assert _build.BUILD_ROOT == _build.CHECKOUT / "build" / "repro_torch_kernels"
    assert (_build.CHECKOUT / "pyproject.toml").is_file()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "PACKAGE", tmp_path / "site-packages" / "repro_torch")
    monkeypatch.setattr(_build, "CHECKOUT", tmp_path)
    with pytest.raises(RuntimeError, match="checkout"):
        _build.library()
