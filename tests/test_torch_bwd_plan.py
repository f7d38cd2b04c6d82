"""The redesigned backward kernels' planning and order of work, on the CPU.

``flash_attention_bwd``: the route by dtype and head dim, the tensor-core
tiles against what ``csrc/flash_attention_bwd.cu`` builds and against the
shared memory of one block, the GQA splits that fill the card at glm4-9b's
training shapes, and ``ref.flash_attention_bwd_splits`` (per-share float32
dK/dV summed in share order, P and dS rounded to the input dtype before
their products: the kernel's order of work) against ``jax.vjp`` of
``repro.kernels.ops.flash_attention_jnp`` on the same numpy inputs.
Tolerances: float32 ``1e-5 * max|jax|`` (only the order of float32 sums
differs); bf16 ``3e-2 * max|jax|`` (P and dS are rounded to bf16, 2^-9
relative each, from float32 values that differ in their last bits between
the two packages, so a rounding can fall either way, and the outputs are
bf16).  Rows with no live key are left out of dq and carry a zero
cotangent, as in ``test_torch_flash_bwd.py`` (JAX gives them the mean of V).

``rmsnorm_bwd``: the vector plan at the zoo's training widths, the scalar
path where D or the alignment forbids vectors, the plan against the
source's constants, and ``ref.rmsnorm_bwd_partials`` +
``ref.rmsnorm_bwd_dw_sum`` (the kernels' per-block partials of dw and their
fixed-order sum) against ``jax.grad`` of ``repro.kernels.ref.rmsnorm``
within ``1e-5 * max|jax|`` in float32.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import rmsnorm_bwd as rb

FLASH_SRC = (_build.CSRC / "flash_attention_bwd.cu").read_text()
RMS_SRC = (_build.CSRC / "rmsnorm_bwd.cu").read_text()
BLOCK_K = 8     # the JAX core's key block: several blocks at these lengths


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the tensors are tiny and the suite's
    workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# flash_attention_bwd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_bf16_route_at_every_head_dim_of_the_forward(d):
    assert d in fa_mod.BF16_HEAD_DIMS
    want = "cuda_cores" if d == 256 else "tc"
    assert fb.route(torch.bfloat16, d) == want
    if want == "tc":
        dkdv, dq = fb.tc_smem_bytes(d)
        assert max(dkdv, dq) <= _build.SMEM_LIMIT
        # two blocks an SM
        assert max(dkdv, dq) <= _build.SMEM_LIMIT // 2
    else:
        rows, bk = fb.plan(d)
        assert max(fb.dkdv_smem_bytes(rows, bk, d), fb.dq_smem_bytes(rows, bk, d)) \
            <= _build.SMEM_LIMIT


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256, 40])
def test_float32_keeps_the_cuda_core_route(d):
    assert fb.route(torch.float32, d) == "cuda_cores"
    rows, bk = fb.plan(d)
    assert max(fb.dkdv_smem_bytes(rows, bk, d), fb.dq_smem_bytes(rows, bk, d)) \
        <= _build.SMEM_LIMIT


def test_tc_tiles_match_the_source():
    """Every (d, BQ, BK, layout) of TC_TILES is instantiated in the source,
    and nothing else is; the layout is Padded exactly where d/8 chunks are
    not a power of two; the shared-memory formula matches the source's."""
    built = {int(d): (int(bq), int(st), int(bk), int(mb), lay.lower())
             for d, bq, st, bk, mb, lay in re.findall(
                 r"^\s*RT_FLASH_BWD_TC\((\d+), (\d+), (\d+), (\d+), (\d+), (\w+)\);",
                 FLASH_SRC, re.M)}
    assert built == fb.TC_TILES
    for d, (_, stages, _, min_blocks, layout) in fb.TC_TILES.items():
        assert stages >= 2 and min_blocks >= 1
        chunks = d // 8
        assert layout == ("swizzle" if chunks & (chunks - 1) == 0 else "padded")
    assert f"kTcKeys = {fb.TC_KEYS};" in FLASH_SRC
    assert f"kTcRows = {fb.TC_ROWS};" in FLASH_SRC
    assert ("(2 * kTcKeys + 2 * ST * BQ) * Lay::kStride + sizeof(float) * 4 * ST * BQ"
            in FLASH_SRC)
    assert "(2 * kTcRows + 4 * BK) * Lay::kStride + sizeof(float) * 4 * BK" in FLASH_SRC
    # d 128: 16 query rows a dK/dV step (the dK, dV accumulators take 128
    # registers a thread) in a ring of 4, two blocks an SM; 32-key dQ steps
    assert fb.tc_smem_bytes(128) == (2 * (128 + 128) * 128 + 1024, 2 * 256 * 128 + 512) \
        == (66560, 66048)
    assert fb.tc_smem_bytes(80) == (2 * (128 + 192) * 88 + 1536, 2 * 256 * 88 + 512)


@pytest.mark.parametrize("shape, splits", [
    ((2, 1024, 2, 16), 8),     # glm4-9b at phase 4c's microbatch
    ((4, 1024, 2, 16), 4),     # glm4-9b at phase 4c's batch
    ((2, 1024, 32, 1), 1),     # zamba2's d 80, rep 1: no partials
    ((4, 1024, 32, 1), 1),
    ((1, 64, 2, 16), 16),      # a grid that cannot fill the card: one head a block
])
def test_splits_fill_the_card(shape, splits):
    b, sk, kvh, rep = shape
    got = fb.tc_splits(b, sk, kvh, rep)
    assert got == splits and rep % got == 0
    blocks = -(-sk // fb.TC_KEYS) * b * kvh * got
    assert blocks >= 2 * fb.SMS or got == rep
    # the least such divisor
    assert all(rep % s or -(-sk // fb.TC_KEYS) * b * kvh * s < 2 * fb.SMS for s in range(1, got))
    nbytes = fb.tc_scratch_bytes(b, sk, kvh, 128, got)
    assert nbytes == (0 if got == 1 else 2 * 4 * b * kvh * got * sk * 128)
    if shape == (2, 1024, 2, 16):
        assert nbytes == 33554432


def _live_rows(sq, sk, causal, window, q_offset):
    q_pos = q_offset + np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= (q_pos - k_pos) < window
    return ok.any(axis=1)


# (b, sq, sk, h, kvh, d, splits, causal, window, softcap, q_offset)
SPLIT_CASES = {
    "rep 4 in 2 shares, causal": (2, 20, 20, 8, 2, 16, 2, True, None, 0.0, 0),
    "rep 4 in 2 shares, window 6, q_offset 5": (1, 16, 24, 8, 2, 16, 2, True, 6, 0.0, 5),
    "rep 4 in 2 shares, softcap 50, d 80": (2, 18, 18, 8, 2, 80, 2, True, None, 50.0, 0),
    "rep 4 in 4 shares, q_offset 10, not causal": (1, 12, 22, 4, 1, 16, 4, False, None, 0.0, 10),
    "rep 1, causal, d 64": (2, 20, 20, 4, 4, 64, 1, True, None, 0.0, 0),
    "rep 1, window 4, dead rows": (1, 16, 10, 2, 2, 16, 1, False, 4, 0.0, 8),
}


@pytest.mark.parametrize("dtype", [pytest.param(torch.float32, id="float32"),
                                   pytest.param(torch.bfloat16, id="bfloat16")])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_order_matches_jax(name, dtype):
    b, sq, sk, h, kvh, d, splits, causal, window, softcap, q_offset = SPLIT_CASES[name]
    rng = np.random.default_rng(7)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # inputs exact in both dtypes: bf16 values
    rnd = lambda *s: np.asarray(jnp.asarray(rng.normal(size=s), jnp.bfloat16), np.float32)
    q = rnd(b, sq, h, d) * (8.0 if softcap else 1.0)
    k, v = rnd(b, sk, kvh, d), rnd(b, sk, kvh, d)
    live = _live_rows(sq, sk, causal, window, q_offset)
    do = rnd(b, sq, h, d) * live[None, :, None, None]
    opts = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)

    def f(q_, k_, v_):
        return jops.flash_attention_jnp(q_, k_, v_, block_k=BLOCK_K, **opts)

    _, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]

    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o, lse = ref.attention_lse(tq, tk, tv, **opts)
    got = ref.flash_attention_bwd_splits(tq, tk, tv, o, lse, tdo, splits=splits, **opts)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        g = g.float().numpy()
        if g.shape[1] == sq:
            g, w = g[:, live], w[:, live]
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), np.abs(g - w).max()
    # one share is the plain backward itself, bit for bit
    if splits > 1:
        one = ref.flash_attention_bwd_splits(tq, tk, tv, o, lse, tdo, splits=1, **opts)
        plain = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **opts)
        assert all(torch.equal(a, c) for a, c in zip(one, plain))


def test_split_order_refuses_a_share_that_does_not_divide_the_group():
    q = torch.zeros(1, 4, 6, 16)
    k = torch.zeros(1, 4, 2, 16)
    o, lse = ref.attention_lse(q, k, k)
    with pytest.raises(ValueError):
        ref.flash_attention_bwd_splits(q, k, k, o, lse, q, splits=2)


# ---------------------------------------------------------------------------
# rmsnorm_bwd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D, rows, want", [
    (768, 4096, ("vec", 64, 2, 4, 264)),      # mamba2-130m at its microbatch
    (2560, 2048, ("vec", 256, 2, 1, 264)),    # zamba2-2.7b
    (4096, 4096, ("vec", 256, 2, 1, 264)),    # glm4-9b
    (5120, 2048, ("vec", 256, 4, 1, 264)),    # zamba2's gated norm
    (4096, 8, ("vec", 256, 2, 1, 8)),         # a decode step's rows
    (100, 600, ("scalar", 0, 0, 1, 264)),     # D not a multiple of 8
    (16384, 40, ("scalar", 0, 0, 1, 40)),     # more than 4 vectors a thread
])
def test_rmsnorm_bwd_plan(D, rows, want):
    p = rb.plan(D, rows, 2)
    assert (p.path, p.tpr, p.vecs, p.slots, p.blocks) == want
    if p.path == "vec":
        n = D // 8
        assert p.tpr * p.slots == rb.THREADS and -(-n // p.tpr) <= p.vecs <= rb.MAX_VECS
        # the slots' partials fit the block's buffer (csrc kSlotFloats)
        assert p.slots == 1 or p.slots * D <= 2 * rb.THREADS * 8


def test_rmsnorm_bwd_plan_scalar_when_unaligned_or_float32_wide():
    assert rb.plan(4096, 64, 2, aligned=False).path == "scalar"
    assert rb.plan(4096, 64, 4).vecs == 4          # float32: 1024 vectors of 4
    assert rb.plan(8192, 64, 4).path == "scalar"   # 2048 vectors of 4


def test_rmsnorm_bwd_plan_matches_the_source():
    assert f"kMaxVecs = {rb.MAX_VECS};" in RMS_SRC
    assert "kSlotFloats = 2 * rt::kThreads * 8;" in RMS_SRC
    assert "p < blocks; p += kWarps" in RMS_SRC and rb.SUM_WARPS == 256 // 32


@pytest.mark.parametrize("shape, blocks, slots", [
    ((37, 48), 5, 2), ((3, 7, 64), 4, 1), ((40, 32), 40, 1), ((9, 16), 2, 4),
])
def test_rmsnorm_bwd_partials_match_jax_grad(shape, blocks, slots):
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_: jref.rmsnorm(x_, w_, 1e-5), jnp.asarray(x), jnp.asarray(w))
    _, jdw = vjp(jnp.asarray(dy))
    parts = ref.rmsnorm_bwd_partials(*map(torch.from_numpy, (x, w)), 1e-5,
                                     torch.from_numpy(dy), blocks, slots)
    assert parts.shape == (blocks, shape[-1])
    dw = ref.rmsnorm_bwd_dw_sum(parts, rb.SUM_WARPS).numpy()
    jdw = np.asarray(jdw)
    assert np.abs(dw - jdw).max() <= 1e-5 * np.abs(jdw).max()
    # every row counted once: the partials add up to the plain dw
    plain = ref.rmsnorm_bwd(*map(torch.from_numpy, (x, w)), 1e-5, torch.from_numpy(dy))[1]
    assert torch.allclose(parts.sum(0), plain, rtol=0, atol=1e-5 * float(plain.abs().max()))


@pytest.mark.parametrize("name, source", [
    ("rt_flash_attention_bwd_tc", "flash_attention_bwd.cu"),
    ("rt_flash_attention_bwd", "flash_attention_bwd.cu"),
    ("rt_rmsnorm_bwd", "rmsnorm_bwd.cu"),
])
def test_ctypes_signatures_match_the_entry_points(name, source):
    """The argument types _build binds (pointers, 32-bit ints, 64-bit ints,
    floats) are the C entry point's, in order: a mismatch would pass
    garbage to the kernel without an error."""
    text = (_build.CSRC / source).read_text()
    decl = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text, re.S).group(1)
    kinds = []
    for arg in decl.split(","):
        arg = arg.strip()
        kinds.append("p" if "*" in arg else "ll" if arg.startswith("long long")
                     else "f" if arg.startswith("float") else "i")
    want = {_build._P: "p", _build._I: "i", _build._LL: "ll", _build._F: "f"}
    assert kinds == [want[t] for t in _build.SIGNATURES[name]]
    if name == "rt_flash_attention_bwd_tc":
        assert fb.TIE == 2.0 ** -24 and kinds[-2:] == ["f", "p"]
