"""ssd's planning, on the CPU: which kernel each dtype, p, n and chunk take
(``kernels/ssd.py`` ``plan``), the head group and the blocks of each launch
(at least one per SM of the card at a batch-1 admission), the workspace
bytes and each launch's shared memory, and that the plan agrees with what
``csrc/ssd_tc.cu`` builds.  A CPU tensor takes the plain ``ref.ssd`` at any
width.  The plain three-phase decomposition (``ref.ssd_chunk_phases``:
chunk states, state pass, output) matches ``ref.ssd``, the JAX
``ssd_chunked_jnp`` and ``repro.kernels.ref.ssd`` on seeded numpy inputs at
ragged lengths and with an initial state (f32 tolerance 5e-4, the JAX
suite's own between its chunked scan and the sequential recurrence).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ssd as ssd_mod

SRC = (_build.CSRC / "ssd_tc.cu").read_text()
TOL = dict(rtol=5e-4, atol=5e-4)
SM_COUNT = 132                      # H100 SXM
ADMISSION = (1, 996)                # a batch-1 admission of the continuous engine
STATIC = (8, 881)                   # the static serve pass

# (p, n, chunk) of every SSM model of the zoo, at full width and reduced
ZOO = sorted({(c.ssm_head_dim, c.ssm_state, c.ssm_chunk)
              for a in list_archs() for c in (get_config(a), get_config(a, reduced=True))
              if c.ssm_state})


@pytest.mark.parametrize("chunk", ssd_mod.TC_CHUNKS)
@pytest.mark.parametrize("p, n", [(16, 16), (64, 128), (64, 64), (32, 48), (128, 128)])
def test_bf16_at_multiples_of_16_takes_the_tensor_cores(p, n, chunk):
    pl = ssd_mod.plan(torch.bfloat16, p, n, chunk)
    assert pl.kernel == "mma" and pl.head_group == ssd_mod.HEAD_GROUP
    assert pl.smem_bytes == ssd_mod.tc_smem_bytes(p, n, chunk)
    assert max(pl.smem_bytes) <= _build.SMEM_LIMIT


@pytest.mark.parametrize("p, n, chunk", [
    (8, 16, 64),        # p not a multiple of 16
    (64, 24, 64),       # n not a multiple of 16
    (64, 128, 8),       # chunk outside the instances
    (64, 128, 128),
    (16, 16, 48),
])
def test_bf16_off_the_route_keeps_the_cuda_core_kernel(p, n, chunk):
    pl = ssd_mod.plan(torch.bfloat16, p, n, chunk)
    assert (pl.kernel, pl.head_group) == ("f32", 1)
    assert pl.smem_bytes == (ssd_mod.smem_bytes(p, n, chunk),)


@pytest.mark.parametrize("p, n, chunk", [(64, 128, 64), (64, 64, 64), (16, 16, 8)])
def test_float32_takes_the_cuda_core_kernel(p, n, chunk):
    assert ssd_mod.plan(torch.float32, p, n, chunk).kernel == "f32"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="not supported"):
        ssd_mod.plan(dtype, 64, 128, 64)


def test_tensor_core_blocks_too_large_raise():
    """The route depends on dtype, p, n and chunk only; where its blocks do
    not fit the card it raises, it does not take the other kernel."""
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        ssd_mod.plan(torch.bfloat16, 256, 256, 64)


@pytest.mark.parametrize("p, n, chunk", ZOO)
def test_the_zoo_plans_within_the_card(p, n, chunk):
    for dtype in (torch.bfloat16, torch.float32):
        assert max(ssd_mod.plan(dtype, p, n, chunk).smem_bytes) <= _build.SMEM_LIMIT


def test_mamba2_and_zamba2_widths_take_the_tensor_cores():
    """mamba2-130m (p 64, n 128, chunk 64) and zamba2's later widths (p 64,
    n 64, chunk 64); two blocks of the output launch fit one SM."""
    for p, n in ((64, 128), (64, 64)):
        pl = ssd_mod.plan(torch.bfloat16, p, n, 64)
        assert pl.kernel == "mma"
        assert 2 * (pl.smem_bytes[2] + 1024) <= 228 * 1024
    assert ssd_mod.plan(torch.bfloat16, 64, 128, 64).smem_bytes == (36352, 0, 79872)


@pytest.mark.parametrize("h", [24, 23, 1, 32])
def test_head_group_and_blocks(h):
    """Launches 1 and 3: a block per (row, chunk, group of HEAD_GROUP heads),
    the last group partial where HEAD_GROUP does not divide h; launch 2: a
    block per (slice of 1024 state elements, head, row)."""
    p, n, chunk = 64, 128, 64
    pl = ssd_mod.plan(torch.bfloat16, p, n, chunk)
    b, s = ADMISSION
    nc = -(-s // chunk)
    groups = -(-h // pl.head_group)
    assert (groups - 1) * pl.head_group < h <= groups * pl.head_group
    chunk_blocks, pass_blocks, out_blocks = ssd_mod.blocks(pl, b, s, h, p, n, chunk)
    assert chunk_blocks == out_blocks == b * nc * groups
    assert pass_blocks == (p * n // (ssd_mod.PASS_VEC * ssd_mod.THREADS)) * h * b


def test_admission_fills_the_card():
    """At the batch-1 admission (1, 996: 16 chunks, 24 heads) launches 1 and
    3 give at least one block per SM, where ssd.cu ran 24; the static pass
    gives several waves."""
    pl = ssd_mod.plan(torch.bfloat16, 64, 128, 64)
    got = ssd_mod.blocks(pl, *ADMISSION, 24, 64, 128, 64)
    assert got == (192, 192, 192) and min(got) >= SM_COUNT
    assert ssd_mod.blocks(pl, *STATIC, 24, 64, 128, 64) == (1344, 1536, 1344)
    assert ssd_mod.blocks(ssd_mod.plan(torch.float32, 64, 128, 64), *ADMISSION, 24, 64, 128,
                          64) == (24,)


def test_workspace_bytes():
    """float32 cum (b, s, h) and chunk states (b, nc, h, p, n): ~88 MB of
    chunk states at the static pass, ~12.6 MB at the admission; none for
    ssd.cu."""
    pl = ssd_mod.plan(torch.bfloat16, 64, 128, 64)
    assert ssd_mod.workspace_bytes(pl, *STATIC, 24, 64, 128, 64) == \
        4 * (8 * 881 * 24 + 8 * 14 * 24 * 64 * 128)
    states = 4 * 16 * 24 * 64 * 128
    assert states == 12582912
    assert ssd_mod.workspace_bytes(pl, *ADMISSION, 24, 64, 128, 64) == states + 4 * 996 * 24
    f32 = ssd_mod.plan(torch.float32, 64, 128, 64)
    assert ssd_mod.workspace_bytes(f32, *STATIC, 24, 64, 128, 64) == 0


def _c_expr(name):
    """The return expression of a size function of csrc/ssd_tc.cu, as Python."""
    body = re.search(r"inline size_t %s\(int Q, int p, int n\) \{\s*return (.*?);" % name, SRC,
                     re.S).group(1)
    body = " ".join(body.split())
    return re.sub(r"\(size_t\)", "", re.sub(r"pad_row\((\w)\)", r"(\1 + 8)", body))


@pytest.mark.parametrize("p, n", [(64, 128), (64, 64), (16, 32), (128, 48)])
@pytest.mark.parametrize("chunk", ssd_mod.TC_CHUNKS)
def test_plan_matches_the_kernel_source(p, n, chunk):
    """The chunks the plan sends to the tensor cores are the RT_SSD_TC
    instances, the constants agree, each launch's shared memory is the
    source's own formula, and the three kernel names keep the profile's
    class key ``ssd_kernel``."""
    assert tuple(int(q) for q in re.findall(r"RT_SSD_TC\((\d+)\)\n", SRC)) == ssd_mod.TC_CHUNKS
    assert re.search(r"constexpr int kHeadGroup = %d;" % ssd_mod.HEAD_GROUP, SRC)
    assert re.search(r"constexpr int kPassVec = %d;" % ssd_mod.PASS_VEC, SRC)
    env = dict(Q=chunk, p=p, n=n, kHeadGroup=ssd_mod.HEAD_GROUP)
    state, _, out = ssd_mod.tc_smem_bytes(p, n, chunk)
    assert eval(_c_expr("state_smem"), {}, env) == state
    assert eval(_c_expr("out_smem"), {}, env) == out
    for name in ("ssd_kernel_chunk_state", "ssd_kernel_state_pass", "ssd_kernel_chunk_out"):
        assert f"\n{name}(" in SRC
    assert "ssd_tc.cu" in _build.SOURCES and "mma.cuh" in _build.HEADERS
    assert "rt_ssd_tc" in _build.SIGNATURES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p, n, chunk", [(64, 128, 64), (16, 32, 16), (8, 16, 64)])
def test_cpu_tensor_runs_the_plain_version(dtype, p, n, chunk):
    """The kernel choice is the card's: a CPU tensor never plans a launch."""
    rng = np.random.default_rng(p + n)
    b, s, h = 2, 37, 3
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    x, B, C = f(b, s, h, p).to(dtype), f(b, s, n).to(dtype), f(b, s, n).to(dtype)
    dt = torch.from_numpy(rng.uniform(1e-3, 1e-1, (b, s, h)).astype(np.float32))
    A = -torch.arange(1, h + 1, dtype=torch.float32)
    before = ssd_mod.launches
    got = ssd_mod.ssd(x, dt, A, B, C, chunk=chunk, return_state=True)
    want = ref.ssd(x, dt, A, B, C, return_state=True)
    assert ssd_mod.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the plain three-phase decomposition
# ---------------------------------------------------------------------------
PHASE_SHAPES = [
    # b, s, h, p, n, chunk
    (1, 11, 2, 4, 8, 8),        # a partial trailing chunk of 3
    (2, 40, 4, 8, 16, 16),      # 40 = 2 x 16 + 8
    (1, 70, 3, 16, 32, 64),     # 70 = 64 + 6
    (2, 64, 3, 16, 16, 32),     # two whole chunks
    (1, 20, 2, 16, 16, 64),     # s < chunk: one partial chunk
]


def _inputs(b, s, h, p, n, seed, init):
    """numpy x, dt, A, B, C (and an initial state) in the JAX suite's
    ranges: dt in [0.01, 0.2], A in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, B, C = f(b, s, h, p), f(b, s, n), f(b, s, n)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    return x, dt, A, B, C, (f(b, h, p, n) if init else None)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", PHASE_SHAPES)
def test_three_phases_match_the_recurrence_and_jax(shape, init):
    b, s, h, p, n, chunk = shape
    arrays = _inputs(b, s, h, p, n, 3 * s + h, init)
    t = [None if a is None else torch.from_numpy(a) for a in arrays]
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    y, sf = ref.ssd_chunk_phases(*t[:5], chunk=chunk, initial_state=t[5], return_state=True)
    assert y.shape == (b, s, h, p) and sf.shape == (b, h, p, n)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sf).all())
    wants = [ref.ssd(*t[:5], initial_state=t[5], return_state=True),
             jref.ssd(*j[:5], initial_state=j[5], return_state=True),
             jops.ssd_chunked_jnp(*j[:5], chunk=chunk, initial_state=j[5], return_state=True)]
    for want_y, want_s in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y, np.float32), **TOL)
        np.testing.assert_allclose(sf.numpy(), np.asarray(want_s, np.float32), **TOL)
    only_y = ref.ssd_chunk_phases(*t[:5], chunk=chunk, initial_state=t[5])
    assert torch.equal(only_y, y)


def test_three_phases_in_bf16_round_once():
    """bf16 inputs: every phase runs in float32 and y is rounded to bf16
    once, so it equals the float32 phases' y rounded."""
    b, s, h, p, n, chunk = 1, 50, 2, 16, 16, 16
    x, dt, A, B, C, s0 = (None if a is None else torch.from_numpy(a)
                          for a in _inputs(b, s, h, p, n, 5, True))
    xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
    got = ref.ssd_chunk_phases(xb, dt, A, Bb, Cb, chunk=chunk, initial_state=s0)
    want = ref.ssd_chunk_phases(xb.float(), dt, A, Bb.float(), Cb.float(), chunk=chunk,
                                initial_state=s0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())
