"""varlen_prefill's planning, on the CPU: which kernel each dtype, head dim,
rep and page size take (``kernels/varlen_prefill.py`` ``plan``), the rows a
block owns and the blocks a packed page spreads over, the shared-memory
budget with and without an int8/fp8 pool, and that the plan agrees with what
``csrc/varlen_prefill_tc.cuh`` builds.  A CPU tensor takes the plain version
at any head dim.  The plain version of a prompt split at a page boundary
(its first part committed to the pool) equals the whole prompt within f32
rounding, and matches the Pallas kernel in interpret mode on seeded numpy
inputs (f32 tolerance 5e-5, the JAX suite's own).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.kernels.varlen_prefill import varlen_prefill as pallas_varlen
from repro_torch.kernels import _build, ref
from repro_torch.kernels import varlen_prefill as vp_mod

SRC = (_build.CSRC / "varlen_prefill_tc.cuh").read_text()
TOL = dict(rtol=5e-5, atol=5e-5)

# (rep, head dim) of every attention model of the zoo at full width
ZOO = sorted({(c.num_heads // c.num_kv_heads, c.resolved_head_dim)
              for c in (get_config(a) for a in list_archs()) if c.num_heads})


@pytest.mark.parametrize("d", vp_mod.BF16_HEAD_DIMS)
@pytest.mark.parametrize("page_size", [8, 12, 16, 32])
@pytest.mark.parametrize("quantized", [False, True])
def test_bf16_takes_a_tensor_core_kernel(d, page_size, quantized):
    p = vp_mod.plan(torch.bfloat16, d, 16, page_size, quantized=quantized)
    kernel, bk, stages = vp_mod.BF16_TILES[d]
    assert p.kernel == kernel == ("wgmma" if d == 128 else "mma")
    assert (p.block_k, p.stages) == (bk, stages) == (32, 3 if d <= 128 else 2)
    assert p.smem_bytes == vp_mod.bf16_smem_bytes(kernel, d, p.rows, p.stages, quantized)
    assert p.smem_bytes <= _build.SMEM_LIMIT


@pytest.mark.parametrize("rep, d", ZOO)
@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_rows_per_page_and_blocks_per_page(rep, d, page_size):
    """A block owns a fixed run of rows of one packed page: 128 on wgmma, up
    to four warps of 16 on mma.sync (fewer where a page has fewer rows);
    the page's page_size * rep rows spread over whole blocks, the last one
    possibly partial."""
    p = vp_mod.plan(torch.bfloat16, d, rep, page_size)
    rows = page_size * rep
    assert p.rows_per_page == rows
    if p.kernel == "wgmma":
        assert p.rows == vp_mod.WGMMA_ROWS
    elif p.kernel == "mma":
        assert p.rows % 16 == 0 and 16 <= p.rows <= 16 * vp_mod.MMA_MAX_WARPS
        assert p.rows == 16 * min(vp_mod.MMA_MAX_WARPS, -(-rows // 16))
    assert p.blocks_per_page == -(-rows // p.rows)
    assert (p.blocks_per_page - 1) * p.rows < rows <= p.blocks_per_page * p.rows


def test_rows_of_the_serve_shapes():
    """glm4-9b (rep 16, page 16): two blocks of 128 a page on wgmma;
    granite-20b's rep 48: six exactly, and at page 12 four and a half (the
    last block partial); whisper's d 64 at rep 1: one block of 16 rows."""
    p = vp_mod.plan(torch.bfloat16, 128, 16, 16)
    assert (p.kernel, p.rows, p.rows_per_page, p.blocks_per_page) == ("wgmma", 128, 256, 2)
    assert p.smem_bytes == 82944 and vp_mod.plan(torch.bfloat16, 128, 16, 16,
                                                 quantized=True).smem_bytes == 108288
    assert vp_mod.plan(torch.bfloat16, 128, 48, 16).blocks_per_page == 6
    p = vp_mod.plan(torch.bfloat16, 128, 48, 12)
    assert p.blocks_per_page == 5 and p.rows_per_page == 576
    assert (vp_mod.plan(torch.bfloat16, 64, 1, 16).rows,
            vp_mod.plan(torch.bfloat16, 64, 1, 16).blocks_per_page) == (16, 1)


@pytest.mark.parametrize("d", [8, 24, 72, 100, 264, 512])
def test_bf16_at_another_head_dim_keeps_the_cuda_core_kernel(d):
    """No head dim that served before the tensor-core routine raises now:
    bf16 off the routine's head dims runs the fp32 CUDA-core tile, one block
    per (page, query head), while it fits a block."""
    p = vp_mod.plan(torch.bfloat16, d, 16, 8)
    assert (p.kernel, p.rows, p.block_k, p.stages, p.blocks_per_page) == ("f32", 8, 8, 1, 16)
    assert p.smem_bytes == 4 * _build.tile_floats(8, 8, d) <= _build.SMEM_LIMIT


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_float32_takes_the_cuda_core_kernel(d):
    p = vp_mod.plan(torch.float32, d, 16, 16)
    assert (p.kernel, p.rows, p.block_k, p.stages) == ("f32", 16, 16, 1)
    assert p.smem_bytes == 4 * _build.tile_floats(16, 16, d)


def test_float32_tile_too_large_raises():
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        vp_mod.plan(torch.float32, 256, 16, 128)
    assert vp_mod.plan(torch.bfloat16, 256, 16, 128).smem_bytes <= _build.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="not supported"):
        vp_mod.plan(dtype, 128, 16, 16)


def test_plan_matches_the_kernel_source():
    """Every head dim the plan sends to mma.sync is an RT_VARLEN instance with
    its tile and ring, d 128 the wgmma kernel, the constants agree, and the
    kernel names keep the profile's class key."""
    built = {int(d): ("mma", int(bk), int(st))
             for d, bk, st in re.findall(r"RT_VARLEN\((\d+), (\d+), (\d+)\)\n", SRC)}
    assert "if (d == 128) {" in SRC and "stages != 3" in SRC and "stages != ST" in SRC
    built[128] = ("wgmma", 32, 3)
    assert built == vp_mod.BF16_TILES
    assert re.search(r"constexpr int kBK = %d;" % vp_mod.BLOCK_K, SRC)
    assert re.search(r"constexpr int kWgRows = %d;" % vp_mod.WGMMA_ROWS, SRC)
    assert re.search(r"constexpr int kMmaMaxWarps = %d;" % vp_mod.MMA_MAX_WARPS, SRC)
    for name in ("varlen_prefill_kernel_wgmma", "varlen_prefill_kernel_mma",
                 "varlen_prefill_kernel_order"):
        assert name in SRC          # "varlen_prefill_kernel", the profile's class key
    for src in ("varlen_prefill_bf16.cu", "varlen_prefill_quant.cu"):
        assert src in _build.SOURCES
    for header in ("flash_tile.cuh", "varlen_prefill_tc.cuh"):
        assert header in _build.HEADERS


# ---------------------------------------------------------------------------
# the plain version: CPU tensors, split prompts, Pallas
# ---------------------------------------------------------------------------
def _prompt(n, h, kvh, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(n, c, d)).astype(np.float32)).to(dtype)
            for c in (h, kvh, kvh)]


def _run(q, k, v, start, kp, vp, table, ps, **opts):
    """One chunk (q, k, v) at absolute position `start` in a packed buffer
    with a page of pad rows, over the pool's context pages in `table`."""
    n = q.shape[0]
    T = -(-n // ps) * ps + ps
    pad = lambda t: torch.cat([t, torch.full((T - n, *t.shape[1:]), 7.0, dtype=t.dtype)])
    meta = [torch.tensor(a, dtype=torch.int32) for a in ([0, T - ps], [n], [start])]
    return vp_mod.varlen_prefill(pad(q), pad(k), pad(v), kp, vp, *meta, table, **opts)


@pytest.mark.parametrize("d", [24, 72, 128])
def test_cpu_tensor_runs_the_plain_version_at_any_head_dim(d):
    """The head-dim choice is the kernels': a CPU tensor never plans a launch."""
    ps, n = 4, 10
    q, k, v = (torch.cat([t, torch.full((6, *t.shape[1:]), 7.0)]).to(torch.bfloat16)
               for t in _prompt(n, 4, 2, d, d))
    kp = torch.zeros((4, ps, 2, d), dtype=torch.bfloat16)
    args = (q, k, v, kp, kp, *(torch.tensor(a, dtype=torch.int32) for a in ([0, 12], [n], [4])),
            torch.arange(1, 4, dtype=torch.int32).view(1, 3))
    before = vp_mod.launches
    torch.testing.assert_close(vp_mod.varlen_prefill(*args), ref.varlen_prefill(*args),
                               rtol=0, atol=0)
    assert vp_mod.launches == before


SPLITS = [
    # h, kvh, d, page_size, prompt length, split (a page boundary), opts
    (8, 2, 16, 8, 45, 24, {}),
    (4, 1, 32, 4, 30, 12, {"window": 7}),
    (6, 2, 16, 8, 40, 16, {"softcap": 5.0}),
]


@pytest.mark.parametrize("case", SPLITS)
def test_plain_split_prompt_equals_the_whole(case):
    """The rows of a prompt's second part, prefilled over its first part's
    context pages, equal the whole prompt's rows within f32 rounding (the
    two sum over the same keys in another grouping)."""
    h, kvh, d, ps, n, cut, opts = case
    q, k, v = _prompt(n, h, kvh, d, n + d)
    pages = -(-n // ps)
    kp = torch.zeros((pages + 1, ps, kvh, d))
    vp = torch.zeros_like(kp)
    kp.view(-1, kvh, d)[ps:ps + n] = k
    vp.view(-1, kvh, d)[ps:ps + n] = v
    table = torch.arange(1, pages + 1, dtype=torch.int32).view(1, pages)
    whole = _run(q, k, v, 0, kp, vp, table, ps, **opts)[:n]
    split = _run(q[cut:], k[cut:], v[cut:], cut, kp, vp, table, ps, **opts)[:n - cut]
    torch.testing.assert_close(split, whole[cut:], rtol=2e-6, atol=2e-6)
    assert bool((whole[:n] != 0).all(dim=-1).any())


@pytest.mark.parametrize("case", SPLITS)
def test_plain_split_prompt_matches_pallas(case):
    """The split chunk through the plain version and through the Pallas
    kernel in interpret mode (seeded numpy inputs)."""
    h, kvh, d, ps, n, cut, opts = case
    rng = np.random.default_rng(3 * n + d)
    pages = -(-n // ps)
    m = n - cut
    T = -(-m // ps) * ps + ps
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            [(T, h, d), (T, kvh, d), (T, kvh, d), (pages + 1, ps, kvh, d), (pages + 1, ps, kvh, d)]]
    meta = [np.array(a, np.int32) for a in ([0, T - ps], [m], [cut])]
    table = np.arange(1, pages + 1, dtype=np.int32).reshape(1, pages)
    want = pallas_varlen(*map(jnp.asarray, (*arrs, *meta, table)), interpret=True, **opts)
    got = vp_mod.varlen_prefill(*map(torch.from_numpy, (*arrs, *meta, table)), **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL)
