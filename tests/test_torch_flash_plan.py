"""The flash_attention wrapper's planning, on the CPU: which kernel each
dtype takes, the tile of the bf16 tensor-core kernel per head dim and its
shared-memory budget, the raise on a bf16 head dim the kernel is not built
for, and that the plan agrees with what ``csrc/flash_attention.cu`` builds.
The plain version at the bf16 kernel's head dims is held against the
Pallas kernel (interpret mode, as the JAX suite runs it on the CPU) with
numpy inputs from a fixed seed; tolerances as in ``test_torch_dense.py``:
5e-5 in float32, 2e-2 in bf16 (both round the output to bf16).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa_mod

SRC = (_build.CSRC / "flash_attention.cu").read_text()


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("rep", [1, 3, 16, 32, 128])
def test_bf16_takes_a_tensor_core_kernel_at_its_head_dims(d, rep):
    p = fa_mod.plan(torch.bfloat16, d, rep)
    assert p.kernel == ("wgmma" if d == 128 else "mma") and p.positions == 0
    assert (p.kernel, p.block_k, p.rows, p.stages, p.layout) == fa_mod.BF16_TILES[d]
    assert p.block_k % 16 == 0 and p.rows % 64 == 0 and p.stages >= 2
    # Q tile plus a K and a V tile per ring stage, all bf16 (+1 KB to align
    # wgmma's swizzle blocks); rows padded to d + 8 where d/8 chunks are not
    # a power of two (Padded<80>); independent of rep
    pad = 1024 if p.kernel == "wgmma" else 0
    chunks = d // 8
    assert p.layout == ("swizzle" if chunks & (chunks - 1) == 0 else "padded")
    stride = d + 8 if d == 80 else d
    assert fa_mod.row_stride(p.layout, d) == stride
    assert p.smem_bytes == 2 * (p.rows * stride + p.stages * 2 * p.block_k * stride) + pad
    assert p.smem_bytes <= _build.SMEM_LIMIT


def test_bf16_tiles_per_head_dim():
    assert fa_mod.BF16_HEAD_DIMS == (16, 64, 80, 128, 256)
    assert fa_mod.BF16_TILES == {16: ("mma", 64, 64, 3, "swizzle"),
                                 64: ("mma", 32, 64, 3, "swizzle"),
                                 80: ("mma", 32, 64, 3, "padded"),
                                 128: ("wgmma", 32, 128, 3, "swizzle"),
                                 256: ("mma", 32, 64, 2, "swizzle")}
    # d 80 (zamba2): Padded<80> rows of 88 elements, 45056 bytes
    assert fa_mod.plan(torch.bfloat16, 80, 1).smem_bytes == 2 * (64 + 3 * 2 * 32) * 88 == 45056
    # d 128: two warpgroups of 64 rows, 32-key tiles; two blocks fit an SM
    assert fa_mod.plan(torch.bfloat16, 128, 16).smem_bytes == 82944 <= _build.SMEM_LIMIT // 2
    # d 256: a two-stage ring, 16-row fragments of 128 accumulator registers a lane
    assert fa_mod.plan(torch.bfloat16, 256, 16).smem_bytes == 98304


@pytest.mark.parametrize("d", [8, 32, 48, 96, 512])
def test_bf16_raises_at_a_head_dim_it_is_not_built_for(d):
    with pytest.raises(ValueError,
                       match=r"head dim %d not supported.*\(16, 64, 80, 128, 256\)" % d):
        fa_mod.plan(torch.bfloat16, d, 16)


@pytest.mark.parametrize("rep, positions", [(1, 64), (2, 32), (16, 4), (32, 2), (64, 1), (100, 1)])
def test_float32_takes_the_cuda_core_tile(rep, positions):
    p = fa_mod.plan(torch.float32, 128, rep)
    assert p.kernel == "f32" and p.positions == positions and p.rows == positions * rep
    assert p.block_k == fa_mod.BLOCK_K
    assert p.smem_bytes == 4 * _build.tile_floats(p.rows, p.block_k, 128)


def test_float32_tile_too_large_raises_where_bf16_runs():
    """128 query heads on one kv head at d 256: the float32 tile holds the
    whole group and does not fit a block; the bf16 kernel spans the group
    over two tiles of 64 rows."""
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        fa_mod.plan(torch.float32, 256, 128)
    assert fa_mod.plan(torch.bfloat16, 256, 128).smem_bytes <= _build.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="not supported"):
        fa_mod.plan(dtype, 128, 16)


def test_plan_matches_the_kernel_source():
    """Every tile the wrapper plans is instantiated in the source, d 128 on
    wgmma (64 rows a warpgroup), the others on mma.sync (four warps of 16
    rows), and the kernel names keep the profile's class key."""
    built = {128: ("wgmma", int(bk), 64 * int(wg), int(st), "swizzle")
             for bk, st, wg in re.findall(r"RT_FLASH_WGMMA\((\d+), (\d+), (\d+)\)\n", SRC)}
    built.update({int(d): ("mma", int(bk), 64, int(st), lay.lower()) for d, bk, st, lay in
                  re.findall(r"RT_FLASH_MMA\((\d+), (\d+), (\d+), (Swizzle|Padded)\)\n", SRC)})
    assert fa_mod.BF16_TILES == built
    assert "if (d == 128 && block_k == BK" in SRC
    assert re.search(r"constexpr int kMmaWarps = 4;", SRC)
    # the mma.sync kernel takes the tile layout each instance names, whose
    # stride the smem reckoning counts
    assert "flash_attention_kernel_bf16<D, BK, ST, rt::mma::LAY<D>>" in SRC
    assert "bf16_smem_bytes(rt::mma::LAY<D>::kStride" in SRC
    for name in ("flash_attention_kernel_bf16_wgmma", "flash_attention_kernel_bf16",
                 "flash_attention_kernel("):
        assert name in SRC   # "flash_attention_kernel", the profile's class key, is in each


@pytest.mark.parametrize("d", [32, 96])
def test_cpu_tensor_runs_the_plain_version_at_any_head_dim(d):
    """The head-dim limit is the kernel's: a CPU tensor never plans a launch."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in [(1, 9, 4, d), (1, 9, 2, d), (1, 9, 2, d)])
    before = fa_mod.launches
    torch.testing.assert_close(fa_mod.flash_attention(q, k, v), ref.attention(q, k, v),
                               rtol=0, atol=0)
    assert fa_mod.launches == before


CASES = [
    # b, sq, sk, h, kvh, d, opts
    (1, 20, 20, 8, 2, 64, {}),
    (1, 12, 28, 4, 1, 128, {"q_offset": 16}),
    (1, 16, 16, 2, 2, 256, {"window": 5}),
    (2, 10, 10, 6, 2, 16, {"softcap": 4.0}),
    (1, 24, 24, 4, 4, 80, {}),                    # zamba2's head dim
    (1, 10, 30, 4, 4, 80, {"q_offset": 20}),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_at_the_bf16_head_dims(case, dtype):
    b, sq, sk, h, kvh, d, opts = case
    rng = np.random.default_rng(sq * d + h)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in [(b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)]]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(pallas_flash(*(jnp.asarray(a, jdt) for a in arrs), **opts, block_q=16,
                                   block_k=16, interpret=True).astype(jnp.float32))
    got = fa_mod.flash_attention(*(torch.from_numpy(a).to(dtype) for a in arrs), **opts)
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
