"""The decode family's planning, on the CPU: which kernel each dtype takes
(``kernels/decode_split.py`` ``plan``), the bf16 split-KV routine's splits,
row tiles and shared-memory budget at every head dim, page size and
(rep, W) the zoo reaches, the raise at a bf16 head dim or page size it
does not take, the float32 tile's row chunks, and that the plan agrees with
what ``csrc/decode_split.cuh`` builds.  ``decode_attention``'s view of a
dense cache as a pool, run through the plain ``paged_attention``, equals
the plain ``decode_attention`` and, on seeded numpy inputs, the Pallas
kernel in interpret mode (tolerances as in ``test_torch_dense.py``: 5e-5 in
float32, 2e-2 in bf16).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import _build, ref
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import decode_split as ds
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels import spec_verify as sv_mod

SRC = (_build.CSRC / "decode_split.cuh").read_text()

# (rep, head dim) of every attention model of the zoo at full width
ZOO = sorted({(c.num_heads // c.num_kv_heads, c.resolved_head_dim)
              for c in (get_config(a) for a in list_archs()) if c.num_heads})
# windows of spec_k + 1 queries: plain decode up to spec_k 12
WINDOWS = list(range(1, 14))


def test_zoo_reaches_the_shapes_the_plan_was_sized_for():
    assert (16, 128) in ZOO and (48, 128) in ZOO and (1, 64) in ZOO and (1, 80) in ZOO
    assert all(d % 16 == 0 and 16 <= d <= 256 for _, d in ZOO)


@pytest.mark.parametrize("d", ds.BF16_HEAD_DIMS)
@pytest.mark.parametrize("page_size", [8, 16, 24, 32, 128])
def test_bf16_takes_the_tensor_core_routine(d, page_size):
    p = ds.plan(torch.bfloat16, d, 16, 1, page_size)
    assert p.kernel == "mma" and (p.block_k, p.stages) == ds.BF16_TILES[d]
    assert p.block_k == (32 if d <= 128 else 16) and p.stages == 2
    # a split is a whole number of pages and of key chunks, at least 64 keys,
    # and no larger than it must be
    sk = p.split_keys
    assert sk % page_size == 0 and sk % p.block_k == 0 and sk >= ds.SPLIT_KEYS_MIN
    assert sk - np.lcm(page_size, p.block_k) < ds.SPLIT_KEYS_MIN
    assert p.smem_bytes == 2 * p.rows * (d + 8) + 2 * 2 * 2 * p.block_k * (d + 8)


def test_splits_of_the_serve_shapes():
    """glm4-9b at page 16: 64-key splits; ~420 live keys a slot x 8 slots x
    2 kv heads is ~115 working blocks on the card's 132 SMs."""
    p = ds.plan(torch.bfloat16, 128, 16, 1, 16)
    assert (p.split_keys, p.block_k, p.rows, p.row_chunks) == (64, 32, 16, 1)
    assert 2 * sum(-(-n // p.split_keys) for n in [420] * 8) == 112
    assert ds.n_splits(p, 66, 16, None) == 17 and ds.n_splits(p, 128, 16, 1024) == 16
    assert ds.n_splits(p, 128, 16, 1000) == 16 and ds.n_splits(p, 1, 16, None) == 1


@pytest.mark.parametrize("page_size", [8, 16, 48])
@pytest.mark.parametrize("d", [16, 80, 128, 256])
def test_split_boundaries_are_anchored_at_key_0(page_size, d):
    """The split depends on (page size, head dim) alone: every dtype's
    plan, rep, window and pool kind takes the same one, so split s holds
    keys [s * split_keys, (s + 1) * split_keys) whatever the batch, the
    lengths or pages_bound (none of which the plan sees); a launch only
    covers more or fewer of them."""
    keys = {ds.plan(torch.bfloat16, d, rep, W, page_size, quantized=qz).split_keys
            for rep in (1, 5, 16, 48) for W in (1, 5, 13) for qz in (False, True)}
    assert keys == {ds.split_keys(page_size, d)}
    p = ds.plan(torch.bfloat16, d, 16, 1, page_size)
    for max_pages in (1, 3, 17, 128):
        for cap in (None, 70, 2048):
            n = ds.n_splits(p, max_pages, page_size, cap)
            reach = max_pages * page_size if cap is None else min(max_pages * page_size, cap)
            assert (n - 1) * p.split_keys < reach <= n * p.split_keys


@pytest.mark.parametrize("d", [8, 24, 72, 100, 264, 512])
def test_bf16_raises_at_a_head_dim_it_is_not_built_for(d):
    with pytest.raises(ValueError, match=r"head dim %d not supported" % d):
        ds.plan(torch.bfloat16, d, 16, 1, 16)


@pytest.mark.parametrize("page_size", [1, 4, 12, 20, 0])
def test_bf16_raises_at_a_page_size_that_is_not_a_multiple_of_8(page_size):
    with pytest.raises(ValueError, match=r"page size %d not supported" % page_size):
        ds.plan(torch.bfloat16, 128, 16, 1, page_size)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="not supported"):
        ds.plan(dtype, 128, 16, 1, 16)


@pytest.mark.parametrize("rep, d", ZOO)
@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("quantized", [False, True])
def test_every_zoo_window_fits_a_bf16_block(rep, d, W, quantized):
    """Each (rep, W) of the zoo, rep 16 at W 13 and rep 48 at W 5 among
    them, spreads its rep * W rows over whole m16 tiles of at most 8 warps a
    block, within the card's shared memory."""
    p = ds.plan(torch.bfloat16, d, rep, W, 16, quantized=quantized)
    R = rep * W
    assert p.rows % 16 == 0 and 16 <= p.rows <= 16 * ds.MAX_WARPS
    assert p.row_chunks == -(-R // p.rows) and p.rows * (p.row_chunks - 1) < R
    assert p.smem_bytes <= _build.SMEM_LIMIT
    assert p.smem_bytes == ds.bf16_smem_bytes(d, p.block_k, p.rows, p.stages, quantized)


def _rows(p):
    return p.rows, p.row_chunks


def test_wide_windows_span_row_chunks():
    assert _rows(ds.plan(torch.bfloat16, 128, 16, 13, 16)) == (112, 2)   # glm4-9b, spec_k 12
    assert _rows(ds.plan(torch.bfloat16, 128, 48, 5, 16)) == (128, 2)    # granite-20b, spec_k 4
    assert _rows(ds.plan(torch.bfloat16, 128, 16, 5, 16)) == (80, 1)     # glm4-9b, spec_k 4
    assert _rows(ds.plan(torch.bfloat16, 128, 8, 1, 16)) == (16, 1)      # a padded tile


@pytest.mark.parametrize("rep, d", ZOO)
@pytest.mark.parametrize("W", WINDOWS)
def test_every_zoo_window_fits_float32_row_chunks(rep, d, W):
    """float32 cuts a kv head's rep * W rows into balanced chunks of the
    common.cuh tile; no window of the zoo raises (the single-block tile
    raised above 195 rows at d 128 and page 16)."""
    p = ds.plan(torch.float32, d, rep, W, 16)
    R = rep * W
    assert p.kernel == "f32" and p.block_k == 16 and p.split_keys == 0
    assert p.row_chunks == -(-R // p.rows) and p.rows * p.row_chunks - R < p.row_chunks
    assert p.smem_bytes == 4 * _build.tile_floats(p.rows, 16, d) <= _build.SMEM_LIMIT
    assert ds.f32_rows(16, d) >= p.rows


def test_float32_rows_at_the_old_limit():
    assert ds.f32_rows(16, 128) == 195
    assert _rows(ds.plan(torch.float32, 128, 16, 12, 16)) == (192, 1)
    assert _rows(ds.plan(torch.float32, 128, 16, 13, 16)) == (104, 2)
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        ds.plan(torch.float32, 256, 16, 1, 256)


def test_plan_matches_the_kernel_source():
    """Every bf16 head dim the plan takes is instantiated with its chunk and
    ring (RT_SPLIT lines), and the constants agree."""
    built = {int(d): (int(bk), int(st))
             for d, bk, st in re.findall(r"RT_SPLIT\((\d+), (\d+), (\d+)\)\n", SRC)}
    assert built == ds.BF16_TILES
    assert re.search(r"constexpr int kMaxWarps = %d;" % ds.MAX_WARPS, SRC)
    assert re.search(r"constexpr int kStages = %d;" % ds.STAGES, SRC)
    assert "return d <= 128 ? 32 : 16;" in SRC
    for name in ("decode_split_kernel", "decode_split_combine"):
        assert name in SRC          # the profile's class key of the routine
    for src in ("decode_split_bf16.cu", "decode_split_quant.cu"):
        assert src in _build.SOURCES
    assert "decode_split.cuh" in _build.HEADERS


# ---------------------------------------------------------------------------
# decode_attention's pool view
# ---------------------------------------------------------------------------
def _dense(b, S, h, kvh, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in [(b, 1, h, d), (b, S, kvh, d),
                                                            (b, S, kvh, d)]]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("kv_bound", [None, 48, 70])
@pytest.mark.parametrize("opts", [{}, {"window": 9}, {"softcap": 5.0}])
def test_pool_view_through_paged_attention_equals_decode_attention(kv_bound, opts):
    lens = [1, 17, 48, 70, 0, 33]
    b, S, h, kvh, d = len(lens), 80, 8, 2, 16
    _, (q, k, v) = _dense(b, S, h, kvh, d, 3)
    bound = S if kv_bound is None else kv_bound
    kp, vp, pages, cap = da_mod.pool_view(k, v, bound)
    table = da_mod.identity_table(b, S // 16)
    assert kp.data_ptr() == k.data_ptr() and kp.shape == (b * S // 16, 16, kvh, d)
    assert table.dtype == torch.int32 and table.shape == (b, S // 16)
    assert [int(table[i, j]) for i, j in ((0, 0), (1, 0), (5, 4))] == [0, 5, 29]
    assert pages == -(-bound // 16) and cap == bound
    lengths = torch.tensor(lens, dtype=torch.int32)
    # rows no longer than the cap: the view attends exactly the dense keys
    want = ref.decode_attention(q, k, v, lengths, kv_bound=bound, **opts)
    got = ref.paged_attention(q, kp, vp, table[:, :pages], lengths, **opts)
    short = [i for i, n in enumerate(lens) if n <= cap]
    # (2e-6: the plain versions sum over key counts that differ with the cap)
    torch.testing.assert_close(got[short], want[short], rtol=2e-6, atol=2e-6)
    # rows past the cap, no window: the first `cap` keys only
    if not opts.get("window"):
        capped = ref.paged_attention(q, kp, vp, table[:, :pages], lengths.clamp(max=cap), **opts)
        torch.testing.assert_close(capped, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", [{}, {"window": 7}, {"softcap": 9.0}, {"kv_bound": 48}])
def test_pool_view_matches_pallas_decode(dtype, opts):
    lens = np.array([1, 17, 48, 30, 5], dtype=np.int32)
    b, S, h, kvh, d = len(lens), 64, 8, 2, 64
    arrs, (q, k, v) = _dense(b, S, h, kvh, d, 4, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(pallas_decode(*(jnp.asarray(a, jdt) for a in arrs), jnp.asarray(lens),
                                    **opts, block_s=16, interpret=True).astype(jnp.float32))
    kp, vp, pages, cap = da_mod.pool_view(k, v, opts.get("kv_bound", S))
    table = da_mod.identity_table(b, S // 16)
    rest = {key: val for key, val in opts.items() if key != "kv_bound"}
    got = ref.paged_attention(q, kp, vp, table[:, :pages], torch.from_numpy(lens), **rest)
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_cpu_tensors_take_the_plain_versions_at_any_shape():
    """The plan's limits are the kernels': a CPU tensor never plans a
    launch, whatever its head dim, page size or cache length."""
    _, (q, k, v) = _dense(2, 40, 4, 2, 24, 5, torch.bfloat16)
    lengths = torch.tensor([40, 9], dtype=torch.int32)
    counts = (da_mod.launches, pa_mod.launches, sv_mod.launches)
    torch.testing.assert_close(da_mod.decode_attention(q, k, v, lengths),
                               ref.decode_attention(q, k, v, lengths), rtol=0, atol=0)
    pool = k.reshape(8, 10, 2, 24)                       # 10-key pages, head dim 24
    table = torch.arange(8, dtype=torch.int32).view(2, 4)
    torch.testing.assert_close(pa_mod.paged_attention(q, pool, pool, table, lengths),
                               ref.paged_attention(q, pool, pool, table, lengths), rtol=0, atol=0)
    qs = torch.cat([q, q], 1)
    wl = torch.tensor([2, 1], dtype=torch.int32)
    torch.testing.assert_close(sv_mod.spec_verify(qs, pool, pool, table, lengths - 2, wl),
                               ref.spec_verify(qs, pool, pool, table, lengths - 2, wl),
                               rtol=0, atol=0)
    assert (da_mod.launches, pa_mod.launches, sv_mod.launches) == counts
