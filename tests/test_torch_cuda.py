"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips (from the ``cuda`` fixture, never at import)
where ``torch.cuda.is_available()`` is false.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``;
``chip_smoke.py`` holds the same kernels at full glm4-9b and mamba2-130m
widths.  Tolerance ``|kernel - plain| <= tol * (1 + |plain|)`` with tol 2e-2
for bf16 (rounding and summation order) and 5e-5 for float32; the float32
``ssd`` scan takes 5e-4, the JAX suite's own tolerance between the chunked
scan and the sequential recurrence (another summation order over hundreds
of timesteps).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, kvquant, ref
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels import rmsnorm as rn_mod
from repro_torch.kernels import spec_verify as sv_mod
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels import varlen_prefill as vp_mod

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, want, dtype, f32_tol=5e-5):
    """|kernel - plain| <= tol * (1 + |plain|), tol by dtype."""
    tol = 2e-2 if dtype == torch.bfloat16 else f32_tol
    want = want.float().cpu()
    assert bool(((out.float().cpu() - want).abs() <= tol * (1 + want.abs())).all())


# named cases, so that -k "flash and float32" selects what it says
DTYPES = [pytest.param(torch.float32, id="float32"), pytest.param(torch.bfloat16, id="bfloat16")]


def _randn(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 4096), (3, 5, 100)])
def test_rmsnorm_kernel(cuda, dtype, shape):
    x = _randn(shape, dtype, cuda, 0)
    w = _randn(shape[-1:], dtype, cuda, 1) * 0.1
    n = rn_mod.launches
    out = rn_mod.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rn_mod.launches == n + 1
    _close(out, ref.rmsnorm(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2049, 4096),   # a packed-prefill buffer plus one: 16-byte vectors, 256 threads a row
    (3, 128),       # rows that do not fill a block (32 rows of 8 threads a block)
    (5, 16384),     # eight vectors a thread
    (2, 24),        # three vectors a row (bf16), a thread holding the third alone
    (4, 20),        # float32 vectors; bf16 rows not a whole number of vectors: scalar
    (2, 20000),     # a row wider than 256 x 8 vectors: scalar
])
def test_rmsnorm_kernel_paths(cuda, dtype, shape):
    """The vector path at every vector count a thread holds and the scalar
    path where a row is not a whole number of 16-byte vectors or too wide."""
    x = _randn(shape, dtype, cuda, 3) * 3.0
    w = _randn(shape[-1:], dtype, cuda, 4) * 0.1
    _close(rn_mod.rmsnorm(x, w), ref.rmsnorm(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_misaligned_rows(cuda, dtype):
    """A view that starts off a 16-byte boundary takes the scalar path."""
    buf = _randn((1 + 8 * 64,), dtype, cuda, 5)
    x = buf[1:].view(8, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = _randn((64,), dtype, cuda, 6) * 0.1
    _close(rn_mod.rmsnorm(x, w), ref.rmsnorm(x, w), dtype)


PAGED_SHAPES = [
    # h, kvh, d, page_size, max_pages, lengths (the last one 0: an idle slot)
    (32, 2, 128, 16, 8, [1, 17, 128, 0]),     # glm4-9b widths
    (8, 8, 64, 8, 5, [40, 3, 0]),             # MHA
    (32, 1, 256, 16, 4, [64, 33, 0]),         # 32-head group, > 48 KB smem
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("opts", [{}, {"window": 5}, {"softcap": 7.0}, {"pages_bound": 2}])
def test_paged_attention_kernel(cuda, dtype, shape, opts):
    h, kvh, d, ps, mp, lens = shape
    b = len(lens)
    q = _randn((b, 1, h, d), dtype, cuda, 2)
    kp, vp = _randn((b * mp + 1, ps, kvh, d), dtype, cuda, 3), _randn((b * mp + 1, ps, kvh, d), dtype, cuda, 4)
    table = torch.arange(1, b * mp + 1, dtype=torch.int32, device=cuda).view(b, mp).flip(0).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n = pa_mod.launches
    out = pa_mod.paged_attention(q, kp, vp, table, lengths, **opts)
    torch.cuda.synchronize()
    assert pa_mod.launches == n + 1
    # the wrapper on CPU tensors runs the plain version (and applies pages_bound)
    want = pa_mod.paged_attention(*(t.cpu() for t in (q, kp, vp, table, lengths)), **opts)
    _close(out, want, dtype)
    assert torch.all(out[-1] == 0)


VARLEN_SHAPES = [
    # h, kvh, d, page_size
    (32, 2, 128, 16),       # glm4-9b widths
    (8, 8, 64, 8),          # MHA, small pages
    (32, 1, 256, 16),       # > 48 KB smem
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", VARLEN_SHAPES)
@pytest.mark.parametrize("opts", [{}, {"window": 7}, {"softcap": 11.0}])
def test_varlen_prefill_kernel(cuda, dtype, shape, opts):
    h, kvh, d, ps = shape
    mp = 8
    chunks = [(37, 2), (0, 0), (16, 0), (5, 3)]        # (real_len, ctx_pages)
    cu, lens, pos0 = [0], [], []
    tables = torch.zeros((len(chunks), mp), dtype=torch.int32)
    nxt = 1
    for c, (n, cp) in enumerate(chunks):
        cu.append(cu[-1] + -(-n // ps) * ps)
        lens.append(n)
        pos0.append(cp * ps)
        tables[c, :cp] = torch.arange(nxt, nxt + cp)
        nxt += cp
    T = cu[-1] + 2 * ps                                 # buffer tail pad
    q = _randn((T, h, d), dtype, cuda, 5)
    k, v = _randn((T, kvh, d), dtype, cuda, 6), _randn((T, kvh, d), dtype, cuda, 7)
    kp, vp = _randn((nxt, ps, kvh, d), dtype, cuda, 8), _randn((nxt, ps, kvh, d), dtype, cuda, 9)
    meta = [torch.tensor(a, dtype=torch.int32, device=cuda) for a in (cu, lens, pos0)]
    args = (q, k, v, kp, vp, *meta, tables.to(cuda))
    n = vp_mod.launches
    out = vp_mod.varlen_prefill(*args, **opts)
    torch.cuda.synchronize()
    assert vp_mod.launches == n + 1
    _close(out, ref.varlen_prefill(*(t.cpu() for t in args), **opts), dtype)
    assert torch.all(out[37:cu[1]] == 0) and torch.all(out[cu[-1]:] == 0)


def _spec_inputs(rows, W, h, kvh, d, ps, mp, dtype, dev, seed):
    """Windows [(committed, window_len)] with pages covering committed plus
    in-flight tokens; window starts are not page-aligned."""
    b = len(rows)
    table = torch.zeros((b, mp), dtype=torch.int32)
    nxt = 1
    for i, (L, wl) in enumerate(rows):
        n = -(-(L + wl) // ps)
        table[i, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    q = _randn((b, W, h, d), dtype, dev, seed)
    kp = _randn((nxt, ps, kvh, d), dtype, dev, seed + 1)
    vp = _randn((nxt, ps, kvh, d), dtype, dev, seed + 2)
    lens = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    wlens = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    return q, kp, vp, table.to(dev), lens, wlens


SPEC_SHAPES = [
    # h, kvh, d, page_size, max_pages, W, rows [(committed, window_len)]
    (32, 2, 128, 16, 8, 5, [(13, 4), (7, 2), (0, 0), (20, 5), (48, 1)]),  # glm4-9b widths
    (8, 8, 64, 8, 5, 3, [(15, 3), (8, 1), (0, 2)]),                      # MHA, fresh pages
    (32, 1, 128, 16, 4, 4, [(30, 4), (3, 3)]),                           # 128 tile rows
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SPEC_SHAPES)
@pytest.mark.parametrize("opts", [{}, {"window": 5}, {"softcap": 7.0}, {"pages_bound": 2}])
def test_spec_verify_kernel(cuda, dtype, shape, opts):
    h, kvh, d, ps, mp, W, rows = shape
    args = _spec_inputs(rows, W, h, kvh, d, ps, mp, dtype, cuda, 10)
    n = sv_mod.launches
    out = sv_mod.spec_verify(*args, **opts)
    torch.cuda.synchronize()
    assert sv_mod.launches == n + 1
    want = sv_mod.spec_verify(*(t.cpu() for t in args), **opts)
    _close(out, want, dtype)
    for i, (_, wl) in enumerate(rows):
        assert torch.all(out[i, wl:] == 0)          # window pad, idle slot


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_spec_verify_rows_equal_paged_attention(cuda, dtype, mode):
    """Window row w runs the arithmetic of a one-token decode at length
    len + w + 1 in paged_attention: the same pages, keys and order (bf16:
    the same splits and key chunks of the split-KV routine), on a pool of
    q's dtype and on int8/fp8 codes."""
    rows = [(13, 4), (7, 3), (31, 2), (60, 4), (0, 1)]
    q, kp, vp, table, lens, wlens = _spec_inputs(rows, 4, 32, 2, 128, 16, 5, dtype, cuda, 20)
    scales = {}
    if mode is not None:
        kp, vp, ks, vs = _quantized(kp.float(), vp.float(), mode)
        scales = {"k_scales": ks, "v_scales": vs}
    out = sv_mod.spec_verify(q, kp, vp, table, lens, wlens, **scales)
    for i, (L, wl) in enumerate(rows):
        for w in range(wl):
            one = pa_mod.paged_attention(
                q[i : i + 1, w : w + 1].contiguous(), kp, vp, table[i : i + 1].contiguous(),
                torch.tensor([L + w + 1], dtype=torch.int32, device=cuda), **scales)
            assert torch.equal(out[i, w], one[0, 0])


SPEC_WIDE = [
    # h, kvh, d, page_size, max_pages, W, rows [(committed, window_len)]: the
    # windows a single-block tile of rep * W rows refused
    (32, 2, 128, 16, 8, 13, [(40, 13), (7, 9), (0, 13), (100, 1)]),   # glm4-9b at spec_k 12
    (48, 1, 128, 16, 8, 5, [(40, 5), (7, 3), (90, 5), (0, 0)]),       # granite-20b at spec_k 4
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SPEC_WIDE)
def test_spec_verify_wide_windows(cuda, dtype, shape):
    """rep * W rows above one block's share (208 and 240) run in both
    dtypes, spread over row chunks, and each row still equals a one-token
    decode."""
    h, kvh, d, ps, mp, W, rows = shape
    q, kp, vp, table, lens, wlens = _spec_inputs(rows, W, h, kvh, d, ps, mp, dtype, cuda, 25)
    out = sv_mod.spec_verify(q, kp, vp, table, lens, wlens)
    torch.cuda.synchronize()
    _close(out, ref.spec_verify(*(t.cpu() for t in (q, kp, vp, table, lens, wlens))), dtype)
    for i, (L, wl) in enumerate(rows):
        assert torch.all(out[i, wl:] == 0)
        for w in range(0, wl, 4):
            one = pa_mod.paged_attention(
                q[i : i + 1, w : w + 1].contiguous(), kp, vp, table[i : i + 1].contiguous(),
                torch.tensor([L + w + 1], dtype=torch.int32, device=cuda))
            assert torch.equal(out[i, w], one[0, 0])


SPLIT_EDGES = [
    # h, kvh, d, page_size, max_pages, lengths: bf16 splits hold 64 keys
    (32, 2, 128, 16, 10, [63, 64, 65, 127, 128, 129, 1, 0]),  # split edges, one key either side
    (32, 2, 128, 16, 128, [2048, 1500, 5]),                   # a 2048-key row
    (32, 32, 80, 16, 6, [80, 33, 64, 0]),                     # head dim 80 (zamba2's attention)
    (8, 8, 64, 8, 20, [64, 65, 63, 150]),                     # 8-key pages
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SPLIT_EDGES)
@pytest.mark.parametrize("opts", [{}, {"window": 64}, {"pages_bound": 4}])
def test_paged_attention_split_edges(cuda, dtype, shape, opts):
    h, kvh, d, ps, mp, lens = shape
    b = len(lens)
    q = _randn((b, 1, h, d), dtype, cuda, 26)
    kp = _randn((b * mp + 1, ps, kvh, d), dtype, cuda, 27)
    vp = _randn((b * mp + 1, ps, kvh, d), dtype, cuda, 28)
    table = torch.arange(1, b * mp + 1, dtype=torch.int32, device=cuda).view(b, mp).flip(0).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = pa_mod.paged_attention(q, kp, vp, table, lengths, **opts)
    torch.cuda.synchronize()
    want = pa_mod.paged_attention(*(t.cpu() for t in (q, kp, vp, table, lengths)), **opts)
    _close(out, want, dtype)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[i] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_bound", [70, 100, 129])
@pytest.mark.parametrize("opts", [{}, {"window": 40}])
def test_decode_attention_kv_bound_off_the_pages(cuda, dtype, kv_bound, opts):
    """A kv_bound that is not a multiple of 16 caps the keys of rows longer
    than it (bf16: a key cap inside the last page of the pool view)."""
    lens = [128, 70, 69, 100, 1, 0, 160]
    b, S, h, kvh, d = len(lens), 160, 32, 2, 128
    q = _randn((b, 1, h, d), dtype, cuda, 29)
    kc, vc = _randn((b, S, kvh, d), dtype, cuda, 30), _randn((b, S, kvh, d), dtype, cuda, 31)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n = da_mod.launches
    out = da_mod.decode_attention(q, kc, vc, lengths, kv_bound=kv_bound, **opts)
    torch.cuda.synchronize()
    assert da_mod.launches == n + 1
    want = ref.decode_attention(*(t.cpu() for t in (q, kc, vc, lengths)), kv_bound=kv_bound,
                                **opts)
    _close(out, want, dtype)
    assert torch.all(out[5] == 0)


def _quantized(kp, vp, mode):
    store = kvquant.pool_dtype(mode)
    (kq, ks), (vq, vs) = kvquant.quantize(kp, store), kvquant.quantize(vp, store)
    return kq.contiguous(), vq.contiguous(), ks.contiguous(), vs.contiguous()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_kernel_quantized(cuda, mode, dtype):
    h, kvh, d, ps, mp, lens = PAGED_SHAPES[0]
    b = len(lens)
    q = _randn((b, 1, h, d), dtype, cuda, 30)
    kq, vq, ks, vs = _quantized(_randn((b * mp + 1, ps, kvh, d), torch.float32, cuda, 31),
                                _randn((b * mp + 1, ps, kvh, d), torch.float32, cuda, 32), mode)
    table = torch.arange(1, b * mp + 1, dtype=torch.int32, device=cuda).view(b, mp).flip(0).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = pa_mod.paged_attention(q, kq, vq, table, lengths, k_scales=ks, v_scales=vs, window=60)
    want = ref.paged_attention(*(t.cpu() for t in (q, kq, vq, table, lengths)), window=60,
                               k_scales=ks.cpu(), v_scales=vs.cpu())
    _close(out, want, dtype)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_varlen_prefill_kernel_quantized(cuda, mode, dtype):
    h, kvh, d, ps = VARLEN_SHAPES[0]
    chunks, mp = [(37, 2), (0, 0), (16, 0), (5, 3)], 8
    cu, lens, pos0 = [0], [], []
    tables = torch.zeros((len(chunks), mp), dtype=torch.int32)
    nxt = 1
    for c, (n, cp) in enumerate(chunks):
        cu.append(cu[-1] + -(-n // ps) * ps)
        lens.append(n)
        pos0.append(cp * ps)
        tables[c, :cp] = torch.arange(nxt, nxt + cp)
        nxt += cp
    T = cu[-1] + ps
    q = _randn((T, h, d), dtype, cuda, 40)
    k, v = _randn((T, kvh, d), dtype, cuda, 41), _randn((T, kvh, d), dtype, cuda, 42)
    kq, vq, ks, vs = _quantized(_randn((nxt, ps, kvh, d), torch.float32, cuda, 43),
                                _randn((nxt, ps, kvh, d), torch.float32, cuda, 44), mode)
    meta = [torch.tensor(a, dtype=torch.int32, device=cuda) for a in (cu, lens, pos0)]
    args = (q, k, v, kq, vq, *meta, tables.to(cuda))
    out = vp_mod.varlen_prefill(*args, k_scales=ks, v_scales=vs)
    want = ref.varlen_prefill(*(t.cpu() for t in args), k_scales=ks.cpu(), v_scales=vs.cpu())
    _close(out, want, dtype)


# ---------------------------------------------------------------------------
# varlen_prefill's bf16 tensor-core routine: tile edges and bit-identities
# ---------------------------------------------------------------------------
def _varlen_layout(chunks, ps, mp, tail):
    """cu, lens, pos0 and tables for chunks [(real_len, ctx_pages)], context
    pages numbered from 1, a buffer tail of `tail` pad rows."""
    cu, lens, pos0 = [0], [], []
    tables = torch.zeros((len(chunks), mp), dtype=torch.int32)
    nxt = 1
    for c, (n, cp) in enumerate(chunks):
        cu.append(cu[-1] + -(-n // ps) * ps)
        lens.append(n)
        pos0.append(cp * ps)
        tables[c, :cp] = torch.arange(nxt, nxt + cp)
        nxt += cp
    return cu, lens, pos0, tables, nxt, cu[-1] + tail


def _varlen_inputs(chunks, h, kvh, d, ps, mp, dtype, dev, seed, tail=0):
    cu, lens, pos0, tables, pages, T = _varlen_layout(chunks, ps, mp, tail)
    q = _randn((T, h, d), dtype, dev, seed)
    k, v = _randn((T, kvh, d), dtype, dev, seed + 1), _randn((T, kvh, d), dtype, dev, seed + 2)
    kp = _randn((pages, ps, kvh, d), dtype, dev, seed + 3)
    vp = _randn((pages, ps, kvh, d), dtype, dev, seed + 4)
    meta = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (cu, lens, pos0)]
    return (q, k, v, kp, vp, *meta, tables.to(dev)), cu, lens


VARLEN_EDGES = [
    # h, kvh, d, page_size, chunks [(real_len, ctx_pages)], opts
    (32, 2, 128, 16, [(1, 5), (33, 2)], {}),                           # a 1-token chunk
    (32, 2, 128, 16, [(40, 6), (20, 3)], {"pages_bound": 2}),          # context cut short
    (32, 2, 128, 16, [(70, 2), (9, 1)], {"window": 5}),                # window < a key tile
    (48, 1, 128, 12, [(50, 3), (7, 1)], {}),                           # rep 48: a partial block
    (8, 8, 64, 8, [(1, 3), (30, 4)], {"pages_bound": 1, "window": 12}),  # mma.sync, 8-key pages
    (16, 2, 256, 16, [(45, 2), (3, 0)], {"softcap": 8.0}),             # d 256, two-stage ring
    (6, 2, 80, 16, [(33, 2), (0, 0)], {}),                             # d 80: padded rows
    (4, 2, 72, 8, [(20, 1)], {"window": 9}),                           # d 72: the CUDA-core kernel
]


@pytest.mark.parametrize("case", VARLEN_EDGES)
def test_varlen_prefill_bf16_tile_edges(cuda, case):
    h, kvh, d, ps, chunks, opts = case
    args, cu, lens = _varlen_inputs(chunks, h, kvh, d, ps, 8, torch.bfloat16, cuda, 100, tail=ps)
    n = vp_mod.launches
    out = vp_mod.varlen_prefill(*args, **opts)
    torch.cuda.synchronize()
    assert vp_mod.launches == n + 1
    kernel = vp_mod.plan(torch.bfloat16, d, h // kvh, ps).kernel
    assert kernel == ("wgmma" if d == 128 else "f32" if d == 72 else "mma")
    _close(out, ref.varlen_prefill(*(t.cpu() for t in args), **opts), torch.bfloat16)
    for c, n_c in enumerate(lens):
        assert torch.all(out[cu[c] + n_c:cu[c + 1]] == 0)
    assert torch.all(out[cu[-1]:] == 0)


VARLEN_SPLITS = [
    # h, kvh, d, page_size, prompt length, split: a page boundary that is not a
    # multiple of the 32-key tile, so one tile holds context and own keys
    (32, 2, 128, 16, 150, 48),     # glm4-9b widths, wgmma
    (8, 8, 64, 8, 90, 40),         # d 64 on mma.sync, 8-key pages
]


@pytest.mark.parametrize("case", VARLEN_SPLITS)
@pytest.mark.parametrize("opts", [{}, {"window": 37}, {"softcap": 9.0}])
def test_varlen_prefill_bf16_whole_equals_split(cuda, case, opts):
    """A prompt prefilled as one chunk and the same prompt split at a page
    boundary (its first part committed to the pool, the rest a chunk over
    those context pages) give the same bits for the rows of the second part."""
    h, kvh, d, ps, n, cut = case
    bf = torch.bfloat16
    q, k, v = _randn((n, h, d), bf, cuda, 110), _randn((n, kvh, d), bf, cuda, 111), \
        _randn((n, kvh, d), bf, cuda, 112)
    pages = -(-n // ps)
    kp = torch.zeros((pages + 1, ps, kvh, d), dtype=bf, device=cuda)
    vp = torch.zeros_like(kp)
    kp.view(-1, kvh, d)[ps:ps + n] = k
    vp.view(-1, kvh, d)[ps:ps + n] = v
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=cuda).view(1, pages)

    def run(start, rows, seed):
        length = rows[0].shape[0]
        T = -(-length // ps) * ps + ps                     # chunk pad and a tail page
        packed = [torch.cat([t, _randn((T - length, *t.shape[1:]), bf, cuda, seed + i)])
                  for i, t in enumerate(rows)]
        meta = [torch.tensor(a, dtype=torch.int32, device=cuda)
                for a in ([0, T - ps], [length], [start])]
        return vp_mod.varlen_prefill(*packed, kp, vp, *meta, table, **opts)[:length]

    whole = run(0, (q, k, v), 120)
    split = run(cut, (q[cut:], k[cut:], v[cut:]), 130)
    assert torch.equal(whole[cut:], split)
    _close(whole, ref.attention(q.cpu()[None], k.cpu()[None], v.cpu()[None],
                                **{key: val for key, val in opts.items()})[0], bf)


def test_varlen_prefill_bf16_chunk_independent_of_its_place(cuda):
    """One chunk (with context pages) first in the packed buffer, and after
    two other chunks with different neighbours' values, gives the same bits."""
    h, kvh, d, ps, mp = 32, 2, 128, 16, 8
    bf = torch.bfloat16
    n, cp = 70, 3
    rows = [_randn((n, c, d), bf, cuda, 140 + i) for i, c in enumerate((h, kvh, kvh))]
    kp = _randn((12, ps, kvh, d), bf, cuda, 143)
    vp = _randn((12, ps, kvh, d), bf, cuda, 144)

    def run(before, seed):
        """The chunk after `before` chunks [(len, ctx_pages)] of random rows."""
        chunks = before + [(n, cp)]
        cu, lens, pos0, _, _, T = _varlen_layout(chunks, ps, mp, ps)
        tables = torch.zeros((len(chunks), mp), dtype=torch.int32)
        tables[:, :cp] = torch.tensor([9, 4, 7])        # the chunk's pages; others' alike
        packed = [_randn((T, t.shape[1], d), bf, cuda, seed + i) for i, t in enumerate(rows)]
        for t, r in zip(packed, rows):
            t[cu[-2]:cu[-2] + n] = r
        meta = [torch.tensor(a, dtype=torch.int32, device=cuda) for a in (cu, lens, pos0)]
        out = vp_mod.varlen_prefill(*packed, kp, vp, *meta, tables.to(cuda))
        return out[cu[-2]:cu[-2] + n]

    first = run([], 150)
    later = run([(37, 2), (16, 0)], 160)
    other = run([(5, 1), (1, 4)], 170)
    assert torch.equal(first, later) and torch.equal(first, other)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("case", [
    (32, 2, 128, 16, [(37, 2), (0, 0), (16, 0), (5, 3)], {"window": 40}),
    (8, 8, 64, 8, [(30, 3), (1, 5)], {"pages_bound": 2}),
])
def test_varlen_prefill_tensor_cores_quantized(cuda, mode, case):
    """int8/fp8 context pages on the bf16 tensor-core routine: codes widened
    in shared memory, scales folded into S and P, own keys at full precision."""
    h, kvh, d, ps, chunks, opts = case
    args, cu, lens = _varlen_inputs(chunks, h, kvh, d, ps, 8, torch.bfloat16, cuda, 180, tail=ps)
    kq, vq, ks, vs = _quantized(args[3].float(), args[4].float(), mode)
    args = (*args[:3], kq, vq, *args[5:])
    assert vp_mod.plan(torch.bfloat16, d, h // kvh, ps, quantized=True).kernel != "f32"
    out = vp_mod.varlen_prefill(*args, k_scales=ks, v_scales=vs, **opts)
    want = ref.varlen_prefill(*(t.cpu() for t in args), k_scales=ks.cpu(), v_scales=vs.cpu(),
                              **opts)
    _close(out, want, torch.bfloat16)
    assert torch.all(out[cu[-1]:] == 0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_spec_verify_kernel_quantized(cuda, mode, dtype):
    h, kvh, d, ps, mp, W, rows = SPEC_SHAPES[0]
    q, kp, vp, table, lens, wlens = _spec_inputs(rows, W, h, kvh, d, ps, mp, dtype, cuda, 50)
    kq, vq, ks, vs = _quantized(kp.float(), vp.float(), mode)
    out = sv_mod.spec_verify(q, kq, vq, table, lens, wlens, k_scales=ks, v_scales=vs)
    want = ref.spec_verify(*(t.cpu() for t in (q, kq, vq, table, lens, wlens)),
                           k_scales=ks.cpu(), v_scales=vs.cpu())
    _close(out, want, dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weight"):
        rn_mod.rmsnorm(x, torch.zeros(64, device=cuda, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        rn_mod.rmsnorm(x.t().contiguous().t(), torch.zeros(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="not supported"):
        rn_mod.rmsnorm(x.double(), torch.zeros(64, device=cuda, dtype=torch.float64))


def test_attention_wrappers_raise_on_pool_pairings(cuda):
    """A CUDA tensor runs the kernel or raises: a pool of another float
    dtype, codes without scales, scales beside a full-precision pool, and a
    window whose tile exceeds the card's shared memory."""
    q, kp, vp, table, lens, wlens = _spec_inputs([(5, 3)], 4, 8, 2, 64, 8, 2,
                                                 torch.bfloat16, cuda, 60)
    kq, vq, ks, vs = _quantized(kp.float(), vp.float(), "int8")
    with pytest.raises(TypeError, match="not supported"):
        sv_mod.spec_verify(q, kp.float(), vp.float(), table, lens, wlens)
    with pytest.raises(ValueError, match="needs k_scales"):
        sv_mod.spec_verify(q, kq, vq, table, lens, wlens)
    with pytest.raises(ValueError, match="full-precision"):
        sv_mod.spec_verify(q, kp, vp, table, lens, wlens, k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="float32"):
        pa_mod.paged_attention(q[:, :1].contiguous(), kq, vq, table, lens,
                               k_scales=ks.half(), v_scales=vs.half())
    n_pa = pa_mod.launches
    # 160 rows at d 256: bf16 spans them over two row chunks of the split
    # routine and runs; float32 cuts them into chunks of the tile, which
    # raises only where one row of a page does not fit a block
    big = _randn((1, 5, 32, 256), torch.bfloat16, cuda, 61)
    pool = _randn((3, 16, 1, 256), torch.bfloat16, cuda, 62)
    one = torch.ones((1, 2), dtype=torch.int32, device=cuda)
    out = sv_mod.spec_verify(big, pool, pool, one, lens, wlens)
    _close(out, ref.spec_verify(*(t.cpu() for t in (big, pool, pool, one, lens, wlens))),
           torch.bfloat16)
    n = sv_mod.launches
    huge = _randn((1, 256, 1, 256), torch.float32, cuda, 63)       # 256-key pages
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        sv_mod.spec_verify(big.float(), huge, huge, one, lens, wlens)
    with pytest.raises(ValueError, match="head dim 72 not supported"):
        sv_mod.spec_verify(big[..., :72].contiguous(), pool[..., :72].contiguous(),
                           pool[..., :72].contiguous(), one, lens, wlens)
    with pytest.raises(ValueError, match="page size 12 not supported"):
        pa_mod.paged_attention(big[:, :1].contiguous(), pool[:, :12].contiguous(),
                               pool[:, :12].contiguous(), one, lens)
    assert sv_mod.launches == n and pa_mod.launches == n_pa


# ---------------------------------------------------------------------------
# the dense-cache kernels: flash_attention and decode_attention
# ---------------------------------------------------------------------------
FLASH_SHAPES = [
    # b, sq, sk, h, kvh, d
    (2, 100, 100, 32, 2, 128),      # glm4-9b widths, 25 tiles of 4 positions
    (1, 70, 70, 8, 8, 64),          # MHA: 64 positions per tile, a ragged last tile
    (2, 37, 37, 32, 1, 128),        # MQA: 2 positions per tile
    (1, 40, 40, 16, 2, 256),        # > 48 KB shared memory at d 256
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("opts", [{}, {"window": 7}, {"softcap": 11.0}, {"causal": False},
                                  {"q_offset": 30, "window": 50}])
def test_flash_attention_kernel(cuda, dtype, shape, opts):
    b, sq, sk, h, kvh, d = shape
    q = _randn((b, sq, h, d), dtype, cuda, 70)
    k, v = _randn((b, sk, kvh, d), dtype, cuda, 71), _randn((b, sk, kvh, d), dtype, cuda, 72)
    n = fa_mod.launches
    out = fa_mod.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert fa_mod.launches == n + 1
    _close(out, fa_mod.flash_attention(q.cpu(), k.cpu(), v.cpu(), **opts), dtype)


def test_flash_attention_kernel_rows_without_live_keys(cuda):
    """q_offset 60 with window 4 over 40 keys: no row has a live key, and
    with q_offset 40 only the first three rows do; the rest are exact zeros."""
    q = _randn((1, 16, 32, 128), torch.bfloat16, cuda, 73)
    k, v = _randn((1, 40, 2, 128), torch.bfloat16, cuda, 74), _randn((1, 40, 2, 128), torch.bfloat16, cuda, 75)
    assert torch.all(fa_mod.flash_attention(q, k, v, window=4, q_offset=60) == 0)
    out = fa_mod.flash_attention(q, k, v, window=4, q_offset=40)
    assert torch.all(out[:, 3:] == 0) and bool((out[:, :3] != 0).any())
    _close(out, ref.attention(q.cpu(), k.cpu(), v.cpu(), window=4, q_offset=40), torch.bfloat16)


FLASH_BF16_EDGES = [
    # b, sq, sk, h, kvh, d, opts: the tile edges of the bf16 kernels (rows
    # numbered position * rep + head; d 128: 128 rows, 32-key tiles on wgmma;
    # d 16/64/256: 64 rows on mma.sync)
    (2, 37, 37, 32, 2, 128, {}),                           # sq not a multiple of 8 positions
    (2, 50, 177, 32, 2, 128, {"q_offset": 127}),           # sk > sq: positions 127..176
    (1, 130, 130, 32, 2, 128, {"window": 9}),              # a window narrower than a key tile
    (1, 77, 77, 32, 1, 128, {}),                           # rep 32 (MQA at h 32)
    (1, 9, 9, 256, 1, 128, {"softcap": 6.0}),              # rep 256: a group over two tiles
    (1, 45, 45, 128, 1, 64, {"softcap": 6.0}),             # rep 128: a group over two tiles
    (2, 33, 70, 6, 2, 16, {"q_offset": 37, "window": 20}),  # rep 3: tiles straddle positions
    (1, 90, 90, 4, 2, 256, {"window": 40, "q_offset": 3}),  # d 256, rows beyond the window
    (1, 70, 200, 8, 2, 64, {"causal": False, "window": 30}),  # non-causal window
]


@pytest.mark.parametrize("case", FLASH_BF16_EDGES)
def test_flash_attention_bf16_tile_edges(cuda, case):
    b, sq, sk, h, kvh, d, opts = case
    q = _randn((b, sq, h, d), torch.bfloat16, cuda, 76)
    k = _randn((b, sk, kvh, d), torch.bfloat16, cuda, 77)
    v = _randn((b, sk, kvh, d), torch.bfloat16, cuda, 78)
    out = fa_mod.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    want = ref.attention(q.cpu(), k.cpu(), v.cpu(), **opts)
    _close(out, want, torch.bfloat16)
    dead = (want == 0).flatten(2).all(-1)          # (b, sq): rows with no live key
    assert torch.all(out.cpu()[dead] == 0)


@pytest.mark.parametrize("opts", [{}, {"window": 50}, {"softcap": 9.0}])
def test_flash_attention_bf16_rows_independent_of_padding_and_batch(cuda, opts):
    """One prompt right-padded to two lengths, and batched beside another
    row, gives the same bits on its real rows: what lets the static engine
    (bucket padding) and the continuous engine (padding to its bucket)
    compute the same prefill."""
    n, h, kvh, d = 150, 32, 2, 128

    def padded(length, seed):
        real = [_randn((1, n, c, d), torch.bfloat16, cuda, 60 + i) for i, c in enumerate((h, kvh, kvh))]
        return [torch.cat([t, _randn((1, length - n, t.shape[2], d), torch.bfloat16, cuda, seed + i)], 1)
                for i, t in enumerate(real)]

    a = fa_mod.flash_attention(*padded(192, 100), **opts)[0, :n]
    b = fa_mod.flash_attention(*padded(256, 200), **opts)[0, :n]
    other = [_randn((1, 256, c, d), torch.bfloat16, cuda, 300 + i) for i, c in enumerate((h, kvh, kvh))]
    batched = [torch.cat([t, o]) for t, o in zip(padded(256, 400), other)]
    c = fa_mod.flash_attention(*batched, **opts)[0, :n]
    assert torch.equal(a, b) and torch.equal(a, c)


def test_flash_attention_bf16_raises_at_an_unsupported_head_dim(cuda):
    q = _randn((1, 8, 4, 96), torch.bfloat16, cuda, 97)
    k = _randn((1, 8, 2, 96), torch.bfloat16, cuda, 98)
    n = fa_mod.launches
    with pytest.raises(ValueError, match="head dim 96 not supported"):
        fa_mod.flash_attention(q, k, k)
    assert fa_mod.launches == n
    fa_mod.flash_attention(q.float(), k.float(), k.float())   # float32 takes any head dim
    assert fa_mod.launches == n + 1


DECODE_SHAPES = [
    # h, kvh, d, S, lengths (the last one 0: an idle row)
    (32, 2, 128, 160, [1, 17, 128, 0]),      # glm4-9b widths
    (8, 8, 64, 64, [40, 3, 0]),              # MHA
    (32, 1, 256, 80, [64, 33, 0]),           # 32-head group, > 48 KB smem
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("opts", [{}, {"window": 5}, {"softcap": 7.0}, {"kv_bound": 64}])
def test_decode_attention_kernel(cuda, dtype, shape, opts):
    h, kvh, d, S, lens = shape
    b = len(lens)
    q = _randn((b, 1, h, d), dtype, cuda, 80)
    kc, vc = _randn((b, S, kvh, d), dtype, cuda, 81), _randn((b, S, kvh, d), dtype, cuda, 82)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n = da_mod.launches
    out = da_mod.decode_attention(q, kc, vc, lengths, **opts)
    torch.cuda.synchronize()
    assert da_mod.launches == n + 1
    want = da_mod.decode_attention(*(t.cpu() for t in (q, kc, vc, lengths)), **opts)
    _close(out, want, dtype)
    assert torch.all(out[-1] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("opts", [{}, {"window": 20}])
def test_decode_attention_rows_equal_paged_attention(cuda, dtype, opts):
    """The same keys laid out densely and in 16-token pages give the same
    output bit for bit: the dense kernel steps through 16 keys at a time
    with paged_attention's tile arithmetic."""
    lens = [1, 17, 100, 0, 64]
    b, S, kvh, d, ps = len(lens), 128, 2, 128, 16
    q = _randn((b, 1, 32, d), dtype, cuda, 90)
    kc, vc = _randn((b, S, kvh, d), dtype, cuda, 91), _randn((b, S, kvh, d), dtype, cuda, 92)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    mp = S // ps
    table = (torch.randperm(b * mp, generator=torch.Generator().manual_seed(0)) + 1)
    table = table.view(b, mp).to(torch.int32).to(cuda)
    kp = torch.zeros((b * mp + 1, ps, kvh, d), dtype=dtype, device=cuda)
    vp = torch.zeros_like(kp)
    kp[table.long()] = kc.view(b, mp, ps, kvh, d)
    vp[table.long()] = vc.view(b, mp, ps, kvh, d)
    dense = da_mod.decode_attention(q, kc, vc, lengths, **opts)
    paged = pa_mod.paged_attention(q, kp, vp, table, lengths, **opts)
    assert torch.equal(dense, paged)


def test_dense_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = _randn((1, 8, 4, 64), torch.bfloat16, cuda, 93)
    k = _randn((1, 8, 2, 64), torch.bfloat16, cuda, 94)
    with pytest.raises(ValueError, match="share a dtype"):
        fa_mod.flash_attention(q, k.float(), k.float())
    with pytest.raises(TypeError, match="not supported"):
        fa_mod.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa_mod.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="pair"):
        fa_mod.flash_attention(q, k[..., :32].contiguous(), k[..., :32].contiguous())
    q1 = q[:, :1].contiguous()
    with pytest.raises(ValueError, match="int32"):
        da_mod.decode_attention(q1, k, k, torch.ones(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="\\(b, 1, h, d\\)"):
        da_mod.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32, device=cuda))
    # bf16 views the cache as 16-key pages: an 8-key cache is refused, and
    # float32 (the CUDA-core tile) takes it
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    n = da_mod.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        da_mod.decode_attention(q1, k, k, one)
    assert da_mod.launches == n
    _close(da_mod.decode_attention(q1.float(), k.float(), k.float(), one),
           ref.decode_attention(q1.cpu().float(), k.cpu().float(), k.cpu().float(), one.cpu()),
           torch.float32)
    # the float32 tile holds the whole GQA group: 128 rows at d 256 do not
    # fit a block (the bf16 kernel spans such a group over two tiles)
    big = _randn((1, 4, 128, 256), torch.float32, cuda, 95)
    kv = _randn((1, 4, 1, 256), torch.float32, cuda, 96)
    n = fa_mod.launches
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        fa_mod.flash_attention(big, kv, kv)
    assert fa_mod.launches == n


# ---------------------------------------------------------------------------
# ssd (the Mamba-2 chunked scan)
# ---------------------------------------------------------------------------
SSD_SHAPES = [
    # b, s, h, p, n, chunk
    (8, 881, 24, 64, 128, 64),      # mamba2-130m's static pass: 13 chunks + 49
    (2, 100, 4, 16, 32, 64),        # a partial trailing chunk
    (3, 40, 3, 8, 16, 64),          # s < chunk
    (1, 1, 2, 64, 128, 64),         # one timestep
    (2, 37, 5, 16, 16, 8),          # mamba2-130m reduced widths, ragged
    # bf16 below runs the tensor-core route (kernels/ssd.py plan)
    (2, 96, 4, 32, 64, 32),         # chunk 32, s an exact multiple of it, n 64
    (3, 50, 5, 16, 32, 16),         # chunk 16, ragged; 5 heads: the last group holds one
    (2, 128, 3, 64, 64, 64),        # zamba2's widths (p 64, n 64), two whole chunks
]


def _ssd_inputs(b, s, h, p, n, dtype, dev, seed, init):
    """x, dt, A, B, C (and an initial state) with mamba2's ranges: dt in
    [1e-3, 1e-1] and A in [-16, -1], as its dt_bias and A_log inits give."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    x, B, C = (t.to(dev, dtype) for t in (f(b, s, h, p), f(b, s, n), f(b, s, n)))
    dt = torch.from_numpy(rng.uniform(1e-3, 1e-1, (b, s, h)).astype(np.float32)).to(dev)
    A = torch.from_numpy(-rng.uniform(1.0, 16.0, (h,)).astype(np.float32)).to(dev)
    s0 = f(b, h, p, n).to(dev) if init else None
    return x, dt, A, B, C, s0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernel(cuda, dtype, shape, init):
    b, s, h, p, n, chunk = shape
    x, dt, A, B, C, s0 = _ssd_inputs(b, s, h, p, n, dtype, cuda, s + h, init)
    n0 = ssd_mod.launches
    y, sf = ssd_mod.ssd(x, dt, A, B, C, chunk=chunk, initial_state=s0, return_state=True)
    torch.cuda.synchronize()
    assert ssd_mod.launches == n0 + 1
    assert y.dtype == sf.dtype == dtype and y.shape == x.shape and sf.shape == (b, h, p, n)
    y_want, sf_want = ref.ssd(x, dt, A, B, C, initial_state=s0, return_state=True)
    _close(y, y_want, dtype, f32_tol=5e-4)
    _close(sf, sf_want, dtype, f32_tol=5e-4)
    assert torch.equal(ssd_mod.ssd(x, dt, A, B, C, chunk=chunk, initial_state=s0), y)


def test_ssd_kernel_takes_strided_slices(cuda):
    """x, B and C as the model hands them over: views of one projection
    with a row stride of the whole projection, no copy."""
    b, s, h, p, n = 2, 70, 4, 16, 32
    din = h * p
    rng = np.random.default_rng(7)
    proj = torch.from_numpy(rng.normal(size=(b, s, din + 2 * n + 5)).astype(np.float32))
    proj = proj.to(cuda, torch.bfloat16)
    x = proj[..., :din].reshape(b, s, h, p)
    B, C = proj[..., din:din + n], proj[..., din + n:din + 2 * n]
    dt = torch.from_numpy(rng.uniform(1e-3, 1e-1, (b, s, h)).astype(np.float32)).to(cuda)
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=cuda)
    assert not (x.is_contiguous() or B.is_contiguous())
    got = ssd_mod.ssd(x, dt, A, B, C, chunk=16)
    want = ssd_mod.ssd(x.contiguous(), dt, A, B.contiguous(), C.contiguous(), chunk=16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ssd_kernel_takes_aligned_strided_slices(cuda):
    """Views of a projection whose rows stay 16-byte aligned (width din +
    2n + 8): the vector loads of the tensor-core route, the same bits as
    the contiguous call and within the limit of the plain version."""
    b, s, h, p, n = 2, 90, 4, 32, 64
    din = h * p
    rng = np.random.default_rng(8)
    proj = torch.from_numpy(rng.normal(size=(b, s, din + 2 * n + 8)).astype(np.float32))
    proj = proj.to(cuda, torch.bfloat16)
    x = proj[..., :din].reshape(b, s, h, p)
    B, C = proj[..., din:din + n], proj[..., din + n:din + 2 * n]
    dt = torch.from_numpy(rng.uniform(1e-3, 1e-1, (b, s, h)).astype(np.float32)).to(cuda)
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=cuda)
    assert ssd_mod.plan(x.dtype, p, n, 32).kernel == "mma" and not x.is_contiguous()
    got = ssd_mod.ssd(x, dt, A, B, C, chunk=32)
    want = ssd_mod.ssd(x.contiguous(), dt, A, B.contiguous(), C.contiguous(), chunk=32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close(got, ref.ssd(x, dt, A, B, C), torch.bfloat16)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernel_row_alone_equals_row_in_a_batch(cuda, init):
    """A row's output and final state depend on that row's inputs only: row
    5 of a batch of 8 equals the same row run alone, bit for bit."""
    b, s, h, p, n = 8, 150, 4, 64, 128
    x, dt, A, B, C, s0 = _ssd_inputs(b, s, h, p, n, torch.bfloat16, cuda, 11, init)
    y, sf = ssd_mod.ssd(x, dt, A, B, C, initial_state=s0, return_state=True)
    one = lambda t: None if t is None else t[5:6].contiguous()
    y1, sf1 = ssd_mod.ssd(one(x), one(dt), A, one(B), one(C), initial_state=one(s0),
                          return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y[5:6], y1) and torch.equal(sf[5:6], sf1)


@pytest.mark.parametrize("dtype, kernels", [
    pytest.param(torch.bfloat16, {"ssd_kernel_chunk_state", "ssd_kernel_state_pass",
                                  "ssd_kernel_chunk_out"}, id="bfloat16"),
    pytest.param(torch.float32, {"ssd_kernel<float>"}, id="float32"),
])
def test_ssd_plan_routes_the_launches(cuda, dtype, kernels):
    """bf16 at mamba2-130m's widths (p 64, n 128, chunk 64) runs the three
    launches of csrc/ssd_tc.cu; float32 runs csrc/ssd.cu.  Read from the
    kernel names the profiler records."""
    from torch.profiler import ProfilerActivity, profile

    assert ssd_mod.plan(dtype, 64, 128, 64).kernel == ("mma" if dtype == torch.bfloat16
                                                       else "f32")
    x, dt, A, B, C, _ = _ssd_inputs(1, 70, 2, 64, 128, dtype, cuda, 12, False)
    ssd_mod.ssd(x, dt, A, B, C)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd_mod.ssd(x, dt, A, B, C)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "ssd_kernel" in e.key}
    assert {k for k in kernels if any(k in nm for nm in names)} == kernels
    assert len(names) == len(kernels), names


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C, s0 = _ssd_inputs(1, 8, 2, 64, 128, torch.bfloat16, cuda, 9, True)
    with pytest.raises(ValueError, match="dt must be float32"):
        ssd_mod.ssd(x, dt.double(), A, B, C)
    with pytest.raises(ValueError, match="share a dtype"):
        ssd_mod.ssd(x, dt, A, B.float(), C)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_mod.ssd(x, dt, A, B, C, initial_state=s0.bfloat16())
    with pytest.raises(ValueError, match="contiguous within a timestep"):
        ssd_mod.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C)
    with pytest.raises(TypeError, match="not supported"):
        ssd_mod.ssd(x.half(), dt, A, B.half(), C.half())
    long = _ssd_inputs(1, 256, 2, 64, 128, torch.bfloat16, cuda, 10, False)
    n0 = ssd_mod.launches
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        ssd_mod.ssd(*long[:5], chunk=256)
    assert ssd_mod.launches == n0
