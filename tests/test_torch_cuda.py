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
from repro_torch.models.lm import GLOBAL_WINDOW

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


FLASH_D80 = [
    # b, sq, sk, h, kvh, opts: zamba2's shared attention (32 heads of 80, MHA)
    # on the mma.sync kernel over Padded<80> tiles (rows of 88)
    (2, 100, 100, 32, 32, {}),                       # a static pass, a ragged last tile
    (1, 130, 130, 32, 32, {"causal": False}),
    (1, 50, 177, 32, 32, {"q_offset": 127}),         # an admission's q_offset over more keys
    (1, 70, 70, 8, 2, {"window": 9, "softcap": 6.0}),  # GQA, window and softcap
]


@pytest.mark.parametrize("case", FLASH_D80)
def test_flash_attention_bf16_head_dim_80(cuda, case):
    """The d-80 instance against its plain version; rows without a live
    key exactly zero."""
    b, sq, sk, h, kvh, opts = case
    q = _randn((b, sq, h, 80), torch.bfloat16, cuda, 79)
    k, v = (_randn((b, sk, kvh, 80), torch.bfloat16, cuda, s) for s in (80, 81))
    assert fa_mod.plan(torch.bfloat16, 80, h // kvh).kernel == "mma"
    n = fa_mod.launches
    out = fa_mod.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert fa_mod.launches == n + 1
    want = ref.attention(q.cpu(), k.cpu(), v.cpu(), **opts)
    _close(out, want, torch.bfloat16)
    dead = (want == 0).flatten(2).all(-1)
    assert torch.all(out.cpu()[dead] == 0)


FLASH_WHISPER = [
    # b, sq, sk, opts: whisper-large-v3's 20 heads of 64 (MHA) on the
    # mma.sync d-64 kernel, no RoPE
    (1, 1500, 1500, {"causal": False}),     # the encoder: 1500 frames, a ragged last tile
    (2, 300, 1500, {"causal": False}),      # a prompt's cross-attention over the frames
    (2, 24, 1500, {"causal": False}),       # a short prompt: one query tile, sq != sk
    (2, 100, 100, {}),                      # the decoder's causal self-attention
]


@pytest.mark.parametrize("case", FLASH_WHISPER)
def test_flash_attention_bf16_whisper_shapes(cuda, case):
    """Non-causal attention with sq != sk at d 64 against its plain version;
    without the last key (its values made large, so that each row's output
    leans on it) the plain version misses it."""
    b, sq, sk, opts = case
    q = _randn((b, sq, 20, 64), torch.bfloat16, cuda, 64)
    k, v = (_randn((b, sk, 20, 64), torch.bfloat16, cuda, s) for s in (65, 66))
    v[:, -1] = 50.0
    assert fa_mod.plan(torch.bfloat16, 64, 1).kernel == "mma"
    n = fa_mod.launches
    out = fa_mod.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert fa_mod.launches == n + 1
    qc, kc, vc = q.cpu(), k.cpu(), v.cpu()
    want = ref.attention(qc, kc, vc, **opts)
    _close(out, want, torch.bfloat16)
    if not opts.get("causal", True):
        short = ref.attention(qc, kc[:, :-1], vc[:, :-1], **opts)
        assert not bool(((out.float().cpu() - short.float()).abs()
                         <= 2e-2 * (1 + short.float().abs())).all())


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


WHISPER_DECODE = [
    # b, S, lengths, kv_bound: whisper-large-v3's 20 heads of 64 on 20 kv
    # heads (rep 1) on the bf16 split routine
    (8, 1504, [1500] * 8, 1500),            # the cross cache: 1500 frames in 1504 slots
    (3, 32, [20] * 3, 20),                  # reduced whisper at encoder_seq 20
    (8, 2048, [1030 + 9 * i for i in range(8)], 2048),   # the self cache at serve lengths
]


@pytest.mark.parametrize("case", WHISPER_DECODE)
def test_decode_attention_bf16_d64_rep1(cuda, case):
    """The one-token split routine over a dense cache whose slot count is a
    multiple of 16 and whose keys stop before its end: slots past the bound
    hold large values and are never read; the plain version one key short
    (each row's last live key given large values, so that its output
    leans on it) misses the kernel."""
    b, S, lens, bound = case
    q = _randn((b, 1, 20, 64), torch.bfloat16, cuda, 90)
    kc, vc = (_randn((b, S, 20, 64), torch.bfloat16, cuda, s) for s in (91, 92))
    kc[:, bound:] = 1e4
    vc[:, bound:] = 1e4
    for i, n in enumerate(lens):
        vc[i, n - 1] = 50.0
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert da_mod.decode_split.plan(torch.bfloat16, 64, 1, 1, da_mod.BLOCK_K).kernel == "mma"
    n = da_mod.launches
    out = da_mod.decode_attention(q, kc, vc, lengths, kv_bound=bound)
    torch.cuda.synchronize()
    assert da_mod.launches == n + 1
    args = (q.cpu(), kc[:, :bound].cpu(), vc[:, :bound].cpu())
    _close(out, ref.decode_attention(*args, lengths.cpu()), torch.bfloat16)
    short = ref.decode_attention(*args, lengths.cpu() - 1).float()
    assert not bool(((out.float().cpu() - short).abs() <= 2e-2 * (1 + short.abs())).all())


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


# ---------------------------------------------------------------------------
# the platform's torch predictor on the card
# ---------------------------------------------------------------------------
def _predictor_pair(arch, dev):
    """The torch predictor opened on the card and on the CPU for the reduced
    ``arch``, the card's handle holding the float32 model with the CPU's
    weights."""
    from repro_torch.core import NullTracer, OpenRequest, make_predictor
    from repro_torch.core.platform import builtin_manifests
    from repro_torch.models.lm import build_model

    manifest = next(m for m in builtin_manifests(reduced=True) if m.name == arch)
    pred = make_predictor("torch")
    card, cpu = (pred.open(OpenRequest(manifest=manifest, device=str(d)), NullTracer())
                 for d in (dev, "cpu"))
    card.state["model"] = build_model(card.state["cfg"], device=dev, dtype=torch.float32)
    card.state["params"] = _to(cpu.state["params"], dev)
    return pred, (card, cpu)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma2-27b", "chameleon-34b", "granite-20b",
                                  "deepseek-67b", "mamba2-130m", "whisper-large-v3"])
def test_predictor_card_vs_cpu(cuda, arch):
    """Reduced float32 logits on the card within 1e-4 + 1e-4 |cpu| of the
    CPU's (the CUDA-core float32 kernels against the plain versions), the
    same last-position argmax, and FRAMEWORK logits bit-equal to MODEL."""
    from repro_torch.core import NullTracer, Tracer, TraceLevel, TracingServer

    pred, (card, cpu) = _predictor_pair(arch, cuda)
    tokens = np.random.default_rng(5).integers(0, 256, (3, 21)).astype(np.int32)
    got = pred.predict(card, tokens, NullTracer())
    want = pred.predict(cpu, tokens, NullTracer())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1))
    framework = pred.predict(card, tokens, Tracer("t", TracingServer(), TraceLevel.FRAMEWORK))
    assert np.array_equal(framework, got)


@pytest.mark.parametrize("arch,per_pass", [("glm4-9b", {"flash_attention": 3, "rmsnorm": 7}),
                                           ("gemma2-27b", {"flash_attention": 4, "rmsnorm": 17}),
                                           ("chameleon-34b", {"flash_attention": 3, "rmsnorm": 13}),
                                           ("mamba2-130m", {"ssd": 3, "rmsnorm": 7}),
                                           # 2 encoder + 2 decoder self + 2 cross; 5 + 7 norms
                                           ("whisper-large-v3",
                                            {"flash_attention": 6, "rmsnorm": 12})])
def test_system_level_counts_the_kernels(cuda, arch, per_pass):
    """A SYSTEM evaluation on the card emits one ``system:cuda`` event per
    predict, whose launches add up to the counters' change, one pass's worth
    per ``inference`` span."""
    from repro_torch.core import EvaluationRequest, ScenarioSpec
    from repro_torch.core.platform import LocalPlatform
    from repro_torch.kernels import kernel_counters

    counters = kernel_counters()
    before = {k: m.launches for k, m in counters.items()}
    p = LocalPlatform(backends=("torch",), device="cuda")
    try:
        res = p.evaluate(EvaluationRequest(
            model=arch, scenario=ScenarioSpec(kind="online", num_requests=2, rate_hz=1000.0,
                                              warmup=1),
            trace_level="SYSTEM", seq_len=32))[0]
        spans = p.evaldb.spans(res["eval_id"])
    finally:
        p.shutdown()
    delta = {k: m.launches - before[k] for k, m in counters.items() if m.launches != before[k]}
    passes = sum(1 for s in spans if s["name"] == "inference")
    assert passes == 3 and delta == {k: n * passes for k, n in per_pass.items()}
    events = [s["tags"] for s in spans if s["name"] == "system:cuda"]
    assert len(events) == passes
    summed = {}
    for e in events:
        assert e["device_ms"] > 0 and e["max_memory_allocated"] > 0
        for k, n in e["launches"].items():
            summed[k] = summed.get(k, 0) + n
    assert summed == delta


def test_resnet_predictor_card_vs_cpu(cuda):
    """The reduced ResNet-50 in float32 (cuDNN, TF32 off) on the card within
    1e-4 of the CPU's largest logit; a SYSTEM evaluation on the card (bf16)
    launches no hand-written kernel and records device time."""
    from repro_torch.core import (EvaluationRequest, NullTracer, OpenRequest, ScenarioSpec,
                                  make_predictor)
    from repro_torch.core.platform import LocalPlatform, builtin_manifests
    from repro_torch.models import ResNet

    torch.backends.cudnn.allow_tf32 = False
    manifest = next(m for m in builtin_manifests(reduced=True) if m.name == "resnet50")
    pred = make_predictor("torch")
    card, cpu = (pred.open(OpenRequest(manifest=manifest, device=str(d)), NullTracer())
                 for d in (cuda, "cpu"))
    card.state["model"] = ResNet(card.state["cfg"], device=cuda, dtype=torch.float32)
    card.state["params"] = _to(cpu.state["params"], cuda)
    images = np.random.default_rng(6).normal(size=(3, 32, 32, 3)).astype(np.float32)
    got, want = pred.predict(card, images, NullTracer()), pred.predict(cpu, images, NullTracer())
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    p = LocalPlatform(backends=("torch",), device="cuda")
    try:
        res = p.evaluate(EvaluationRequest(
            model="resnet50", scenario=ScenarioSpec(kind="online", num_requests=2,
                                                    rate_hz=1000.0, warmup=1),
            trace_level="SYSTEM"))[0]
        spans = p.evaldb.spans(res["eval_id"])
    finally:
        p.shutdown()
    events = [s["tags"] for s in spans if s["name"] == "system:cuda"]
    assert len(events) == 3 and all(e["launches"] == {} and e["device_ms"] > 0 for e in events)


# ---------------------------------------------------------------------------
# the rest of the dense family's head layouts: granite-20b's 48 query heads
# on 1 kv head, chameleon-34b's 64 on 8, gemma2-27b's 32 on 16 with its
# attention softcap; windows wider than a key tile over contexts past them,
# and the global layers' GLOBAL_WINDOW
# ---------------------------------------------------------------------------
ZOO_LAYOUTS = [pytest.param((48, 1), id="granite"), pytest.param((64, 8), id="chameleon"),
               pytest.param((32, 16), id="gemma2")]
ZOO_OPTS = [pytest.param({}, id="plain"),
            pytest.param({"window": 100, "softcap": 50.0}, id="window100-softcap50"),
            # gemma2's global layers: the reference's window wider than any sequence
            pytest.param({"window": GLOBAL_WINDOW, "softcap": 50.0}, id="global-softcap50")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ZOO_LAYOUTS)
@pytest.mark.parametrize("opts", ZOO_OPTS)
def test_flash_attention_zoo_layouts(cuda, dtype, layout, opts):
    h, kvh = layout
    q = _randn((1, 300, h, 128), dtype, cuda, 500)
    k, v = (_randn((1, 300, kvh, 128), dtype, cuda, 501 + i) for i in range(2))
    _close(fa_mod.flash_attention(q, k, v, **opts),
           ref.attention(q.cpu(), k.cpu(), v.cpu(), **opts), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ZOO_LAYOUTS)
@pytest.mark.parametrize("opts", ZOO_OPTS)
def test_decode_attention_zoo_layouts(cuda, dtype, layout, opts):
    h, kvh = layout
    lens = [300, 150, 17, 0]
    q = _randn((4, 1, h, 128), dtype, cuda, 510)
    kc, vc = (_randn((4, 320, kvh, 128), dtype, cuda, 511 + i) for i in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = da_mod.decode_attention(q, kc, vc, lengths, kv_bound=320, **opts)
    _close(out, ref.decode_attention(*(t.cpu() for t in (q, kc, vc, lengths)), **opts), dtype)
    assert torch.all(out[-1] == 0)


def _zoo_pools(kvh, mode, dtype, dev):
    """A pool of 41 pages of 16 keys, as bf16/f32 or int8/fp8 codes with
    float32 scales, and a table of two requests of 20 pages each."""
    kp, vp = (_randn((41, 16, kvh, 128), dtype, dev, 520 + i) for i in range(2))
    table = (torch.randperm(40, generator=torch.Generator().manual_seed(1)) + 1).view(2, 20)
    pools = (kp, vp, None, None) if mode is None else _quantized(kp, vp, mode)
    return pools, table.to(torch.int32).to(dev)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("layout", ZOO_LAYOUTS)
@pytest.mark.parametrize("opts", ZOO_OPTS)
def test_paged_attention_zoo_layouts(cuda, mode, layout, opts):
    h, kvh = layout
    (kp, vp, ks, vs), table = _zoo_pools(kvh, mode, torch.bfloat16, cuda)
    q = _randn((2, 1, h, 128), torch.bfloat16, cuda, 525)
    lengths = torch.tensor([313, 97], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, lengths)
    out = pa_mod.paged_attention(*args, k_scales=ks, v_scales=vs, **opts)
    cpu = lambda t: None if t is None else t.cpu()
    want = ref.paged_attention(*(t.cpu() for t in args), k_scales=cpu(ks), v_scales=cpu(vs),
                               **opts)
    _close(out, want, torch.bfloat16)


@pytest.mark.parametrize("mode", [None, "int8"])
@pytest.mark.parametrize("layout", ZOO_LAYOUTS)
@pytest.mark.parametrize("opts", ZOO_OPTS)
def test_spec_verify_zoo_layouts(cuda, mode, layout, opts):
    h, kvh = layout
    (kp, vp, ks, vs), table = _zoo_pools(kvh, mode, torch.bfloat16, cuda)
    q = _randn((2, 5, h, 128), torch.bfloat16, cuda, 526)
    lengths = torch.tensor([300, 97], dtype=torch.int32, device=cuda)
    wl = torch.tensor([5, 3], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, lengths, wl)
    out = sv_mod.spec_verify(*args, k_scales=ks, v_scales=vs, **opts)
    cpu = lambda t: None if t is None else t.cpu()
    want = ref.spec_verify(*(t.cpu() for t in args), k_scales=cpu(ks), v_scales=cpu(vs), **opts)
    _close(out, want, torch.bfloat16)


@pytest.mark.parametrize("mode", [None, "int8"])
@pytest.mark.parametrize("layout", ZOO_LAYOUTS)
@pytest.mark.parametrize("opts", ZOO_OPTS)
def test_varlen_prefill_zoo_layouts(cuda, mode, layout, opts):
    """A 40-token chunk at pos0 256 over 16 context pages (the window of 100
    leaves the first 12 of them dead) beside a fresh 23-token chunk."""
    h, kvh = layout
    (kp, vp, ks, vs), table = _zoo_pools(kvh, mode, torch.bfloat16, cuda)
    T = 48 + 32
    q = _randn((T, h, 128), torch.bfloat16, cuda, 527)
    k, v = (_randn((T, kvh, 128), torch.bfloat16, cuda, 528 + i) for i in range(2))
    meta = [torch.tensor(x, dtype=torch.int32, device=cuda)
            for x in ([0, 48, 80], [40, 23], [256, 0])]
    args = (q, k, v, kp, vp, *meta, table)
    out = vp_mod.varlen_prefill(*args, k_scales=ks, v_scales=vs, **opts)
    cpu = lambda t: None if t is None else t.cpu()
    want = ref.varlen_prefill(*(t.cpu() for t in args), k_scales=cpu(ks), v_scales=cpu(vs),
                              **opts)
    _close(out, want, torch.bfloat16)


@pytest.mark.parametrize("D", [128, 4608, 6144, 8192])
def test_rmsnorm_zoo_widths(cuda, D):
    """QK-norm rows of 128 (64 heads a token) and the zoo's d_model."""
    x = _randn((64 * 5 if D == 128 else 5, D), torch.bfloat16, cuda, 530) * 3.0
    w = _randn((D,), torch.bfloat16, cuda, 531) * 0.1
    _close(rn_mod.rmsnorm(x, w), ref.rmsnorm(x, w), torch.bfloat16)


# ---------------------------------------------------------------------------
# chunked prefill's flash shapes and the prefix cache's page copy
# ---------------------------------------------------------------------------
CHUNKED_FLASH = [
    # h, kvh, pos0, c, opts: a c-token chunk at q_offset pos0 over pos0 + c
    # keys; 16 and 48 put the causal diagonal inside a 32-key tile
    (32, 2, 0, 64, {}),                                # glm4-9b: a prompt's first chunk
    (32, 2, 16, 64, {}),
    (32, 2, 48, 64, {}),
    (32, 2, 64, 16, {}),                               # last chunks, padded to a page
    (32, 2, 256, 32, {}),
    (32, 2, 960, 48, {}),
    (32, 2, 1984, 64, {}),                             # the last chunk of max_seq 2048
    (32, 16, 4160, 64, {"window": 4096, "softcap": 50.0}),  # gemma2-27b, past the window
    (32, 16, 4160, 64, {"window": GLOBAL_WINDOW, "softcap": 50.0}),
    (48, 1, 1008, 64, {}),                             # granite-20b: 3072 rows per kv head
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CHUNKED_FLASH)
def test_flash_attention_chunked_prefill_shapes(cuda, dtype, case):
    h, kvh, pos0, c, opts = case
    q = _randn((1, c, h, 128), dtype, cuda, 540)
    k, v = (_randn((1, pos0 + c, kvh, 128), dtype, cuda, 541 + i) for i in range(2))
    out = fa_mod.flash_attention(q, k, v, q_offset=pos0, **opts)
    _close(out, ref.attention(q.cpu(), k.cpu(), v.cpu(), q_offset=pos0, **opts), dtype)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_copy_pages_on_the_card(cuda, mode):
    """Pages and their scale rows copied in place in every layer, the pools
    not reallocated; the CPU version gives the same bytes."""
    from repro_torch.kernels import ops

    shape = (3, 12, 16, 2, 128)
    kv = [_randn(shape, torch.bfloat16, cuda, 550 + i) for i in range(2)]
    # (k, v) or (k codes, v codes, k scales, v scales)
    pools = kv if mode is None else [
        t for pair in zip(*[kvquant.quantize(x, kvquant.pool_dtype(mode)) for x in kv])
        for t in pair]
    host = [t.cpu() for t in pools]
    ptrs = [t.data_ptr() for t in pools]
    src, dst = [3, 7, 1], [9, 2, 11]
    ops.copy_pages(pools[0], pools[1], src, dst, *pools[2:])
    ops.copy_pages(host[0], host[1], src, dst, *host[2:])
    assert [t.data_ptr() for t in pools] == ptrs
    raw = lambda t: t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
    for t, h in zip(pools, host):
        assert torch.equal(raw(t.cpu()), raw(h))


# ---------------------------------------------------------------------------
# the fleet: a crash migrated on the card, as on the CPU
# ---------------------------------------------------------------------------
def test_fleet_crash_migrate_card_vs_cpu(cuda):
    """Reduced glm4-9b in float32, three workers a fleet, one crash with
    migration: the card's completed tokens, outcomes and migration counters
    equal the CPU's, and every snapshot is host bytes that verify."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import ServeRequest, ServingEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.fleet import FleetConfig, FleetRouter

    cfg = get_config("glm4-9b", reduced=True)
    cpu_model = DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu_params = cpu_model.init(seed=0)
    gpu_model = DecoderLM(cfg, device=cuda, dtype=torch.float32)
    gpu_params = _params_to(cpu_params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(5, 30, 8)]
    runs = {}
    for name, model, params in (("cpu", cpu_model, cpu_params), ("cuda", gpu_model, gpu_params)):
        engines = [ServingEngine(model, params, max_batch=4, max_seq=64, page_size=8,
                                 device=model.device) for _ in range(3)]
        router = FleetRouter(engines, FleetConfig(recovery="migrate", checkpoint_every=2),
                             engine_kwargs=dict(num_slots=4, page_size=8, prefix_cache=True),
                             fault_plan=FaultPlan.parse("crash@1:4"))
        runs[name] = router.serve([ServeRequest(request_id=i, prompt=p, max_new_tokens=8)
                                   for i, p in enumerate(prompts)])
        snaps = [s for w in router.workers for s in w.checkpoints.values()]
        assert snaps and all(s.k.device.type == "cpu" and s.verify() for s in snaps)
    cpu, gpu = runs["cpu"], runs["cuda"]
    assert gpu.completed == cpu.completed == len(prompts)
    assert gpu.deaths == 1 and gpu.migrated > 0
    for field in ("migrated", "migrated_tokens", "bytes_moved", "requeued",
                  "recomputed_prefill_tokens", "checkpoints_saved"):
        assert getattr(gpu, field) == getattr(cpu, field), field
    for a, b in zip(gpu.results, cpu.results):
        assert (a.status, a.worker, a.attempts) == (b.status, b.worker, b.attempts)
        assert np.array_equal(a.tokens, b.tokens), a.request_id


def _params_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _params_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# The training path: the forward's log-sum-exp, the backward kernels, the
# train step card vs CPU and the refusals
# ---------------------------------------------------------------------------
BWD_OPTS = [{}, {"window": 7}, {"softcap": 2.0}, {"causal": False},
            {"q_offset": 30, "window": 50}]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("opts", BWD_OPTS)
def test_flash_attention_bwd_kernel(cuda, dtype, shape, opts):
    from repro_torch.kernels import flash_attention_bwd as fb_mod

    b, sq, sk, h, kvh, d = shape
    q = _randn((b, sq, h, d), dtype, cuda, 90)
    k, v = _randn((b, sk, kvh, d), dtype, cuda, 91), _randn((b, sk, kvh, d), dtype, cuda, 92)
    do = _randn((b, sq, h, d), dtype, cuda, 93)
    o, lse = fa_mod.flash_attention(q, k, v, return_lse=True, **opts)
    assert torch.equal(o, fa_mod.flash_attention(q, k, v, **opts))
    _, lse_plain = ref.attention_lse(q.cpu(), k.cpu(), v.cpu(), **opts)
    _close(lse, lse_plain, dtype)
    n = fb_mod.launches
    got = fb_mod.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    assert fb_mod.launches == n + 1
    want = ref.flash_attention_bwd(*(t.cpu() for t in (q, k, v, o, lse, do)), **opts)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close(g, w, dtype, f32_tol=1e-4)


@pytest.mark.parametrize("case", [
    pytest.param((torch.bfloat16, (2, 50, 50, 6, 2, 16), {"softcap": 2.0}), id="bfloat16-d16"),
    pytest.param((torch.bfloat16, (1, 70, 90, 32, 32, 80), {"q_offset": 20}), id="bfloat16-d80"),
    pytest.param((torch.float32, (1, 33, 33, 4, 2, 40), {"window": 9}), id="float32-d40"),
])
def test_flash_attention_bwd_other_head_dims(cuda, case):
    from repro_torch.kernels import flash_attention_bwd as fb_mod

    dtype, (b, sq, sk, h, kvh, d), opts = case
    q = _randn((b, sq, h, d), dtype, cuda, 110)
    k, v = (_randn((b, sk, kvh, d), dtype, cuda, s) for s in (111, 112))
    do = _randn((b, sq, h, d), dtype, cuda, 113)
    o, lse = fa_mod.flash_attention(q, k, v, return_lse=True, **opts)
    got = fb_mod.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    want = ref.flash_attention_bwd(*(t.cpu() for t in (q, k, v, o, lse, do)), **opts)
    for g, w in zip(got, want):
        _close(g, w, dtype, f32_tol=1e-4)


def test_flash_attention_bwd_rows_without_live_keys(cuda):
    """q_offset 40 with window 4 over 40 keys: only the first three rows
    see a key; the others store the empty lse and get dq exactly 0."""
    from repro_torch.kernels import flash_attention_bwd as fb_mod

    q = _randn((1, 16, 32, 128), torch.bfloat16, cuda, 94)
    k, v = (_randn((1, 40, 2, 128), torch.bfloat16, cuda, s) for s in (95, 96))
    do = _randn((1, 16, 32, 128), torch.bfloat16, cuda, 97)
    o, lse = fa_mod.flash_attention(q, k, v, window=4, q_offset=40, return_lse=True)
    assert bool((lse[:, :, 3:] == ref.LSE_EMPTY).all()) and bool((lse[:, :, :3] < 1e30).all())
    dq, dk, dv = fb_mod.flash_attention_bwd(q, k, v, o, lse, do, window=4, q_offset=40)
    assert bool((dq[:, 3:] == 0).all()) and bool((dk[:, :36] == 0).all())
    want = ref.flash_attention_bwd(*(t.cpu() for t in (q, k, v, o, lse, do)), window=4,
                                   q_offset=40)
    for g, w in zip((dq, dk, dv), want):
        _close(g, w, torch.bfloat16)


@pytest.mark.parametrize("case", [
    pytest.param(((4, 512, 512, 32, 2, 128), {}), id="d128-rep16-8-splits"),
    pytest.param(((2, 300, 300, 32, 32, 80), {"softcap": 2.0}), id="d80-rep1"),
    pytest.param(((2, 200, 260, 16, 2, 64), {"window": 70, "q_offset": 60}), id="d64-window"),
])
def test_flash_attention_bwd_tensor_cores_same_bits_twice(cuda, case):
    """The bf16 tensor-core route (splits where the group is wide): right
    against the plain version, and the same bits for dq, dk, dv on two runs
    (no atomics)."""
    from repro_torch.kernels import flash_attention_bwd as fb_mod

    (b, sq, sk, h, kvh, d), opts = case
    assert fb_mod.route(torch.bfloat16, d) == "tc"
    q = _randn((b, sq, h, d), torch.bfloat16, cuda, 120)
    k, v = (_randn((b, sk, kvh, d), torch.bfloat16, cuda, s) for s in (121, 122))
    do = _randn((b, sq, h, d), torch.bfloat16, cuda, 123)
    o, lse = fa_mod.flash_attention(q, k, v, return_lse=True, **opts)
    got = fb_mod.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    again = fb_mod.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = ref.flash_attention_bwd(*(t.cpu() for t in (q, k, v, o, lse, do)), **opts)
    for g, w in zip(got, want):
        _close(g, w, torch.bfloat16)


@pytest.mark.parametrize("d, kvh", [(80, 32), (128, 2)])
def test_flash_attention_bwd_takes_the_tensor_cores(cuda, d, kvh):
    """At the head dims phase 4c trains the backward's kernels are the
    tensor-core ones (their names in the profiler), and float32 at d 128
    stays on the CUDA cores."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention_bwd as fb_mod

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = _randn((1, 64, 32, d), dtype, cuda, 124)
        k, v = (_randn((1, 64, kvh, d), dtype, cuda, s) for s in (125, 126))
        do = _randn((1, 64, 32, d), dtype, cuda, 127)
        o, lse = fa_mod.flash_attention(q, k, v, return_lse=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fb_mod.flash_attention_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.key for e in prof.key_averages())
    assert "flash_bwd_dkdv_tc_kernel" in names[torch.bfloat16]
    assert "flash_bwd_dq_tc_kernel" in names[torch.bfloat16]
    assert "flash_bwd_dkdv_kernel" in names[torch.float32]
    assert "_tc_kernel" not in names[torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 4096), (3, 5, 100), (600, 128), (2, 70000), (4096, 768),
                                   (300, 5120), (70, 2560)])
def test_rmsnorm_bwd_kernel(cuda, dtype, shape):
    from repro_torch.kernels import rmsnorm_bwd as rb_mod

    x, dy = _randn(shape, dtype, cuda, 98), _randn(shape, dtype, cuda, 99)
    w = _randn(shape[-1:], dtype, cuda, 100) * 0.1
    n = rb_mod.launches
    dx, dw = rb_mod.rmsnorm_bwd(x, w, 1e-6, dy)
    torch.cuda.synchronize()
    assert rb_mod.launches == n + 1
    want = ref.rmsnorm_bwd(x.cpu(), w.cpu(), 1e-6, dy.cpu())
    _close(dx, want[0], dtype)
    _close(dw, want[1], dtype, f32_tol=1e-4)
    assert torch.equal(rb_mod.rmsnorm_bwd(x, w, 1e-6, dy)[1], dw)


def test_functions_run_the_backward_kernels(cuda):
    from repro_torch.kernels import flash_attention_bwd as fb_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm_bwd as rb_mod

    q = _randn((2, 64, 32, 128), torch.bfloat16, cuda, 101).requires_grad_()
    k = _randn((2, 64, 2, 128), torch.bfloat16, cuda, 102).requires_grad_()
    v = _randn((2, 64, 2, 128), torch.bfloat16, cuda, 103).requires_grad_()
    w = (_randn((128,), torch.bfloat16, cuda, 104) * 0.1).requires_grad_()
    nf, nr = fb_mod.launches, rb_mod.launches
    out = ops.rmsnorm(ops.attention(q, k, v), w)
    out.float().square().sum().backward()
    assert fb_mod.launches == nf + 1 and rb_mod.launches == nr + 1
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v, w))


def test_train_step_card_vs_cpu(cuda):
    """Reduced glm4-9b in float32, 2 steps at 2 microbatches with remat, on
    the card and on the CPU from the same masters: loss and grad_norm
    within 1e-4 relative."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

    cfg = get_config("glm4-9b", reduced=True)
    masters = build_model(cfg, "cpu").init(0)
    toks = torch.from_numpy(np.random.default_rng(105).integers(0, cfg.vocab_size, (4, 16)))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev, torch.float32)
        opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        # a copy each: the optimizer updates in place
        params = _params_to(_params_to(masters, cuda), dev)
        state = init_opt_state(model.param_defs(), opt, dev)
        step = make_train_step(model, opt, microbatches=2, remat=True)
        ms = []
        for _ in range(2):
            params, state, m = step(params, state, {"tokens": toks.to(dev)})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(dev)] = ms
    for (a, b), (c, d) in zip(out["cuda"], out["cpu"]):
        assert abs(a - c) <= 1e-4 * abs(c) and abs(b - d) <= 1e-4 * abs(d)


def test_ssm_trains_on_the_card(cuda):
    """Reduced mamba2-130m in float32: one train step on the card through
    the ssd forward and backward kernels, from the CPU's masters and batch:
    loss and grad_norm within 1e-4 relative of the CPU's step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_bwd as sb_mod
    from repro_torch.models import build_model
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

    cfg = get_config("mamba2-130m", reduced=True)
    masters = build_model(cfg, "cpu").init(0)
    toks = torch.from_numpy(np.random.default_rng(106).integers(0, cfg.vocab_size, (4, 16)))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev, torch.float32)
        opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        params = _params_to(_params_to(masters, cuda), dev)
        state = init_opt_state(model.param_defs(), opt, dev)
        before = sb_mod.launches
        _, _, m = make_train_step(model, opt, remat=True)(params, state, {"tokens": toks.to(dev)})
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]), sb_mod.launches - before)
    (a, b, n_gpu), (c, d, n_cpu) = out["cuda"], out["cpu"]
    assert n_gpu == cfg.num_layers and n_cpu == 0
    assert abs(a - c) <= 1e-4 * abs(c) and abs(b - d) <= 1e-4 * abs(d)
