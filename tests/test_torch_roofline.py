"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): the counter's FLOPs against ``HloCostModel`` on the
reference's own cases and on a reduced glm4-9b forward, its bytes, the
copied configs and report arithmetic, every kernel bound of ``PERF.md``
§6 from ``work.py``, each kernel-backed op counting its work once and
nothing of its plain version, and the predictor's SYSTEM cost event."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import shape_applicable as ref_shape_applicable
from repro.models import build_model as ref_build_model
from repro.roofline.hlo import HloCostModel
from repro.roofline.model import TPU_V5E, roofline_from_compiled
from repro.roofline.model import model_flops_for as ref_model_flops_for
from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs, shape_applicable
from repro_torch.core import OpenRequest, Tracer, TraceLevel, TracingServer, make_predictor
from repro_torch.core.platform import builtin_manifests
from repro_torch.kernels import ops, ref
from repro_torch.models import ResNet, ResNetConfig, build_model
from repro_torch.roofline import (
    Costs,
    H100_SXM,
    HardwareSpec,
    RooflineReport,
    count_costs,
    counting,
    model_flops_for,
    roofline_from_costs,
    work,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hlo(fn, *shapes):
    """HloCostModel of ``fn`` compiled for float32 arguments of ``shapes``."""
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return HloCostModel(jax.jit(fn).lower(*args).compile().as_text()).entry_costs()


def _counted(fn, *args):
    with count_costs() as costs:
        fn(*args)
    return costs


# -- (a) the reference's HloCostModel cases ----------------------------------------

def _scan_jax(x, ws):
    def body(c, w):
        return jnp.maximum(c @ w, 0.0), None

    out, _ = jax.lax.scan(body, x, ws)
    return out.sum()


def _scan_torch(x, ws):
    c = x
    for w in ws:
        c = torch.relu(c @ w)
    return c.sum()


def _nested_jax(x, ws):
    def outer(c, wpair):
        def inner(c2, w):
            return c2 @ w, None

        c2, _ = jax.lax.scan(inner, c, wpair)
        return c2, None

    out, _ = jax.lax.scan(outer, x, ws)
    return out.sum()


def _nested_torch(x, ws):
    c = x
    for wpair in ws:
        for w in wpair:
            c = c @ w
    return c.sum()


def _unrolled(x, ws):
    for i in range(6):
        x = x @ ws[i]
    return x


@pytest.mark.parametrize("case", [
    ("scan of 12 products of 64^3", _scan_jax, _scan_torch, (64, 64), (12, 64, 64)),
    ("nested 3 x 4 products of 32^3", _nested_jax, _nested_torch, (32, 32), (3, 4, 32, 32)),
    ("6 unrolled products of 64^3", _unrolled, _unrolled, (64, 64), (6, 64, 64)),
], ids=lambda c: c[0])
def test_counted_flops_equal_the_reference_hlo_cost_model(case):
    _, jfn, tfn, xs, ws = case
    want = _hlo(jfn, xs, ws).flops
    got = _counted(tfn, torch.randn(xs), torch.randn(ws)).flops
    assert got == want
    assert got == math.prod(ws[:-2]) * 2 * xs[0] * xs[1] * ws[-1]


# -- (b) bytes -----------------------------------------------------------------------

def test_bytes_are_operands_plus_outputs_and_views_move_none():
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    c = _counted(lambda: x @ w)
    assert c.memory_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert c.flops == 2 * 8 * 4 * 16
    y = torch.randn(8, 16, dtype=torch.bfloat16)
    c = _counted(lambda: y + y)
    assert (c.flops, c.memory_bytes) == (0.0, 2 * 3 * 8 * 16)
    c = _counted(lambda: x.reshape(128).view(16, 8).t()[3:5].unsqueeze(0))
    assert (c.flops, c.memory_bytes) == (0.0, 0.0)
    c = _counted(lambda: torch.empty(1 << 20))
    assert c.memory_bytes == 0.0


def test_a_gather_reads_its_rows_and_an_indexed_write_its_update():
    table, idx = torch.randn(1000, 64), torch.tensor([3, 7, 11])
    c = _counted(lambda: torch.nn.functional.embedding(idx, table))
    assert c.memory_bytes == 2 * 3 * 64 * 4 + 3 * 8
    pool, vals = torch.zeros(1000, 64), torch.randn(3, 64)

    def write():
        pool[idx] = vals

    assert _counted(write).memory_bytes == 2 * 3 * 64 * 4 + 3 * 8


def test_convolution_flops_and_no_counter_outside():
    x, w = torch.randn(2, 3, 9, 9), torch.randn(5, 3, 3, 3)
    c = _counted(lambda: torch.nn.functional.conv2d(x, w, stride=2))
    assert c.flops == 2 * (2 * 5 * 4 * 4) * (3 * 3 * 3)
    assert not counting()
    with count_costs():
        assert counting()
        with pytest.raises(RuntimeError):
            with count_costs():
                pass
    assert not counting()


def test_costs_add_and_scale_as_the_reference():
    a = Costs(flops=2.0, memory_bytes=3.0, collective_bytes=1.0, by_collective={"all-reduce": 1.0},
              collective_count={"all-reduce": 1}, by_kernel={"rmsnorm": (1, 4.0, 5.0)})
    a += Costs(flops=1.0, by_kernel={"rmsnorm": (2, 1.0, 1.0)})
    assert (a.flops, a.memory_bytes, a.by_kernel["rmsnorm"]) == (3.0, 3.0, (3, 5.0, 6.0))
    s = a.scaled(2.0)
    assert (s.flops, s.collective_count, s.by_kernel["rmsnorm"]) == (6.0, {"all-reduce": 2},
                                                                      (6, 10.0, 12.0))


# -- (c) configs and the report ------------------------------------------------------

def test_shapes_and_applicability_equal_the_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in REF_SHAPES.items()}
    assert ShapeSpec("x", 1, 2, "train") == ShapeSpec("x", 1, 2, "train")
    for arch in list_archs():
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                ref_shape_applicable(ref_get_config(arch), REF_SHAPES[name]), (arch, name)
    for n, tokens, kind in ((9_000_000_000, 4096, "train"), (130_000_000, 32, "infer")):
        assert model_flops_for(n, tokens, kind) == ref_model_flops_for(n, tokens, kind)


def test_roofline_from_costs_equals_the_reference_arithmetic():
    def f(x, ws):
        return _scan_jax(x, ws) + jnp.tanh(x).sum()

    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in ((64, 64), (12, 64, 64))]
    compiled = jax.jit(f).lower(*args).compile()
    hc = HloCostModel(compiled.as_text()).entry_costs()
    kw = dict(arch="glm4-9b", shape="train_4k", mesh_name="1x1", chips=2, model_flops=5.0e6)
    want = roofline_from_compiled(compiled, hw=TPU_V5E, **kw)
    costs = Costs(flops=hc.flops, memory_bytes=hc.memory_bytes,
                  collective_bytes=hc.collective_bytes, by_collective=dict(hc.by_collective),
                  collective_count=dict(hc.collective_count))
    hw = HardwareSpec(**{k: getattr(TPU_V5E, k) for k in HardwareSpec.__dataclass_fields__})
    got = roofline_from_costs(costs, hw=hw, **kw)
    for field in ("flops_per_device", "memory_bytes_per_device", "compute_term_s",
                  "memory_term_s", "collective_term_s", "dominant", "model_flops_ratio",
                  "step_time_bound_s", "roofline_fraction"):
        assert getattr(got, field) == getattr(want, field), field
    assert RooflineReport.from_dict(got.to_dict()) == got
    assert set(got.to_dict()) == set(want.to_dict())
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.hbm_bytes) == (989e12, 3.35e12, 80e9)


# -- (d) every bound of PERF.md §6 from work.py --------------------------------------

_SERVE = np.random.default_rng(0).integers(64, 1024 + 1, size=16)   # chip_smoke's serve mix
_LENS = [int(n) + 32 for n in _SERVE[:8]]                          # a decode step's lengths
_S_PASS, _S_ADM = int(max(_SERVE[:8])), int(max(_SERVE))
_PB = math.ceil(max(_LENS) / 16)
_WIN = [min(n, 4096) for n in _LENS]
_WL = [5, 3, 1, 0, 5, 2, 4, 5]
_SPEC_KEYS = sum(L + n for L, n in zip(_LENS, _WL) if n)
_SPEC_PAIRS = sum(L + w + 1 for L, n in zip(_LENS, _WL) for w in range(n))
_SPEC_TABLE = 8 * math.ceil(max(L + n for L, n in zip(_LENS, _WL) if n) / 16)
_GLM_CHUNKS = [(300, 640), (517, 0), (1, 1008), (640, 192), (200, 0), (0, 0), (0, 0), (0, 0)]
_TWO = [(1024, 512), (1024, 0)]
W = work
BOUNDS = [
    ("rmsnorm 2048 x 4096", W.rmsnorm(2048, 4096), "0.0100"),
    ("rmsnorm 8 x 4096", W.rmsnorm(8, 4096), "0.000042"),
    ("rmsnorm 2048 x 4608", W.rmsnorm(2048, 4608), "0.0113"),
    ("rmsnorm 2048 x 6144", W.rmsnorm(2048, 6144), "0.0150"),
    ("rmsnorm 2048 x 8192", W.rmsnorm(2048, 8192), "0.0200"),
    ("rmsnorm QK-norm 131072 x 128", W.rmsnorm(131072, 128), "0.0200"),
    ("rmsnorm QK-norm 512 x 128", W.rmsnorm(512, 128), "0.0001"),
    ("rmsnorm qwen3 2048 x 2048", W.rmsnorm(2048, 2048), "0.0050"),
    ("rmsnorm qwen3 8 x 2048", W.rmsnorm(8, 2048), "0.000021"),
    ("rmsnorm qwen3 QK-norm 65536 x 128", W.rmsnorm(65536, 128), "0.0100"),
    ("rmsnorm qwen3 QK-norm 8192 x 128", W.rmsnorm(8192, 128), "0.0013"),
    ("rmsnorm qwen3 QK-norm 256 x 128", W.rmsnorm(256, 128), "0.00004"),
    ("rmsnorm zamba2 7048 x 2560", W.rmsnorm(8 * _S_PASS, 2560), "0.0215"),
    ("rmsnorm zamba2 8 x 2560", W.rmsnorm(8, 2560), "0.00003"),
    ("rmsnorm zamba2 7048 x 5120", W.rmsnorm(8 * _S_PASS, 5120), "0.0431"),
    ("rmsnorm zamba2 8 x 5120", W.rmsnorm(8, 5120), "0.00005"),
    ("rmsnorm whisper 12000 x 1280", W.rmsnorm(12000, 1280), "0.0183"),
    ("rmsnorm whisper 8 x 1280", W.rmsnorm(8, 1280), "0.00001"),
    ("rmsnorm_bwd 4096 x 4096", W.rmsnorm_bwd(4096, 4096), "0.0301"),
    ("rmsnorm_bwd 8 x 4096", W.rmsnorm_bwd(8, 4096), "0.0001"),
    ("rmsnorm_bwd mamba2 4096 x 768", W.rmsnorm_bwd(4096, 768), "0.0056"),
    ("rmsnorm_bwd zamba2 2048 x 2560", W.rmsnorm_bwd(2048, 2560), "0.0094"),
    ("rmsnorm_bwd zamba2 2048 x 5120", W.rmsnorm_bwd(2048, 5120), "0.0188"),
    ("paged_attention bf16 over 3368 live tokens",
     W.paged_attention(8, 32, 2, 128, sum(_LENS), 8 * _PB), "0.0011"),
    ("paged_attention int8/fp8",
     W.paged_attention(8, 32, 2, 128, sum(_LENS), 8 * _PB, quantized=True), "0.0006"),
    ("paged_attention gemma2 4500-6000 keys, window 4096",
     W.paged_attention(8, 32, 16, 128, 8 * 4096, 8 * math.ceil(6000 / 16)), "0.0802"),
    ("paged_attention gemma2 serve lengths", W.paged_attention(8, 32, 16, 128, sum(_WIN), 8 * _PB),
     "0.0083"),
    ("paged_attention granite", W.paged_attention(8, 48, 1, 128, sum(_LENS), 8 * _PB), "0.0006"),
    ("paged_attention chameleon", W.paged_attention(8, 64, 8, 128, sum(_LENS), 8 * _PB), "0.0042"),
    ("paged_attention qwen3 bf16", W.paged_attention(8, 32, 4, 128, sum(_LENS), 8 * _PB), "0.0021"),
    ("paged_attention qwen3 int8",
     W.paged_attention(8, 32, 4, 128, sum(_LENS), 8 * _PB, quantized=True), "0.0011"),
    ("varlen_prefill bf16", W.varlen_prefill(2048, 32, 2, 128, _GLM_CHUNKS, 8 * 128), "0.0119"),
    ("varlen_prefill int8/fp8",
     W.varlen_prefill(2048, 32, 2, 128, _GLM_CHUNKS, 8 * 128, quantized=True), "0.0119"),
    ("varlen_prefill gemma2 T 2048 at pos0 4096, window 4096",
     W.varlen_prefill(2048, 32, 16, 128, [(2048, 4096)], 384, window=4096), "0.1390"),
    ("varlen_prefill gemma2 two chunks",
     W.varlen_prefill(2048, 32, 16, 128, _TWO, 320, window=4096), "0.0261"),
    ("varlen_prefill granite two chunks", W.varlen_prefill(2048, 48, 1, 128, _TWO, 320), "0.0391"),
    ("varlen_prefill chameleon two chunks", W.varlen_prefill(2048, 64, 8, 128, _TWO, 320),
     "0.0521"),
    ("varlen_prefill qwen3 bf16", W.varlen_prefill(2048, 32, 4, 128, _GLM_CHUNKS, 8 * 128),
     "0.0124"),
    ("varlen_prefill qwen3 int8",
     W.varlen_prefill(2048, 32, 4, 128, _GLM_CHUNKS, 8 * 128, quantized=True), "0.0119"),
    ("spec_verify bf16", W.spec_verify(8, 5, 32, 2, 128, _SPEC_KEYS, _SPEC_PAIRS, _SPEC_TABLE),
     "0.0011"),
    ("spec_verify int8/fp8", W.spec_verify(8, 5, 32, 2, 128, _SPEC_KEYS, _SPEC_PAIRS, _SPEC_TABLE,
                                           quantized=True), "0.0007"),
    ("spec_verify qwen3 bf16",
     W.spec_verify(8, 5, 32, 4, 128, _SPEC_KEYS, _SPEC_PAIRS, _SPEC_TABLE), "0.0021"),
    ("spec_verify qwen3 int8", W.spec_verify(8, 5, 32, 4, 128, _SPEC_KEYS, _SPEC_PAIRS,
                                             _SPEC_TABLE, quantized=True), "0.0012"),
    ("decode_attention bf16 over 3368 live tokens", W.decode_attention(8, 32, 2, 128, sum(_LENS)),
     "0.0011"),
    ("decode_attention gemma2 (8, 8192), window 4096", W.decode_attention(8, 32, 16, 128, 8 * 4096),
     "0.0802"),
    ("decode_attention gemma2 serve lengths", W.decode_attention(8, 32, 16, 128, sum(_WIN)),
     "0.0083"),
    ("decode_attention granite", W.decode_attention(8, 48, 1, 128, sum(_LENS)), "0.0006"),
    ("decode_attention chameleon", W.decode_attention(8, 64, 8, 128, sum(_LENS)), "0.0042"),
    ("decode_attention qwen3", W.decode_attention(8, 32, 4, 128, sum(_LENS)), "0.0021"),
    ("decode_attention zamba2 static step", W.decode_attention(8, 32, 32, 80, 8 * (_S_PASS + 32)),
     "0.0224"),
    ("decode_attention zamba2 continuous step",
     W.decode_attention(8, 32, 32, 80, sum(_S_ADM + 1 + 4 * i for i in range(8))), "0.0247"),
    ("decode_attention zamba2 full ring", W.decode_attention(8, 32, 32, 80, 8 * 4096), "0.1002"),
    ("decode_attention whisper cross cache", W.decode_attention(8, 20, 20, 64, 8 * 1500), "0.0184"),
    ("decode_attention whisper self cache", W.decode_attention(8, 20, 20, 64, sum(_LENS)),
     "0.0052"),
    ("flash_attention static pass", W.flash_attention(8, 1024, 1024, 32, 2, 128), "0.0696"),
    ("flash_attention admission", W.flash_attention(1, 1024, 1024, 32, 2, 128), "0.0087"),
    ("flash_attention gemma2 (1, 8192), window 4096",
     W.flash_attention(1, 8192, 8192, 32, 16, 128, window=4096), "0.4169"),
    ("flash_attention gemma2 (1, 8192)", W.flash_attention(1, 8192, 8192, 32, 16, 128), "0.5559"),
    ("flash_attention gemma2 static pass, window 4096",
     W.flash_attention(8, 1024, 1024, 32, 16, 128, window=4096), "0.0696"),
    ("flash_attention granite static pass", W.flash_attention(8, 1024, 1024, 48, 1, 128), "0.1043"),
    ("flash_attention chameleon static pass", W.flash_attention(8, 1024, 1024, 64, 8, 128),
     "0.1391"),
    ("flash_attention chunk at 16", W.flash_attention(1, 64, 80, 32, 2, 128, q_offset=16),
     "0.0003"),
    ("flash_attention chunk at 48", W.flash_attention(1, 64, 112, 32, 2, 128, q_offset=48),
     "0.0003"),
    ("flash_attention chunk at 1008", W.flash_attention(1, 64, 1072, 32, 2, 128, q_offset=1008),
     "0.0011"),
    ("flash_attention chunk at 1984", W.flash_attention(1, 64, 2048, 32, 2, 128, q_offset=1984),
     "0.0021"),
    ("flash_attention gemma2 chunk at 4160, window 4096",
     W.flash_attention(1, 64, 4224, 32, 16, 128, q_offset=4160, window=4096), "0.0105"),
    ("flash_attention gemma2 chunk at 4160, global",
     W.flash_attention(1, 64, 4224, 32, 16, 128, q_offset=4160, window=1 << 30), "0.0106"),
    ("flash_attention granite chunk at 1008",
     W.flash_attention(1, 64, 1072, 48, 1, 128, q_offset=1008), "0.0017"),
    ("flash_attention zamba2 static pass", W.flash_attention(8, _S_PASS, _S_PASS, 32, 32, 80),
     "0.0431"),
    ("flash_attention zamba2 admission", W.flash_attention(1, _S_ADM, _S_ADM, 32, 32, 80),
     "0.0061"),
    ("flash_attention zamba2 ring prefill", W.flash_attention(2, 6000, 6000, 32, 32, 80), "0.3728"),
    ("flash_attention whisper encoder",
     W.flash_attention(8, 1500, 1500, 20, 20, 64, causal=False), "0.0932"),
    ("flash_attention whisper cross prefill",
     W.flash_attention(8, 1024, 1500, 20, 20, 64, causal=False), "0.0636"),
    ("flash_attention whisper decoder", W.flash_attention(8, 1024, 1024, 20, 20, 64), "0.0250"),
    ("flash_attention_bwd (4, 1024, 32, 128)", W.flash_attention_bwd(4, 1024, 1024, 32, 2, 128),
     "0.0869"),
    ("flash_attention_bwd microbatch", W.flash_attention_bwd(2, 1024, 1024, 32, 2, 128), "0.0434"),
    ("flash_attention_bwd zamba2 d 80", W.flash_attention_bwd(4, 1024, 1024, 32, 32, 80), "0.0543"),
    ("flash_attention_bwd zamba2 microbatch", W.flash_attention_bwd(2, 1024, 1024, 32, 32, 80),
     "0.0271"),
    ("ssd static pass", W.ssd(8, _S_PASS, 24, 64, 128, 64), "0.0151"),
    ("ssd admission", W.ssd(1, _S_ADM, 24, 64, 128, 64), "0.0021"),
    ("ssd zamba2 static pass", W.ssd(8, _S_PASS, 80, 64, 64, 64), "0.0459"),
    ("ssd_bwd (8, 1024, 24, 64)", W.ssd_bwd(8, 1024, 24, 64, 128, 64), "0.0274"),
    ("ssd_bwd microbatch", W.ssd_bwd(4, 1024, 24, 64, 128, 64), "0.0137"),
    ("ssd_bwd zamba2 (4, 1024, 80, 64)", W.ssd_bwd(4, 1024, 80, 64, 64, 64), "0.0405"),
    ("ssd_bwd zamba2 microbatch", W.ssd_bwd(2, 1024, 80, 64, 64, 64), "0.0203"),
]


@pytest.mark.parametrize("case", BOUNDS, ids=lambda c: c[0])
def test_work_gives_every_bound_of_the_kernel_table(case):
    _, w, printed = case
    ms, by = work.bound_ms(w)
    assert f"{ms:.{len(printed.split('.')[1])}f}" == printed
    assert by in ("bytes", "operations")


def test_the_ssd_admission_moves_the_bytes_perf_states():
    assert work.ssd(1, _S_ADM, 24, 64, 128, 64).bytes == 7118304
    assert (_S_PASS, _S_ADM, sum(_LENS)) == (881, 996, 3368)


def test_live_pairs_and_keys():
    assert work.live_pairs(10, 10) == 55
    assert work.live_pairs(10, 10, window=4) == 4 * 5 // 2 + 6 * 4
    assert work.live_pairs(10, 10, window=1 << 30) == 55
    assert work.live_pairs(3, 7, causal=False) == 21
    assert work.live_pairs(4, 8, q_offset=4) == 5 + 6 + 7 + 8
    assert work.live_keys(4, 8, q_offset=4, window=2) == 5
    assert work.live_keys(0, 8) == 0


# -- (e) each kernel-backed op counts its work and nothing of its plain version -----

def _gen():
    return torch.Generator().manual_seed(0)


def _op_cases():
    """(kernel, the op's call on inputs made beforehand, its work)."""
    g = _gen()
    r = lambda *s: torch.randn(s, generator=g)
    b, h, kvh, d, ps = 3, 4, 2, 16, 4
    pages = r(20, ps, kvh, d), r(20, ps, kvh, d)
    table = torch.arange(1, 19, dtype=torch.int32).view(3, 6)
    lengths = torch.tensor([5, 17, 9], dtype=torch.int32)
    cu, lens, pos0 = (torch.tensor(a, dtype=torch.int32) for a in ([0, 8, 16, 24], [6, 8, 0],
                                                                    [4, 0, 0]))
    wl = torch.tensor([3, 0, 2], dtype=torch.int32)
    x, w = r(5, 32), r(32)
    q, k, v = r(2, 12, h, d), r(2, 12, kvh, d), r(2, 12, kvh, d)
    q1, kc, vc = r(b, 1, h, d), r(b, 24, kvh, d), r(b, 24, kvh, d)
    qs, qv, kv, vv = r(b, 3, h, d), r(32, h, d), r(32, kvh, d), r(32, kvh, d)
    xs, dt, A, B, C = (r(2, 20, 3, 8), torch.rand(2, 20, 3, generator=g) * 0.1,
                       -torch.rand(3, generator=g) - 1, r(2, 20, 16), r(2, 20, 16))
    return [
        ("rmsnorm", lambda: ops.rmsnorm(x, w), W.rmsnorm(5, 32, 4)),
        ("flash_attention", lambda: ops.attention(q, k, v, window=5),
         W.flash_attention(2, 12, 12, h, kvh, d, window=5, itemsize=4)),
        ("decode_attention", lambda: ops.decode_attention(q1, kc, vc, lengths, window=8),
         W.decode_attention(b, h, kvh, d, 5 + 8 + 8, itemsize=4)),
        ("paged_attention", lambda: ops.paged_attention(q1, *pages, table, lengths,
                                                        pages_bound=5),
         W.paged_attention(b, h, kvh, d, 31, 3 * 5, itemsize=4)),
        ("spec_verify", lambda: ops.spec_verify(qs, *pages, table, lengths, wl),
         W.spec_verify(b, 3, h, kvh, d, 8 + 11, 6 + 7 + 8 + 10 + 11, 3 * 6, itemsize=4)),
        ("varlen_prefill", lambda: ops.varlen_prefill(qv, kv, vv, *pages, cu, lens, pos0, table),
         W.varlen_prefill(32, h, kvh, d, [(6, 4), (8, 0), (0, 0)], 18, itemsize=4)),
        ("ssd", lambda: ops.ssd(xs, dt, A, B, C, chunk=8, return_state=True),
         W.ssd(2, 20, 3, 8, 16, 8, itemsize=4)),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_each_kernel_op_counts_its_work_once(case):
    name, call, want = case
    with count_costs() as c:
        call()
    assert c.by_kernel == {name: (1, want.flops, want.bytes)}
    # nothing else: the plain version's products and traffic count nothing
    assert (c.flops, c.memory_bytes) == (want.flops, want.bytes)


def _bwd_cases():
    g = _gen()
    r = lambda *s: torch.randn(s, generator=g, requires_grad=True)
    q, k, v = r(2, 12, 4, 16), r(2, 12, 2, 16), r(2, 12, 2, 16)
    x, w = r(6, 32), r(32)
    xs = r(2, 20, 3, 8)
    dt = (torch.rand(2, 20, 3, generator=g) * 0.1).requires_grad_()
    A = (-torch.rand(3, generator=g) - 1).requires_grad_()
    B, C = r(2, 20, 16), r(2, 20, 16)
    return [
        ("flash_attention_bwd", lambda: ops.attention(q, k, v), (q, k, v),
         W.flash_attention_bwd(2, 12, 12, 4, 2, 16, itemsize=4)),
        ("rmsnorm_bwd", lambda: ops.rmsnorm(x, w), (x, w), W.rmsnorm_bwd(6, 32, 4)),
        ("ssd_bwd", lambda: ops.ssd(xs, dt, A, B, C, chunk=8), (xs, dt, A, B, C),
         W.ssd_bwd(2, 20, 3, 8, 16, 8, itemsize=4)),
    ]


@pytest.mark.parametrize("case", _bwd_cases(), ids=lambda c: c[0])
def test_each_backward_counts_its_work_once(case):
    name, forward, leaves, want = case
    out = forward()
    grad = torch.ones_like(out)
    with count_costs() as c:
        torch.autograd.grad(out, leaves, grad)
    assert c.by_kernel == {name: (1, want.flops, want.bytes)}
    assert c.flops == want.flops


def test_a_training_forward_counts_the_log_sum_exp():
    g = _gen()
    q, k, v = (torch.randn(2, 12, h, 16, generator=g, requires_grad=True) for h in (4, 2, 2))
    with count_costs() as c:
        ops.attention(q, k, v)
    assert c.by_kernel["flash_attention"][2] == W.flash_attention(2, 12, 12, 4, 2, 16, itemsize=4,
                                                                  lse=True).bytes


# -- (f) a reduced glm4-9b forward against the reference's HLO ------------------------

def test_glm4_forward_flops_equal_the_reference_hlo_less_attention():
    """The counted FLOPs of the port's reduced glm4-9b forward, less its
    attention kernel's work, against ``HloCostModel`` of the reference's
    jitted forward on the plain route, less that route's dense score and
    P.V dots (4 b h s^2 d a layer): the projections, MLPs and head, within
    1% (the norms' elementwise FLOPs)."""
    b, s = 2, 24
    jcfg = ref_get_config("glm4-9b", reduced=True)
    jmodel = ref_build_model(jcfg, backend="ref")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((b, s), jnp.int32)}
    compiled = jax.jit(lambda p, x: jmodel.forward(p, x)[0]).lower(jparams, batch).compile()
    dense = jcfg.num_layers * 4 * b * jcfg.num_heads * s * s * jcfg.resolved_head_dim
    want = HloCostModel(compiled.as_text()).entry_costs().flops - dense

    cfg = get_config("glm4-9b", reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with count_costs() as c, torch.inference_mode():
        model.forward(params, {"tokens": torch.zeros((b, s), dtype=torch.int32)})
    calls, attn, _ = c.by_kernel["flash_attention"]
    assert calls == cfg.num_layers
    assert attn == cfg.num_layers * 4 * b * cfg.num_heads * cfg.resolved_head_dim * s * (s + 1) / 2
    # within 1%: the rest is rmsnorm's 4 FLOPs an element, which the HLO
    # model (products only) does not count; less those, exactly equal
    assert c.flops - attn == pytest.approx(want, rel=0.01)
    assert c.flops - attn - c.by_kernel["rmsnorm"][1] == want


# -- (g) the predictor's SYSTEM cost event --------------------------------------------

@pytest.mark.parametrize("name", ["glm4-9b", "resnet50"])
def test_system_predict_emits_one_cost_event_per_predict(name):
    manifest = next(m for m in builtin_manifests(reduced=True) if m.name == name)
    pred = make_predictor("torch")
    handle = pred.open(OpenRequest(manifest=manifest, device="cpu"), Tracer("o", TracingServer()))
    server = TracingServer()
    tracer = Tracer("t", server, TraceLevel.SYSTEM)
    rng = np.random.default_rng(0)
    model, params = handle.state["model"], handle.state["params"]
    if name == "resnet50":
        size = handle.state["cfg"].img_size
        batch = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        direct = lambda: model.forward(params, torch.from_numpy(batch))
    else:
        batch = rng.integers(0, 256, (2, 16)).astype(np.int32)
        direct = lambda: model.forward(params, {"tokens": torch.from_numpy(batch)})
    for _ in range(3):
        pred.predict(handle, batch, tracer)
    events = [s for s in server.timeline("t") if s.name == "system:cost"]
    assert len(events) == 3
    assert [e.tags["counted"] for e in events] == [True, False, False]
    with count_costs() as c, torch.inference_mode():
        direct()
    for e in events:
        assert (e.tags["flops"], e.tags["bytes_accessed"]) == (c.flops, c.memory_bytes)
        assert e.tags["step_time_bound_s"] == max(e.tags["compute_term_s"],
                                                  e.tags["memory_term_s"])
        assert e.tags["dominant"] in ("compute", "memory")
    if name == "resnet50":
        assert c.flops == 2 * ResNet(ResNetConfig().reduced(), device="cpu").macs(2)
    # the counting forward runs outside the inference spans
    spans = server.timeline("t")
    assert sum(1 for s in spans if s.name == "inference") == 3
    pred.close(handle)


def test_model_level_emits_no_cost_event():
    manifest = next(m for m in builtin_manifests(reduced=True) if m.name == "mamba2-130m")
    pred = make_predictor("torch")
    handle = pred.open(OpenRequest(manifest=manifest, device="cpu"), Tracer("o", TracingServer()))
    server = TracingServer()
    pred.predict(handle, np.zeros((1, 8), np.int32), Tracer("t", server, TraceLevel.MODEL))
    assert not [s for s in server.timeline("t") if s.name.startswith("system:")]
    assert handle.state["costs"] == {}
    pred.close(handle)


# -- the SYSTEM device reading: every launch matched to its device record -------------

class _Event:
    """A profiler raw event: on the device, or on the host (an aten op, a
    range, or a runtime/driver call with its correlation id)."""

    def __init__(self, on_device, corr, name, ns=0, start=0, end=0):
        self.on_device, self.corr, self._name, self.ns = on_device, corr, name, ns
        self.start, self.end = start, end

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.on_device else DeviceType.CPU

    def correlation_id(self):
        return self.corr

    def name(self):
        return self._name

    def duration_ns(self):
        return self.ns

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_device_records_count_the_work_and_its_lost_launches():
    """Only the launches inside the ``system:work`` range count: the
    prologue's records stay out and its losses are counted apart; a launch
    of the work with no device record is lost, and then, as where the range
    is missing, the window reads no device time (None)."""
    from repro_torch.models.predictor import PROLOGUE, WINDOW_GUARD_S, _device_records

    prologue = [_Event(False, 1, "cudaLaunchKernel", start=1),       # its record lost
                _Event(False, 2, "cudaLaunchKernel", start=2), _Event(True, 2, "spin", 7)]
    work = [_Event(False, 0, "system:work", start=10, end=20), _Event(False, 0, "aten::conv2d", start=11),
            _Event(False, 3, "cudaLaunchKernel", start=11), _Event(True, 3, "kernel_a", 1_000_000),
            _Event(False, 4, "cuLaunchKernelEx", start=12),              # its record was dropped
            _Event(False, 5, "cudaMemsetAsync", start=13), _Event(True, 5, "Memset", 500_000),
            _Event(False, 6, "cudaDeviceSynchronize", start=14)]
    after = [_Event(False, 7, "cudaMemcpyAsync", start=30)]
    # a launch of the work lost its record: no device time, not a partial sum
    assert _device_records(prologue + work + after) == (None, 2, 1, 1, True)
    assert _device_records(prologue + [e for e in work if e.corr != 4]) == (1.5, 2, 0, 1, True)
    # the work's range is missing: no device time, not 0.0
    assert _device_records(prologue) == (None, 0, 0, 0, False)
    assert WINDOW_GUARD_S > 0 and PROLOGUE >= 64
