"""The bf16 ssd backward on the tensor cores (``csrc/ssd_bwd_tc.cu``), on
the CPU: its route is exactly the forward's (``ssd.plan``), its shared
memory, constants, instances and kernel names are the source's, two blocks
of its chunk-gradient launch fit an SM at mamba2-130m's and zamba2-2.7b's
widths, its workspaces and its ctypes signature.  Then a plain model of its
rounding (``ref.ssd_bwd_chunks(..., split=True)``: x, B, C and dy bf16,
every float32 operand of a product as two bf16 terms, bf16 outputs)
against ``jax.vjp`` of the JAX package's ``ssd_chunked_jnp`` on the same
values, within ``chip_smoke.py``'s limit (2e-2 |plain| + 2e-3 rms(plain)).
The card's own checks are gpu-marked in tests/test_torch_ssd_bwd.py."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels import ssd_bwd as sb_mod

SRC = (_build.CSRC / "ssd_bwd_tc.cu").read_text()
MAMBA2 = (64, 128, 64)      # p, n, chunk of mamba2-130m
ZAMBA2 = (64, 64, 64)       # of zamba2-2.7b
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_initial")
TOL, TOL_FLOOR = 2e-2, 2e-3  # chip_smoke.py's limit


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("p, n", [(16, 16), (64, 128), (64, 64), (32, 48), (8, 16), (64, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_route_is_the_forwards(dtype, p, n, chunk):
    """mma exactly where the forward's plan takes the tensor cores, with the
    head group; f32 (csrc/ssd_bwd.cu, sized at min(chunk, s)) elsewhere."""
    pl = sb_mod.plan(dtype, p, n, chunk, s=16)
    want = {"mma": "mma", "f32": "f32"}[ssd_mod.plan(dtype, p, n, chunk).kernel]
    assert pl.route == want
    if want == "mma":
        assert pl.head_group == sb_mod.HEAD_GROUP
        assert pl.smem_bytes == sb_mod.tc_smem_bytes(p, n, chunk)
    else:
        assert pl.head_group == 1 and pl.smem_bytes == sb_mod.smem_bytes(p, n, min(chunk, 16))


def test_tensor_core_blocks_too_large_raise():
    """Where the route's blocks do not fit it raises; it does not take the
    CUDA cores."""
    with pytest.raises(_build.SharedMemoryError, match="shared memory"):
        sb_mod.plan(torch.bfloat16, 256, 256, 64)


@pytest.mark.parametrize("p, n", [MAMBA2[:2], ZAMBA2[:2]])
def test_two_blocks_fit_an_sm_at_the_training_widths(p, n):
    """The chunk-gradient launch's block, plus the 1 KB the card reserves a
    block, fits twice in an SM's 228 KB (csrc/ssd_bwd.cu's took 200992 B at
    mamba2's widths: one block)."""
    pl = sb_mod.plan(torch.bfloat16, p, n, 64)
    assert pl.route == "mma"
    assert 2 * (pl.smem_bytes[1] + 1024) <= 228 * 1024
    assert sb_mod.plan(torch.bfloat16, *MAMBA2).smem_bytes == (54272, 110368)
    assert sb_mod.plan(torch.bfloat16, *ZAMBA2).smem_bytes == (37888, 77600)


def _c_expr(name):
    """The return expression of a size function of csrc/ssd_bwd_tc.cu, as Python."""
    body = re.search(r"inline size_t %s\(int Q, int p, int n\) \{\s*return (.*?);" % name, SRC,
                     re.S).group(1)
    body = re.sub(r"pad_row\((\w)\)", r"(\1 + 8)", " ".join(body.split()))
    return re.sub(r"\(size_t\)", "", body).replace("/", "//")


@pytest.mark.parametrize("p, n", [(64, 128), (64, 64), (16, 32), (128, 48)])
@pytest.mark.parametrize("chunk", ssd_mod.TC_CHUNKS)
def test_plan_matches_the_kernel_source(p, n, chunk):
    """The chunks are the RT_SSD_BWD_TC instances, the constants agree with
    the Python plan and the forward's, each chunk launch's shared memory is
    the source's formula, and the five kernels keep the profile's class key
    ``ssd_bwd_kernel_``."""
    assert tuple(int(q) for q in re.findall(r"RT_SSD_BWD_TC\((\d+)\)\n", SRC)) == \
        ssd_mod.TC_CHUNKS
    assert re.search(r"constexpr int kHeadGroup = %d;" % sb_mod.HEAD_GROUP, SRC)
    assert re.search(r"constexpr int kPassVec = %d;" % ssd_mod.PASS_VEC, SRC)
    assert "constexpr int kWarps = rt::kThreads / 32;" in SRC and sb_mod.WARPS == 256 // 32
    env = dict(Q=chunk, p=p, n=n, kHeadGroup=sb_mod.HEAD_GROUP, kWarps=sb_mod.WARPS)
    state, grads = sb_mod.tc_smem_bytes(p, n, chunk)
    assert eval(_c_expr("state_smem"), {}, env) == state
    assert eval(_c_expr("grads_smem"), {}, env) == grads
    for part in ("chunk_states", "state_pass", "chunk_grads", "reduce_bc", "reduce_a"):
        assert f"\nssd_bwd_kernel_tc_{part}(" in SRC
    assert "ssd_bwd_tc.cu" in _build.SOURCES and "ssd_tile.cuh" in _build.HEADERS


def test_the_signature_matches_the_entry_point():
    params = re.search(r'extern "C" int rt_ssd_bwd_tc\((.*?)\)', SRC, re.S).group(1)
    assert len(params.split(",")) == len(_build.SIGNATURES["rt_ssd_bwd_tc"]) == 34


def test_workspace_bytes_of_the_tensor_core_route():
    """The carried cotangents (b, nc, h, p, n), dB and dC per head group (b,
    s, groups, n) each, dA's parts (b, nc, h); cum and the chunk states only
    where the forward's are not kept: ~201 MB at mamba2's (8, 1024) with
    them kept, half csrc/ssd_bwd.cu's 403 MB less what the kept states take."""
    b, s, h = 8, 1024, 24
    p, n, chunk = MAMBA2
    pl = sb_mod.plan(torch.bfloat16, p, n, chunk)
    states = b * 16 * h * p * n
    kept = 4 * (states + 2 * b * s * 12 * n + b * 16 * h)
    assert sb_mod.workspace_bytes(pl, b, s, h, p, n, chunk, kept=True) == kept == 201_338_880
    assert sb_mod.workspace_bytes(pl, b, s, h, p, n, chunk) == kept + 4 * (b * s * h + states)
    # an odd head count: the last group holds one head
    assert sb_mod.workspace_bytes(pl, 1, 64, 3, p, n, chunk, kept=True) == \
        4 * (3 * p * n + 2 * 64 * 2 * n + 3)


# ---------------------------------------------------------------------------
# the plain model of the route's rounding against jax.vjp of ssd_chunked_jnp
# ---------------------------------------------------------------------------
def _bf16_inputs(b, s, h, p, n, seed):
    """numpy inputs with x, B, C and dy bf16 values (the kernel's inputs),
    dt and A in mamba2's init ranges, a float32 initial state and final-state
    cotangent."""
    rng = np.random.default_rng(seed)
    bf = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(x=bf(b, s, h, p), B=bf(b, s, n), C=bf(b, s, n), dy=bf(b, s, h, p),
                dt=rng.uniform(1e-3, 0.2, (b, s, h)).astype(np.float32),
                A=-rng.uniform(0.5, 2.0, (h,)).astype(np.float32), s0=f(b, h, p, n),
                df=f(b, h, p, n))


@pytest.mark.parametrize("ends", [False, True], ids=["zero-ends", "init-and-final"])
@pytest.mark.parametrize("p, n, chunk", [MAMBA2, ZAMBA2], ids=["mamba2", "zamba2"])
def test_rounding_model_matches_jax_vjp(p, n, chunk, ends):
    """Three chunks, the last partial (150 = 64 + 64 + 22): every gradient
    of the model within the limit of jax.vjp's, elementwise."""
    b, s, h = 1, 150, 3
    v = _bf16_inputs(b, s, h, p, n, seed=p + n + ends)
    num = {k: (t.float().numpy() if isinstance(t, torch.Tensor) else t) for k, t in v.items()}
    s0 = num["s0"] if ends else np.zeros_like(num["s0"])
    df = num["df"] if ends else np.zeros_like(num["df"])

    def fwd(x, dt, A, B, C, init):
        return jops.ssd_chunked_jnp(x, dt, A, B, C, chunk=chunk, initial_state=init,
                                    return_state=True)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(num[k]) for k in ("x", "dt", "A", "B", "C")),
                     jnp.asarray(s0))
    want = [np.asarray(g) for g in vjp((jnp.asarray(num["dy"]), jnp.asarray(df)))]
    T = lambda k: v[k] if isinstance(v[k], torch.Tensor) else torch.from_numpy(v[k])
    got = ref.ssd_bwd_chunks(T("x"), T("dt"), T("A"), T("B"), T("C"), T("dy"), chunk=chunk,
                             initial_state=torch.from_numpy(s0) if ends else None,
                             d_final=torch.from_numpy(df) if ends else None, split=True)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "dB", "dC") else torch.float32), name
        g = g.float().numpy()
        limit = TOL * np.abs(w) + TOL_FLOOR * float(np.sqrt(np.mean(w.astype(np.float64) ** 2)))
        assert g.shape == w.shape and bool(np.all(np.abs(g - w) <= limit)), \
            (name, float(np.abs(g - w).max()))
