"""What the exact rounding of the bf16 flash backward costs and finds:
``csrc/flash_attention_bwd.cu`` as committed and two copies, each built by
``nvcc`` into its own library under ``build/flash_bwd_variants/`` and run on
the card through the tensor-core route's C entry point.

    python3 tools/flash_bwd_variants.py

  committed   the source as it is, run at several error bounds ``tie`` (per
              unit of |a| |b|; the wrapper passes ``TIE``); ``-1e30``
              flags nothing, so the tie checks run and no pair is
              recomputed
  no_tie      tc_pair flags nothing and the checks compile away: the bare
              tensor-core kernels, whose bf16 roundings of P and dS follow
              the tensor cores' sums (they compute other values than the
              plain version's: this shows what the rounding costs)
  count       the committed source with a counter of the pairs whose bf16
              rounding the exact recompute changed; an unbounded ``tie``
              recomputes every live pair, so it finds them all, and each
              bound's count says how many of those it found

Prints, per shape (glm4-9b's training shape and microbatch, zamba2's d 80,
d 64 and a softcap of 2), SDPA's backward alone, and per variant and bound
the mean time of one call (CUDA events over 10 calls), each launch's device
time (torch.profiler) and the elements of dq, dk, dv outside
chip_smoke.py's limit against ``ref.flash_attention_bwd``; then the flip
counts.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402

NO_TIE = ("  return near_tie(ds, eds) || (round_p && near_tie(p, p * rel));",
          "  return false;")
KV_FLIP = "        dds = bf16_round(ds) - bf16_round(__uint_as_float(f.z));\n"
Q_FLIP = "        dds = bf16_round(ds) - bf16_round(__uint_as_float(f.y));\n"
COUNT = [
    ("using rt::tile::kLog2e;\n",
     "using rt::tile::kLog2e;\n__device__ unsigned long long g_flips[2];\n"),
    (KV_FLIP, KV_FLIP + "        if (dpp != 0.f || dds != 0.f) atomicAdd(&g_flips[0], 1ull);\n"),
    (Q_FLIP, Q_FLIP + "        if (dds != 0.f) atomicAdd(&g_flips[1], 1ull);\n"),
]
FLIPS_FN = '''
extern "C" int rt_flips(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_flips, sizeof(g_flips));
  const unsigned long long zero[2] = {0, 0};
  cudaMemcpyToSymbol(g_flips, zero, sizeof(zero));
  return (int)cudaDeviceSynchronize();
}
'''
VARIANTS = {"committed": [], "no_tie": [NO_TIE], "count": COUNT}
# (q shape, kv heads, options)
SHAPES = (((4, 1024, 32, 128), 2, {}), ((2, 1024, 32, 128), 2, {}), ((4, 1024, 32, 80), 32, {}),
          ((2, 1024, 16, 64), 16, {}), ((2, 512, 32, 128), 2, {"softcap": 2.0}))
TIMED = 3               # the first SHAPES are timed
TIES = (-1e30, 2.0 ** -25, fb.TIE, 2.0 ** -23)
COUNT_TIES = (1e30, 2.0 ** -26, 2.0 ** -25, fb.TIE, 2.0 ** -23)
CALLS = 10


def build():
    out = ROOT / "build" / "flash_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        if name == "count":
            text += FLIPS_FN
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
               str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{text[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = lib.rt_flash_attention_bwd_tc
        fn.argtypes = list(_build.SIGNATURES["rt_flash_attention_bwd_tc"])
        fn.restype = ctypes.c_int
        if name == "count":
            lib.rt_flips.argtypes = [ctypes.c_void_p]
            lib.rt_flips.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, q, k, v, o, lse, do, tie, softcap):
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(fb.tc_stats_floats(b, sq, sk, h, kvh), dtype=torch.float32,
                        device=q.device)
    splits = fb.tc_splits(b, sk, kvh, h // kvh)
    nbytes = fb.tc_scratch_bytes(b, sk, kvh, d, splits)
    part = torch.empty(nbytes // 4, dtype=torch.float32, device=q.device) if nbytes else None
    err = lib.rt_flash_attention_bwd_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _build.ptr(part), b, sq,
        sk, h, kvh, d, splits, 1, 0, 0, d ** -0.5, softcap, tie, _build.stream_of(q))
    if err:
        raise SystemExit(f"launch failed with CUDA error {err}")
    return dq, dk, dv


def mean_ms(fn):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CALLS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / CALLS


def per_launch(fn):
    """Device ms of each kernel of one call, by the kernel's name."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        for name in ("stats", "dkdv_tc", "sum_kernel", "dq_tc"):
            if name in e.key:
                out[name] = round(float(us) / 1e3, 4)
    return out


def outside(got, want):
    counts = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        limit = cs.TOL * w.abs() + cs.TOL_FLOOR * float(w.pow(2).mean().sqrt())
        counts.append(int(((g - w).abs() > limit).sum()))
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = build()
    flips = (ctypes.c_ulonglong * 2)()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 7)
    for n, (shape, kvh, opts) in enumerate(SHAPES):
        case = cs._bwd_inputs(torch, gen, torch.bfloat16, shape, shape[1], kvh, opts)
        cap = float(opts.get("softcap", 0.0))
        label = f"q {shape} on {kvh} kv heads{', softcap 2' if cap else ''}"
        if n < TIMED:
            want = ref.flash_attention_bwd(*case, **opts)
            sdpa = cs._sdpa_bwd_set(torch, *case[:3], case[5])
            print(f"{label}: SDPA's backward alone {mean_ms(lambda: cs._sdpa_bwd(*sdpa)):.4f} ms")
            del sdpa
            for name, ties in (("committed", TIES), ("no_tie", (0.0,))):
                for tie in ties:
                    got = run(libs[name], *case, tie, cap)
                    call = lambda: run(libs[name], *case, tie, cap)  # noqa: E731
                    ms = mean_ms(call)
                    print(f"   {name} tie {tie:.3g}: {ms:.4f} ms ({per_launch(call)}); dq, dk, dv "
                          f"outside the limit {outside(got, want)}")
            del want, got
        libs["count"].rt_flips(ctypes.addressof(flips))
        found = []
        for tie in COUNT_TIES:
            run(libs["count"], *case, tie, cap)
            libs["count"].rt_flips(ctypes.addressof(flips))
            found.append(f"tie {tie:.3g}: {flips[0]} + {flips[1]}")
        print(f"{label}: roundings changed by the recompute (dK/dV + dQ kernels): "
              + "; ".join(found), flush=True)
        del case
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
