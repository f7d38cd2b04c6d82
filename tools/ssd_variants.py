"""Where the time of the bf16 ``ssd`` goes: ``csrc/ssd_tc.cu`` as committed
and copies of it with one part of the output launch's arithmetic taken
out, each built by ``nvcc`` into its own library under
``build/ssd_variants/`` and timed on the card at mamba2-130m's widths (h 24,
p 64, n 128, chunk 64, bf16, final state out) on the static serve pass
(8, 881) and a batch-1 admission (1, 996).

    python3 tools/ssd_variants.py

Prints, per variant and shape, the mean time of one call (CUDA events over
24 calls queued behind a sleep kernel, back to back, rotating over input
sets larger than the L2) and each of the three launches' device time
(torch.profiler).  The copies
compute wrong values: they show what a part costs, not a result.
  no_intra     the G X products (and G) of the output launch
  no_inter     the C S_in^T products
  no_cb        C B^T
  loads_only   all three: the output launch stages its tiles and stores y
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

INTRA = ("        if (kk > mi) continue;\n        // G of", "        continue;\n        // G of")
INTER = ("      for (int ks = 0; ks < n / 16; ++ks) {\n        uint32_t a[4];",
         "      for (int ks = 0; ks < 0; ++ks) {\n        uint32_t a[4];")
CB = ("  for (int ks = 0; ks < n / 16; ++ks) {\n    uint32_t a[4];",
      "  for (int ks = 0; ks < 0; ++ks) {\n    uint32_t a[4];")
VARIANTS = {"committed": [], "no_intra": [INTRA], "no_inter": [INTER], "no_cb": [CB],
            "loads_only": [INTRA, INTER, CB]}
H, P, CHUNK = 24, 64, 64
SHAPES = ((8, 881, 128), (1, 996, 128))
CALLS = 24


def build():
    out = ROOT / "build" / "ssd_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ssd_tc.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
               str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.rt_ssd_tc.argtypes = list(_build.SIGNATURES["rt_ssd_tc"])
        lib.rt_ssd_tc.restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(lib, x, dt, A, B, C):
    b, s, _, _ = x.shape
    n = B.shape[2]
    y = torch.empty_like(x)
    sf = torch.empty((b, H, P, n), dtype=x.dtype, device=x.device)
    cum = torch.empty((b, s, H), dtype=torch.float32, device=x.device)
    states = torch.empty((b, -(-s // CHUNK), H, P, n), dtype=torch.float32, device=x.device)
    err = lib.rt_ssd_tc(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                        None, y.data_ptr(), sf.data_ptr(), cum.data_ptr(), states.data_ptr(),
                        b, s, H, P, n, CHUNK, x.stride(0), x.stride(1), B.stride(0), B.stride(1),
                        C.stride(0), C.stride(1), _build.stream_of(x))
    _build.check_launch(err, "ssd_tc")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssd_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for b, s, n in SHAPES:
        per_set = 2 * b * s * (H * P + 2 * n)
        sets = []
        for _ in range(-(-2 * 50 * 2**20 // per_set) + 1):
            randn = lambda *shape: torch.randn(shape, generator=gen, device=dev).bfloat16()
            dt = torch.rand((b, s, H), generator=gen, device=dev) * 0.099 + 1e-3
            A = -(torch.rand((H,), generator=gen, device=dev) * 15 + 1)
            sets.append((randn(b, s, H, P), dt, A, randn(b, s, n), randn(b, s, n)))
        for name, lib in libs.items():
            for args in sets:
                call(lib, *args)
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)   # holds the card while the host queues every call
            t0.record()
            for i in range(CALLS):
                call(lib, *sets[i % len(sets)])
            t1.record()
            t1.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(CALLS):
                    call(lib, *sets[i % len(sets)])
                torch.cuda.synchronize()
            launches = {}
            for e in prof.key_averages():
                if "ssd_kernel_" in e.key:
                    us = getattr(e, "self_device_time_total", 0) or e.self_cuda_time_total
                    launches[e.key.split("ssd_kernel_")[1].split("<")[0]] = us / CALLS / 1e3
            print(f"VARIANT {name} x ({b}, {s}, {H}, {P}) n {n}: {t0.elapsed_time(t1) / CALLS:.4f} "
                  f"ms a call; device ms " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                       sorted(launches.items())))


if __name__ == "__main__":
    main()
