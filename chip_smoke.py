#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and wall time, each ending in
``torch.cuda.synchronize()``; any failure exits non-zero:

1. environment and build: the card (as ``nvidia-smi`` names it, with its
   power limit), torch/CUDA versions, the ``nvcc`` build of the kernels
   from this checkout's sources, each kernel's registers and spills from
   the compiler's report, and the tensor-core instructions (HMMA, HGMMA) in
   the SASS of the bf16 ``flash_attention`` kernels and of every head-dim
   instance of the bf16 decode family's split-KV routine
   (``csrc/decode_split.cuh``) and of the bf16 ``varlen_prefill`` routine
   (``csrc/varlen_prefill_tc.cuh``) and of the chunk launches of the bf16
   ``ssd`` (``csrc/ssd_tc.cu``; ``cuobjdump``): fail unless each has some
   (HGMMA in varlen's d-128 instances), the flash and varlen kernels at
   head dim 128 spill nothing and no split-KV or ``ssd_tc`` instance
   spills;
2. kernels: each hand-written kernel against its plain PyTorch version at
   the shapes the serve phase gives it (glm4-9b widths: h 32, kvh 2, d 128,
   page 16, D 4096, bf16; spec_verify with 8 slots and windows of 5), the
   attention kernels on a bf16 pool and on int8 and fp8 pools, with the
   error (fail unless ``|kernel - plain| <= 2e-2 * |plain| + 2e-3 *
   rms(plain)``; the plain version with one key, one context page or one
   window row too few must fail that limit); the split-KV routine's
   splits at these shapes, each spec_verify window row bit-equal to a
   one-token ``paged_attention`` at ``len + w + 1`` on all three pools, and
   the verify windows of W 13 at glm4-9b's heads and of W 5 at
   granite-20b's 48 heads on one kv head, bf16 and float32, against their
   plain versions; ``varlen_prefill``'s bf16 plan, and the longest of the
   first 8 serve prompts prefilled whole and split at key 208 (13 context
   pages), which must give the same bits on the split part's rows;
   ``rmsnorm``'s time at the decode shape (8 rows) too; kernel, plain and library
   times (see ``_time_ms``) and the bound: the larger of bytes over
   3.35 TB/s and flops over 989 TFLOP/s.  The dense engines' kernels
   likewise: ``flash_attention`` on a static prefill pass (q (8, 1024, 32,
   128), causal) and small cases with a window, softcap, q_offset and no
   causal mask (the plain version without key 0 must fail the limit), its
   time at a continuous admission (q (1, 1024, 32, 128)), and the longest
   of the first 8 serve prompts padded with other values to 1024 and to
   2048 tokens, and batched beside another row, which must give the same
   bits on its real rows;
   ``decode_attention`` on a decode step of 8 rows over a 2048-token cache
   at the serve lengths, and with a window and a row of length 0, which
   must be exactly zero (with ``lengths - 1`` the plain version must fail),
   and equal bit for bit to ``paged_attention`` over the cache viewed as a
   pool with the identity table;
   ``ssd`` (mamba2-130m widths: h 24, p 64, n 128, chunk 64, bf16; the
   tensor-core route's three launches) on the static prefill pass of 8
   rows of the longest of the first 8 serve prompts (a partial trailing
   chunk), a partial chunk, a sequence shorter than a chunk, an initial
   state and zamba2's state width (n 64), y and the final state each (the
   plain version without the initial state, and its final state one
   timestep short, must fail the limit; no single PyTorch call computes
   SSD, so there is no library time), its plan and blocks per launch, and
   its time at a batch-1 admission;
3. check: reduced glm4-9b in float32 served on the card and on the CPU
   from the same weights must emit the same greedy tokens, with and
   without speculative decoding (which must also equal each other); the
   card-vs-CPU token agreement on int8 and fp8 pools is printed.  On the
   dense engines ``generate`` and ``serve_continuous`` tokens must equal
   the CPU's and ``forward`` logits agree within 1e-4 + 1e-4 |cpu|; the
   same for reduced mamba2-130m;
4. serve: full-width, full-depth glm4-9b (40 layers, random bf16 weights
   from a seeded CUDA generator) through ``ServingEngine.serve_paged``;
   every request must complete and every kernel must have been launched
   (counts zeroed just before the run, read just after), exactly 40
   attention and 81 rmsnorm launches per decode step and per prefill
   launch; two more runs of the same requests give the metrics' spread.
   Then the same mix on int8 and fp8 pools, and speculative decoding
   (``spec_k`` 4) on tiled prompts: ``spec_ngram`` 3 on the bf16 pool, and
   ``spec_ngram`` 1 on each pool, each run counted alone: 40 spec_verify
   launches per verify step, 40 paged_attention per plain decode step, and
   more than 0 spec_verify launches in each ``spec_ngram`` 1 run (random
   weights at the published vocabulary almost never repeat a 3-gram within
   32 tokens, so 3-gram lookup rarely drafts); token agreement with the
   bf16 plain run of the same prompts is printed.  Then the dense engines
   on the same requests, three runs each: the static path (Poisson
   arrivals at 20 Hz through the threaded ``RequestScheduler`` into
   ``generate`` batches of up to 8) and ``serve_continuous`` (8 slots);
   every request must complete, each run must launch exactly 40
   ``flash_attention`` and 81 rmsnorm per prefill pass, 40
   ``decode_attention`` and 81 rmsnorm per decode step and no paged
   kernel (and the paged runs neither dense kernel).  Then full-width,
   full-depth mamba2-130m (24 layers, random bf16 weights) through the
   same two dense engines on the same requests, three runs each: exactly
   24 ``ssd`` and 49 rmsnorm launches per prefill pass, 0 ``ssd`` and 49
   rmsnorm per decode step, and no attention kernel;
5. where the time goes: device time by kernel class per prefill launch and
   per decode step, per launch of each kernel, and the device's idle
   share, from torch.profiler, for the paged engine and for a dense
   prefill pass and decode step of glm4-9b and of mamba2-130m (with the
   device time of each of ``ssd``'s three launches per pass);
6. one JSON line of kernel records, then the final line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
# |kernel - plain| <= TOL * |plain| + TOL_FLOOR * rms(plain): rounding the
# output to bf16 moves it by at most 2**-7 of itself; the floor, scaled to
# the output, covers values near zero
TOL, TOL_FLOOR = 2e-2, 2e-3
L2_BYTES = 50 * 2**20           # H100 L2 cache
LAUNCHES = 24                   # calls per timing, back to back

# serve phase (and the kernel shapes it implies)
SLOTS, PAGE, MAX_SEQ, BUDGET = 8, 16, 2048, 2048
REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 16, 64, 1024, 32
SEED = 0
REPEATS = 3                     # serve runs; launches are counted in the first
KV_MODES = (None, "int8", "fp8")  # pool storage: bf16, or codes + f32 scales
SPEC_K = 4                      # draft depth of the speculative runs
# prompt-lookup n-gram: 3 as in bench_spec, and 1, which drafts from any
# earlier occurrence of the pending token and so finds drafts on random weights
SPEC_NGRAM, DRAFT_NGRAM = 3, 1
WINDOW_LENS = [5, 3, 1, 0, 5, 2, 4, 5]   # spec_verify check (slot 3 idle)
# dense engines: static batches of up to SLOTS prompts right-padded to the
# power-of-two bucket of the longest (1024 once a batch holds a prompt above
# 512); Poisson arrivals and the batching window of the driver's defaults
PREFILL_LEN = 1024
RATE_HZ, BATCH_TIMEOUT_MS = 20.0, 10.0


def _phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(torch, name, t0):
    torch.cuda.synchronize()
    print(f"== {name} done in {time.perf_counter() - t0:.3f} s", flush=True)


def _sleep_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def _rotation(nbytes, make):
    """Input sets ``make(0), make(1), ...`` to rotate over: enough that about
    twice the L2 passes between two uses of one set, so every call finds
    its ``nbytes`` of inputs cold in memory."""
    return [make(i) for i in range(math.ceil(2 * L2_BYTES / nbytes) + 1)]


def _time_ms(torch, fn, sets, cycles_per_ms):
    """Mean device time of one call of ``fn``: ``LAUNCHES`` calls back to
    back, rotating over the input ``sets``, between one pair of CUDA events.
    A sleep kernel queued first holds the card until the host has queued
    every call, so the host's time per call (argument checks, ctypes) never
    shows as a gap between launches; the sleep grows until that holds.  A
    function that waits for the card itself (the plain ``varlen_prefill``
    reads its metadata on the host) is timed with those waits.  Returns
    (ms, whether the calls ran without host gaps)."""
    for args in sets:                   # warm-up, every set once
        fn(*args)
    torch.cuda.synchronize()
    hold_ms = 5.0
    for _ in range(4):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        a.record()
        for i in range(LAUNCHES):
            fn(*sets[i % len(sets)])
        queued = not a.query()          # the card still sleeps: nothing ran yet
        b.record()
        b.synchronize()
        if queued:
            break
        hold_ms *= 4
    return a.elapsed_time(b) / LAUNCHES, queued


def _timed(torch, cpm, kernel, plain, library, sets, library_sets):
    """Kernel and plain version over ``sets``, library (None where no single
    PyTorch call computes the function) over its own."""
    ms, ms_q = _time_ms(torch, kernel, sets, cpm)
    plain_ms, plain_q = _time_ms(torch, plain, sets, cpm)
    lib_ms, lib_q = (_time_ms(torch, library, library_sets, cpm) if library is not None
                     else (None, True))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                sets=(len(sets), len(library_sets)),
                gaps=[n for n, q in (("kernel", ms_q), ("plain", plain_q),
                                     ("library", lib_q)) if not q])


def _print_records(records):
    for name, r in records.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"   {name}: kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"library_ms {lib} "
              f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) at {r['shape']}; "
              f"{LAUNCHES} calls back to back over (kernel and plain, library) "
              f"{r['sets']} input sets; host gaps in: {r['gaps'] or 'none'}")


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _within(torch, out, want):
    """(max |out - want|, whether out is finite and within the limit)."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    limit = TOL * want.abs() + TOL_FLOOR * float(want.pow(2).mean().sqrt())
    return float(err.max()), bool((err <= limit).all()) and bool(torch.isfinite(out).all())


def _check(torch, name, out, want):
    max_abs, ok = _within(torch, out, want)
    print(f"   {name}: max_abs_err {max_abs:.3e} "
          f"(|kernel - plain| <= {TOL}*|plain| + {TOL_FLOOR}*rms(plain), finite: {ok})")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return max_abs


def _rejects(torch, name, wrong, want):
    """The limit must reject a plain version that drops a little of the work:
    proof that it is tight enough to catch such a fault in the kernel."""
    max_abs, ok = _within(torch, wrong, want)
    print(f"   {name}: max_abs_err {max_abs:.3e}, rejected by the limit: {not ok}")
    if ok:
        raise SystemExit(f"{name}: the limit does not tell it from the right answer")


def _name(kernel, mode):
    return kernel if mode is None else f"{kernel}[{mode}]"


def _serve_lengths(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(PROMPT_MIN, PROMPT_MAX + 1, size=REQUESTS)




def _demangle(names):
    """C++ names as ``c++filt`` reads them (unchanged where it is missing)."""
    exe = shutil.which("c++filt")
    if not names or exe is None:
        return {n: n for n in names}
    out = subprocess.run([exe], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def _ptxas_report(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ``-Xptxas -v`` report of the build."""
    report, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            report[cur] = (int(m.group(1)), *spill)
    return report


def _sass_counts(nvcc, lib_path):
    """{kernel: (HMMA, HGMMA)}: tensor-core instructions in each kernel's
    SASS, from ``cuobjdump --dump-sass`` on the built library."""
    exe = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(exe if exe.exists() else "cuobjdump"), "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise SystemExit(f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = [0, 0]
        elif cur and re.search(r"\bHGMMA\.", line):
            counts[cur][1] += 1
        elif cur and re.search(r"\bHMMA\.", line):
            counts[cur][0] += 1
    return {k: tuple(v) for k, v in counts.items()}


def build_report(info, nvcc):
    """Print every kernel's registers and spills, and the tensor-core
    instructions of the bf16 flash_attention kernels, of the split-KV decode
    routine, of the varlen prefill routine and of the bf16 ssd's chunk
    launches; fail unless each of those has some (HGMMA for varlen at d
    128), the flash and varlen kernels at d 128 spill nothing and no
    split-KV or ssd_tc instance spills."""
    from repro_torch.kernels import decode_split as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sdm
    from repro_torch.kernels import varlen_prefill as vpf

    ptxas = _ptxas_report(info.log)
    sass = _sass_counts(nvcc, info.path)
    names = _demangle(sorted(set(ptxas) | set(sass)))
    for mangled, (regs, st, ld) in sorted(ptxas.items(), key=lambda kv: names[kv[0]]):
        print(f"   ptxas {names[mangled]}: {regs} registers, spill stores {st} B, loads {ld} B")
    flash = {m: c for m, c in sass.items() if "flash_attention_kernel_bf16" in m}
    for mangled, (hmma, hgmma) in sorted(flash.items(), key=lambda kv: names[kv[0]]):
        print(f"   sass {names[mangled]}: HMMA {hmma}, HGMMA {hgmma}")
    if not flash or any(sum(c) == 0 for c in flash.values()):
        raise SystemExit("flash_attention bf16: no tensor-core instruction in its SASS")
    # the split-KV decode routine: every head-dim instance on the tensor
    # cores, none spilling
    split = {m: c for m, c in sass.items() if "decode_split_kernel" in m}
    for mangled, (hmma, _) in sorted(split.items(), key=lambda kv: names[kv[0]]):
        regs, st, ld = ptxas.get(mangled, (None, None, None))
        print(f"   sass {names[mangled]}: HMMA {hmma}; {regs} registers, spill stores {st} B, "
              f"loads {ld} B")
    if len(split) != 2 * len(ds.BF16_HEAD_DIMS) or any(c[0] == 0 for c in split.values()):
        raise SystemExit(f"decode_split: {len(split)} kernels in the SASS, expected "
                         f"{2 * len(ds.BF16_HEAD_DIMS)}, each with HMMA")
    spilled = [names[m] for m in split if ptxas.get(m, (0, 1, 1))[1:] != (0, 0)]
    if spilled:
        raise SystemExit(f"decode_split: spills (or no ptxas report) in {spilled}")
    # the varlen prefill tensor-core routine: every head-dim instance of both
    # pool kinds on the tensor cores (HGMMA at d 128, HMMA elsewhere), none
    # at d 128 spilling
    varlen = {m: c for m, c in sass.items()
              if "varlen_prefill_kernel_wgmma" in m or "varlen_prefill_kernel_mma" in m}
    for mangled, (hmma, hgmma) in sorted(varlen.items(), key=lambda kv: names[kv[0]]):
        regs, st, ld = ptxas.get(mangled, (None, None, None))
        print(f"   sass {names[mangled]}: HMMA {hmma}, HGMMA {hgmma}; {regs} registers, spill "
              f"stores {st} B, loads {ld} B")
    wg = {m: c for m, c in varlen.items() if "wgmma" in m}
    if (len(varlen) != 2 * len(vpf.BF16_HEAD_DIMS) or len(wg) != 2
            or any(c[1] == 0 for c in wg.values())
            or any(c[0] == 0 for m, c in varlen.items() if m not in wg)):
        raise SystemExit(f"varlen_prefill: {len(varlen)} tensor-core kernels in the SASS, expected "
                         f"{2 * len(vpf.BF16_HEAD_DIMS)}, HGMMA in the two at d 128, HMMA in "
                         f"the others")
    spilled = [names[m] for m in wg if ptxas.get(m, (0, 1, 1))[1:] != (0, 0)]
    if spilled:
        raise SystemExit(f"varlen_prefill at d 128: spills (or no ptxas report) in {spilled}")
    _, bk, rows, stages = fa.BF16_TILES[128]
    targs = (bk, stages, rows // 64)            # wgmma kernel <BK, ST, warpgroups>
    at128 = [r for m, r in ptxas.items()
             if f"flash_attention_kernel_bf16_wgmma<{', '.join(map(str, targs))}>" in names[m]
             or "flash_attention_kernel_bf16_wgmmaI" + "".join(f"Li{a}E" for a in targs) in m]
    if len(at128) != 1 or at128[0][1] or at128[0][2]:
        raise SystemExit(f"flash_attention bf16 at d 128: ptxas report {at128}, expected no spill")
    # the bf16 ssd (csrc/ssd_tc.cu): its two chunk launches on the tensor
    # cores at every chunk instance, the state pass beside them, none spilling
    tc = {m: ptxas[m] for m in ptxas if "ssd_kernel_" in m}
    for mangled in sorted(tc, key=lambda m: names[m]):
        regs, st, ld = tc[mangled]
        print(f"   ssd_tc {names[mangled]}: HMMA {sass.get(mangled, (0, 0))[0]}; {regs} registers, "
              f"spill stores {st} B, loads {ld} B")
    chunked = [m for m in tc if "ssd_kernel_chunk_" in m]
    if (len(tc) != 3 * len(sdm.TC_CHUNKS) or len(chunked) != 2 * len(sdm.TC_CHUNKS)
            or any(sass.get(m, (0, 0))[0] == 0 for m in chunked)):
        raise SystemExit(f"ssd_tc: {len(tc)} kernels ({len(chunked)} chunk launches), expected "
                         f"{3 * len(sdm.TC_CHUNKS)} ({2 * len(sdm.TC_CHUNKS)}, each with HMMA)")
    spilled = [names[m] for m, r in tc.items() if r[1:] != (0, 0)]
    if spilled:
        raise SystemExit(f"ssd_tc: spills in {spilled}")


def kernels_phase(torch, dev):
    """Each kernel vs its plain version at the serve phase's shapes, the
    attention kernels on a bf16 pool and on int8 and fp8 pools."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_split as ds
    from repro_torch.kernels import kvquant, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.kernels import varlen_prefill as vp

    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=bf)
    cl = lambda t: None if t is None else t.clone()
    cpm = _sleep_cycles_per_ms(torch)
    h, kvh, d, D = 32, 2, 128, 4096
    rep = h // kvh
    max_pages = MAX_SEQ // PAGE
    num_pages = SLOTS * max_pages + 1
    records = {}
    timed = lambda *a: _timed(torch, cpm, *a)

    # -- rmsnorm: a full packed-prefill buffer of rows (decode gives 8 rows)
    x, w = randn(1, BUDGET, D), randn(D) * 0.1
    err = 0.0
    for rows in (SLOTS, BUDGET):
        xs = x[:, :rows].contiguous()
        err = max(err, _check(torch, f"rmsnorm rows={rows}", rn.rmsnorm(xs, w),
                              ref.rmsnorm(xs, w)))
    w1 = (1.0 + w.float()).to(bf)
    nbytes = 2 * (2 * BUDGET * D + D)
    sets = _rotation(nbytes, lambda i: (x if i == 0 else x.clone(), w))
    records["rmsnorm"] = dict(
        err=err,
        **timed(rn.rmsnorm, ref.rmsnorm,
                lambda x_: F.rms_norm(x_, (D,), w1, 1e-6),
                sets, [(x_,) for x_, _ in sets]),
        bound=_bound_ms(nbytes, 4.0 * BUDGET * D),
        shape=f"x (1, {BUDGET}, {D}) bf16",
    )
    del sets
    # the decode shape: SLOTS rows, 81 launches a glm4-9b decode step
    nbytes8 = 2 * (2 * SLOTS * D + D)
    sets = _rotation(nbytes8, lambda i: (x[:, :SLOTS].clone(), w))
    r8 = timed(rn.rmsnorm, ref.rmsnorm, lambda x_: F.rms_norm(x_, (D,), w1, 1e-6),
               sets, [(x_,) for x_, _ in sets])
    b8 = _bound_ms(nbytes8, 4.0 * SLOTS * D)
    print(f"   rmsnorm at the decode shape x (1, {SLOTS}, {D}): kernel_ms {r8['ms']:.4f} "
          f"plain_ms {r8['plain_ms']:.4f} library_ms {r8['library_ms']:.4f} bound_ms "
          f"{b8[0]:.6f} ({b8[1]}); host gaps in: {r8['gaps'] or 'none'}")
    del sets

    # the pools every attention kernel reads: bf16, and the same values as
    # int8/fp8 codes with float32 per-row scales
    k_pages, v_pages = randn(num_pages, PAGE, kvh, d), randn(num_pages, PAGE, kvh, d)

    def pools(mode):
        """(k, v, k_scales, v_scales, bytes per pool row and kv head, and the
        bf16 pools the library's SDPA reads: the dequantized codes)."""
        if mode is None:
            return k_pages, v_pages, None, None, 2 * d, k_pages, v_pages
        store = kvquant.pool_dtype(mode)
        (kq, ks), (vq, vs) = kvquant.quantize(k_pages, store), kvquant.quantize(v_pages, store)
        return (kq, vq, ks, vs, d + 4,
                kvquant.dequantize(kq, ks).to(bf), kvquant.dequantize(vq, vs).to(bf))

    def pool_desc(mode):
        return "bf16" if mode is None else f"{mode} + f32 scales"

    # -- paged_attention: one decode step of 8 slots at ragged lengths
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev).to(torch.int32) + 1
    table = perm[: SLOTS * max_pages].view(SLOTS, max_pages).contiguous()
    lens_host = [int(n) + NEW_TOKENS for n in _serve_lengths(SEED)[:SLOTS]]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    bound_pages = math.ceil(max(lens_host) / PAGE)
    q = randn(SLOTS, 1, h, d)
    tb = table[:, :bound_pages]
    # SDPA yardstick on K/V gathered and expanded to the query heads (and
    # dequantized) beforehand: neither is timed
    S = bound_pages * PAGE
    gather = lambda pool, t_=tb, s_=S: (pool[t_.long()].reshape(SLOTS, s_, kvh, d)
                                        .transpose(1, 2).repeat_interleave(rep, dim=1))
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    live = sum(lens_host)
    for mode in KV_MODES:
        kp, vpl, ks, vs, row_bytes, k_lib, v_lib = pools(mode)
        name = _name("paged_attention", mode)
        want = ref.paged_attention(q, kp, vpl, tb, lengths, k_scales=ks, v_scales=vs)
        err = _check(torch, name,
                     pa.paged_attention(q, kp, vpl, table, lengths, pages_bound=bound_pages,
                                        k_scales=ks, v_scales=vs), want)
        if mode is None:
            _rejects(torch, "paged_attention plain with lengths - 1",
                     ref.paged_attention(q, kp, vpl, tb, lengths - 1), want)
        nbytes = (2 * 2 * SLOTS * h * d + 2 * live * kvh * row_bytes
                  + 4 * (SLOTS + SLOTS * bound_pages))
        sets = _rotation(nbytes, lambda i: (q.clone(), *map(cl, (kp, vpl, ks, vs))))
        lib_sets = _rotation(2 * 2 * SLOTS * h * S * d,
                             lambda i: (q.transpose(1, 2), gather(k_lib), gather(v_lib)))
        records[name] = dict(
            err=err,
            **timed(lambda q_, k_, v_, ks_, vs_: pa.paged_attention(
                        q_, k_, v_, table, lengths, pages_bound=bound_pages,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_, ks_, vs_: ref.paged_attention(
                        q_, k_, v_, tb, lengths, k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask),
                    sets, lib_sets),
            bound=_bound_ms(nbytes, 4.0 * h * d * live),
            shape=f"q ({SLOTS}, 1, {h}, {d}) bf16, pool ({num_pages}, {PAGE}, {kvh}, {d}) "
                  f"{pool_desc(mode)}, lengths {lens_host}",
        )
        del sets, lib_sets

    # -- spec_verify: one verify step of 8 slots, windows of SPEC_K + 1 at the
    #    same committed lengths, ragged window lengths, one idle slot
    W = SPEC_K + 1
    wl_host = WINDOW_LENS[:SLOTS]
    wlens = torch.tensor(wl_host, dtype=torch.int32, device=dev)
    totals = [L + n if n else 0 for L, n in zip(lens_host, wl_host)]
    spec_pages = math.ceil(max(totals) / PAGE)
    ts = table[:, :spec_pages]
    qs = randn(SLOTS, W, h, d)
    S2 = spec_pages * PAGE
    k_pos = torch.arange(S2, device=dev)[None, None, :]
    w_idx = torch.arange(W, device=dev)[None, :, None]
    smask = ((k_pos <= lengths[:, None, None] + w_idx)
             & (w_idx < wlens[:, None, None]))[:, None]      # (b, 1, W, S)
    pairs = sum(L + w + 1 for L, n in zip(lens_host, wl_host) for w in range(n))
    for mode in KV_MODES:
        kp, vpl, ks, vs, row_bytes, k_lib, v_lib = pools(mode)
        name = _name("spec_verify", mode)
        want = ref.spec_verify(qs, kp, vpl, ts, lengths, wlens, k_scales=ks, v_scales=vs)
        out = sv.spec_verify(qs, kp, vpl, table, lengths, wlens, pages_bound=spec_pages,
                             k_scales=ks, v_scales=vs)
        err = _check(torch, name, out, want)
        pad_zero = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(wl_host))
        print(f"   {name}: window pad rows and the idle slot exactly zero: {pad_zero}")
        if not pad_zero:
            raise SystemExit(f"{name}: pad rows are not exactly zero")
        if mode is None:
            _rejects(torch, "spec_verify plain with window_lens - 1",
                     ref.spec_verify(qs, kp, vpl, ts, lengths, (wlens - 1).clamp_min(0)), want)
        nbytes = (2 * 2 * SLOTS * W * h * d + 2 * sum(totals) * kvh * row_bytes
                  + 4 * (2 * SLOTS + SLOTS * spec_pages))
        sets = _rotation(nbytes, lambda i: (qs.clone(), *map(cl, (kp, vpl, ks, vs))))
        lib_sets = _rotation(
            2 * 2 * SLOTS * h * S2 * d,
            lambda i: (qs.transpose(1, 2), gather(k_lib, ts, S2), gather(v_lib, ts, S2)))
        records[name] = dict(
            err=err,
            **timed(lambda q_, k_, v_, ks_, vs_: sv.spec_verify(
                        q_, k_, v_, table, lengths, wlens, pages_bound=spec_pages,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_, ks_, vs_: ref.spec_verify(
                        q_, k_, v_, ts, lengths, wlens, k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=smask),
                    sets, lib_sets),
            bound=_bound_ms(nbytes, 4.0 * h * d * pairs),
            shape=f"q ({SLOTS}, {W}, {h}, {d}) bf16, pool {pool_desc(mode)}, committed "
                  f"{lens_host}, window lens {wl_host}",
        )
        del sets, lib_sets

    # -- the split-KV routine behind both: its splits at these shapes, spec
    #    row w bit-equal to a one-token decode at len + w + 1 on every pool,
    #    and the verify windows a single block of rep * W rows refused
    pp, sp = ds.plan(bf, d, rep, 1, PAGE), ds.plan(bf, d, rep, W, PAGE)
    live_blocks = kvh * sum(-(-L // pp.split_keys) for L in lens_host)
    print(f"   split-KV routine: {pp.split_keys}-key splits; paged_attention "
          f"{ds.n_splits(pp, bound_pages, PAGE, None)} splits x {SLOTS * kvh} (slot, kv head) "
          f"blocks of {pp.rows} rows, {live_blocks} with live keys; spec_verify "
          f"{ds.n_splits(sp, spec_pages, PAGE, None)} splits, {sp.row_chunks} row chunk(s) of "
          f"{sp.rows} rows")
    one_len = lambda i, w: torch.tensor([lens_host[i] + w + 1], dtype=torch.int32, device=dev)
    for mode in KV_MODES:
        kp, vpl, ks, vs = pools(mode)[:4]
        out = sv.spec_verify(qs, kp, vpl, table, lengths, wlens, pages_bound=spec_pages,
                             k_scales=ks, v_scales=vs)
        same = all(torch.equal(out[i, w], pa.paged_attention(
                       qs[i:i + 1, w:w + 1].contiguous(), kp, vpl, table[i:i + 1].contiguous(),
                       one_len(i, w), k_scales=ks, v_scales=vs)[0, 0])
                   for i, n in enumerate(wl_host) for w in range(n))
        print(f"   {_name('spec_verify', mode)}: every window row equals a one-token "
              f"paged_attention at len + w + 1 bit for bit: {same}")
        if not same:
            raise SystemExit(f"{_name('spec_verify', mode)}: a verify row differs from decoding")
    wide_pool = randn(num_pages, PAGE, 1, d)
    for label, (hh, pool, W_) in (("glm4-9b heads, W 13 (spec_k 12)", (h, k_pages, 13)),
                                  ("granite-20b heads (48 on 1 kv head), W 5", (48, wide_pool, W))):
        qw = randn(SLOTS, W_, hh, d)
        wl_w = torch.tensor([W_ if n else 0 for n in wl_host], dtype=torch.int32, device=dev)
        pages_w = math.ceil((max(lens_host) + W_) / PAGE)
        for dt in (bf, torch.float32):
            args = (qw.to(dt), pool.to(dt), pool.to(dt), table, lengths, wl_w)
            p_w = ds.plan(dt, d, hh // pool.shape[2], W_, PAGE)
            _check(torch, f"spec_verify {label}, {dt} ({p_w.kernel}: {p_w.row_chunks} row chunks "
                          f"of {p_w.rows})",
                   sv.spec_verify(*args, pages_bound=pages_w),
                   ref.spec_verify(*args[:3], table[:, :pages_w], *args[4:]))
    del wide_pool

    # -- varlen_prefill: one packed buffer of BUDGET tokens holding chunks
    #    with committed context pages, ragged tails and a buffer-tail pad
    chunk_specs = [(300, 40), (517, 0), (1, 63), (640, 12), (200, 0)]   # (take, ctx pages)
    C = SLOTS
    cu, lens_c, pos0, tables = [0], [], [], torch.zeros((C, max_pages), dtype=torch.int32)
    nxt_page = 1
    for c in range(C):
        take, ctx = chunk_specs[c] if c < len(chunk_specs) else (0, 0)
        span = -(-take // PAGE) * PAGE
        cu.append(cu[-1] + span)
        lens_c.append(take)
        pos0.append(ctx * PAGE)
        npg = ctx + -(-take // PAGE)
        tables[c, :npg] = torch.arange(nxt_page, nxt_page + npg)
        nxt_page += npg
    T = BUDGET
    if not (cu[-1] < T and nxt_page <= num_pages):
        raise SystemExit("varlen_prefill: the test layout does not fit the buffer or pool")
    qp, kp_, vpk = randn(T, h, d), randn(T, kvh, d), randn(T, kvh, d)
    meta = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (cu, lens_c, pos0)]
    tables = tables.to(dev)
    ctx_bound = max(1, max(p // PAGE for p in pos0))
    real = [(cu[c] + lens_c[c], cu[c + 1]) for c in range(C)] + [(cu[-1], T)]
    # SDPA yardstick: one call over every chunk's gathered context plus the
    # packed buffer, with the block mask of the packed layout (the gather,
    # dequantization and expansion to the query heads are not timed)
    ctx_owner = []
    for c in range(C):
        ctx_owner += [c] * pos0[c]
    tok_chunk = torch.zeros(T, dtype=torch.long)
    tok_off = torch.zeros(T, dtype=torch.long)
    tok_ok = torch.zeros(T, dtype=torch.bool)
    for c in range(C):
        tok_chunk[cu[c]:cu[c + 1]] = c
        tok_off[cu[c]:cu[c + 1]] = torch.arange(cu[c + 1] - cu[c])
        tok_ok[cu[c]:cu[c] + lens_c[c]] = True
    owner = torch.tensor(ctx_owner, dtype=torch.long)
    m_ctx = (tok_chunk[:, None] == owner[None, :]) & tok_ok[:, None]
    m_in = ((tok_chunk[:, None] == tok_chunk[None, :]) & tok_ok[:, None] & tok_ok[None, :]
            & (tok_off[:, None] >= tok_off[None, :]))
    lmask = torch.cat([m_ctx, m_in], dim=1).to(dev)[None, None]
    ctx_pages = torch.cat([tables[c, : pos0[c] // PAGE] for c in range(C)]).long()

    def packed(q_, k_, v_, kpool, vpool):
        expand = lambda t: t.transpose(0, 1).repeat_interleave(rep, dim=0)[None]
        return (q_.transpose(0, 1)[None],
                expand(torch.cat([kpool[ctx_pages].reshape(-1, kvh, d), k_])),
                expand(torch.cat([vpool[ctx_pages].reshape(-1, kvh, d), v_])))

    pairs = sum(lens_c[c] * pos0[c] + lens_c[c] * (lens_c[c] + 1) // 2 for c in range(C))
    ctx_rows = sum(pos0)
    for mode in KV_MODES:
        kp, vpl, ks, vs, row_bytes, k_lib, v_lib = pools(mode)
        name = _name("varlen_prefill", mode)
        vargs = (qp, kp_, vpk, kp, vpl, *meta, tables)
        out = vp.varlen_prefill(*vargs, pages_bound=ctx_bound, k_scales=ks, v_scales=vs)
        want = ref.varlen_prefill(*vargs, pages_bound=ctx_bound, k_scales=ks, v_scales=vs)
        err = _check(torch, name, out, want)
        if mode is None:
            short = list(pos0)
            short[0] -= PAGE                     # chunk 0 sees one context page too few
            _rejects(torch, "varlen_prefill plain with one context page dropped",
                     ref.varlen_prefill(*vargs[:7],
                                        torch.tensor(short, dtype=torch.int32, device=dev),
                                        tables, pages_bound=ctx_bound), want)
        pad_zero = all(bool((out[a:b] == 0).all()) for a, b in real)
        print(f"   {name}: pad rows exactly zero: {pad_zero}")
        if not pad_zero:
            raise SystemExit(f"{name}: pad rows are not exactly zero")
        nbytes = (2 * (2 * T * h * d + 2 * T * kvh * d) + 2 * ctx_rows * kvh * row_bytes
                  + 4 * (3 * C + 1 + C * max_pages))
        sets = _rotation(nbytes, lambda i: (qp.clone(), kp_.clone(), vpk.clone(),
                                            *map(cl, (kp, vpl, ks, vs))))
        lib_sets = _rotation(2 * (T * h * d + 2 * h * (ctx_rows + T) * d),
                             lambda i: packed(qp.clone(), kp_, vpk, k_lib, v_lib))
        records[name] = dict(
            err=err,
            **timed(lambda q_, k_, v_, kpool, vpool, ks_, vs_: vp.varlen_prefill(
                        q_, k_, v_, kpool, vpool, *meta, tables, pages_bound=ctx_bound,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_, kpool, vpool, ks_, vs_: ref.varlen_prefill(
                        q_, k_, v_, kpool, vpool, *meta, tables, pages_bound=ctx_bound,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=lmask),
                    sets, lib_sets),
            bound=_bound_ms(nbytes, 4.0 * h * d * pairs),
            shape=f"T {T}, chunks (take, ctx pages) {chunk_specs} + {C - len(chunk_specs)} "
                  f"empty, bf16, pool {pool_desc(mode)}",
        )
        del sets, lib_sets
    # whole vs split: the longest of the first SLOTS serve prompts prefilled
    # as one chunk and split at page 13 (208 keys: a page boundary inside a
    # 32-key tile), its first part committed to a bf16 pool, must give the
    # same bits for the rows of the second part
    p_v = vp.plan(bf, d, rep, PAGE)
    print(f"   varlen_prefill bf16 plan: {p_v}")
    n = int(max(_serve_lengths(SEED)[:SLOTS]))
    cut = 13 * PAGE
    rows = [randn(n, c, d) for c in (h, kvh, kvh)]
    pages = -(-n // PAGE)
    pool = [torch.zeros((pages + 1, PAGE, kvh, d), dtype=bf, device=dev) for _ in range(2)]
    for pl, t in zip(pool, rows[1:]):
        pl.view(-1, kvh, d)[PAGE:PAGE + n] = t
    tbl = torch.arange(1, pages + 1, dtype=torch.int32, device=dev).view(1, pages)

    def one_chunk(start):
        part = [t[start:] for t in rows]
        length = n - start
        packed = [torch.cat([t, randn(BUDGET - length, t.shape[1], d)]) for t in part]
        meta = [torch.tensor(a, dtype=torch.int32, device=dev)
                for a in ([0, -(-length // PAGE) * PAGE], [length], [start])]
        return vp.varlen_prefill(*packed, *pool, *meta, tbl)[:length]

    whole, split = one_chunk(0), one_chunk(cut)
    same = torch.equal(whole[cut:], split)
    _check(torch, f"varlen_prefill one {n}-token chunk vs flash_attention's plain version", whole,
           ref.attention(rows[0][None], rows[1][None], rows[2][None])[0])
    print(f"   varlen_prefill: a {n}-token prompt whole, and split at key {cut} over {cut // PAGE} "
          f"context pages, gives the same bits on its last {n - cut} rows: {same}")
    if not same:
        raise SystemExit("varlen_prefill: a split prompt differs from the whole one")
    del rows, pool
    _print_records(records)
    return records


def dense_kernels_phase(torch, dev):
    """flash_attention and decode_attention against their plain versions at
    the shapes of the dense engines' serve runs (a static prefill pass of
    SLOTS prompts padded to PREFILL_LEN; a decode step of SLOTS rows over a
    MAX_SEQ cache at the serve phase's lengths), plus small cases with a
    window, softcap, q_offset, no causal mask and a row of length 0."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.serve.engine import bucket_pow2

    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=bf)
    cpm = _sleep_cycles_per_ms(torch)
    timed = lambda *a: _timed(torch, cpm, *a)
    h, kvh, d = 32, 2, 128
    rep = h // kvh
    expand = lambda t: t.transpose(1, 2).repeat_interleave(rep, dim=1)   # (b, h, s, d)
    records = {}

    # -- flash_attention: one static prefill pass, causal
    b, s = SLOTS, PREFILL_LEN
    q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
    want = ref.attention(q, k, v)
    err = _check(torch, "flash_attention causal", fa.flash_attention(q, k, v), want)
    # key 0 dropped from every row (row 0 then has no key at all)
    _rejects(torch, "flash_attention plain without key 0",
             ref.attention(q, k[:, 1:], v[:, 1:], q_offset=-1), want)
    del want
    qs, ks, vs = randn(2, 128, h, d), randn(2, 384, kvh, d), randn(2, 384, kvh, d)
    for opts in ({"window": 64, "q_offset": 256}, {"softcap": 30.0, "q_offset": 256},
                 {"causal": False}):
        err = max(err, _check(torch, f"flash_attention q (2, 128), k (2, 384), {opts}",
                              fa.flash_attention(qs, ks, vs, **opts),
                              ref.attention(qs, ks, vs, **opts)))
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

    def flash_sets(q_, k_, v_):
        """Kernel and library input sets of a causal pass (q_ (b, s, h, d))."""
        b_, s_ = q_.shape[:2]
        nbytes = 2 * (2 * b_ * s_ * h * d + 2 * b_ * s_ * kvh * d)
        return (nbytes, _rotation(nbytes, lambda i: (q_.clone(), k_.clone(), v_.clone())),
                _rotation(2 * 4 * b_ * s_ * h * d,
                          lambda i: (q_.transpose(1, 2).contiguous(), expand(k_), expand(v_))))

    nbytes, sets, lib_sets = flash_sets(q, k, v)
    records["flash_attention"] = dict(
        err=err,
        **timed(fa.flash_attention, ref.attention, sdpa, sets, lib_sets),
        bound=_bound_ms(nbytes, 4.0 * h * d * b * s * (s + 1) / 2),
        shape=f"q ({b}, {s}, {h}, {d}), k/v ({b}, {s}, {kvh}, {d}) bf16, causal",
    )
    del q, k, v, sets, lib_sets
    # a continuous admission: one row padded to PREFILL_LEN
    q1, k1, v1 = randn(1, s, h, d), randn(1, s, kvh, d), randn(1, s, kvh, d)
    _check(torch, "flash_attention causal, batch 1", fa.flash_attention(q1, k1, v1),
           ref.attention(q1, k1, v1))
    nbytes1, sets, lib_sets = flash_sets(q1, k1, v1)
    one = timed(fa.flash_attention, ref.attention, sdpa, sets, lib_sets)
    bound1 = _bound_ms(nbytes1, 4.0 * h * d * s * (s + 1) / 2)
    print(f"   flash_attention at a continuous admission q (1, {s}, {h}, {d}): kernel_ms "
          f"{one['ms']:.4f} plain_ms {one['plain_ms']:.4f} library_ms {one['library_ms']:.4f} "
          f"bound_ms {bound1[0]:.4f} ({bound1[1]}); host gaps in: {one['gaps'] or 'none'}")
    del q1, k1, v1, sets, lib_sets
    # padding independence: the longest of the first SLOTS serve prompts,
    # right-padded with other values to PREFILL_LEN and to MAX_SEQ, and
    # batched beside another row, must give the same bits on its real rows
    n = int(max(_serve_lengths(SEED)[:SLOTS]))
    real = [randn(1, n, c, d) for c in (h, kvh, kvh)]
    padded = lambda length: [torch.cat([t, randn(1, length - n, t.shape[2], d)], 1) for t in real]
    rows = [fa.flash_attention(*padded(PREFILL_LEN))[0, :n]]
    rows.append(fa.flash_attention(*padded(MAX_SEQ))[0, :n])
    pair = [torch.cat([t, randn(1, MAX_SEQ, t.shape[2], d)]) for t in padded(MAX_SEQ)]
    rows.append(fa.flash_attention(*pair)[0, :n])
    same = all(torch.equal(rows[0], r) for r in rows[1:])
    print(f"   flash_attention: a {n}-token prompt padded to {PREFILL_LEN} and to {MAX_SEQ}, and "
          f"batched beside another row, gives the same bits on its real rows: {same}")
    if not same:
        raise SystemExit("flash_attention: a row's output depends on the padding or the batch")
    del real, rows, pair

    # -- decode_attention: one decode step over the dense cache
    lens_host = [int(n) + NEW_TOKENS for n in _serve_lengths(SEED)[:SLOTS]]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    bound = bucket_pow2(max(lens_host), floor=PAGE, cap=MAX_SEQ)
    q, kc, vc = randn(SLOTS, 1, h, d), randn(SLOTS, MAX_SEQ, kvh, d), randn(SLOTS, MAX_SEQ, kvh, d)
    want = ref.decode_attention(q, kc, vc, lengths, kv_bound=bound)
    err = _check(torch, f"decode_attention kv_bound {bound}",
                 da.decode_attention(q, kc, vc, lengths, kv_bound=bound), want)
    _rejects(torch, "decode_attention plain with lengths - 1",
             ref.decode_attention(q, kc, vc, lengths - 1, kv_bound=bound), want)
    with_zero = lengths.clone()
    with_zero[3] = 0
    out = da.decode_attention(q, kc, vc, with_zero, window=100, kv_bound=bound)
    err = max(err, _check(torch, "decode_attention window 100, row 3 of length 0", out,
                          ref.decode_attention(q, kc, vc, with_zero, window=100, kv_bound=bound)))
    zero = bool((out[3] == 0).all())
    print(f"   decode_attention: the row of length 0 exactly zero: {zero}")
    if not zero:
        raise SystemExit("decode_attention: a row of length 0 is not exactly zero")
    # bf16 runs paged_attention's split-KV routine over the cache viewed as
    # a pool: the same bits as paged_attention over the identity table
    kp, vp_, pages, _ = da.pool_view(kc, vc, bound)
    tbl = da.identity_table(SLOTS, MAX_SEQ // da.BLOCK_K, dev)
    same = torch.equal(da.decode_attention(q, kc, vc, lengths, kv_bound=bound),
                       pa.paged_attention(q, kp, vp_, tbl, lengths, pages_bound=pages))
    print(f"   decode_attention kv_bound {bound} == paged_attention over the identity table "
          f"({pages} of {tbl.shape[1]} pages a row): {same}")
    if not same:
        raise SystemExit("decode_attention: differs from paged_attention over the same keys")
    live = sum(lens_host)
    nbytes = 2 * 2 * SLOTS * h * d + 2 * 2 * live * kvh * d + 4 * SLOTS
    sets = _rotation(nbytes, lambda i: (q.clone(), kc.clone(), vc.clone()))
    mask = (torch.arange(bound, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib_sets = _rotation(2 * 2 * SLOTS * h * bound * d,
                         lambda i: (q.transpose(1, 2).contiguous(), expand(kc[:, :bound]),
                                    expand(vc[:, :bound])))
    records["decode_attention"] = dict(
        err=err,
        **timed(lambda q_, k_, v_: da.decode_attention(q_, k_, v_, lengths, kv_bound=bound),
                lambda q_, k_, v_: ref.decode_attention(q_, k_, v_, lengths, kv_bound=bound),
                lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask),
                sets, lib_sets),
        bound=_bound_ms(nbytes, 4.0 * h * d * live),
        shape=f"q ({SLOTS}, 1, {h}, {d}), cache ({SLOTS}, {MAX_SEQ}, {kvh}, {d}) bf16, "
              f"lengths {lens_host}, kv_bound {bound}",
    )
    del sets, lib_sets
    _print_records(records)
    return records


def _ssd_flops(b, s, h, p, n, chunk):
    """Operations of the chunked scan on these shapes: per chunk of L live
    timesteps, C.B^T over its causal pairs (shared by the heads) and, per
    head, the intra-chunk product over the causal pairs, the inter-chunk
    term and the state update (2 per multiply-add)."""
    total = 0
    for t0 in range(0, s, chunk):
        L = min(chunk, s - t0)
        pairs = L * (L + 1) // 2
        total += 2 * pairs * n + h * (2 * pairs * p + 4 * L * p * n)
    return b * total


def ssd_kernels_phase(torch, dev):
    """ssd against its plain version at mamba2-130m widths: the static
    prefill pass (SLOTS rows of the longest of the first SLOTS serve
    prompts: 13 full chunks and a partial one), a partial trailing chunk, a
    sequence shorter than a chunk, an initial state and zamba2's state
    width (n 64); y and the final state each.  dt and A span the ranges
    mamba2's inits give."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as sd

    cfg = get_config("mamba2-130m")
    h, p, n, chunk = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    cpm = _sleep_cycles_per_ms(torch)

    def inputs(b, s, init, n_=n):
        randn = lambda *shape, dt_=torch.bfloat16: torch.randn(shape, generator=gen, device=dev,
                                                               dtype=dt_)
        uniform = lambda shape, lo, hi: torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
        x, B, C = randn(b, s, h, p), randn(b, s, n_), randn(b, s, n_)
        dt, A = uniform((b, s, h), 1e-3, 1e-1), -uniform((h,), 1.0, 16.0)
        return x, dt, A, B, C, (randn(b, h, p, n_, dt_=torch.float32) if init else None)

    pl = sd.plan(torch.bfloat16, p, n, chunk)
    s_pass = int(max(_serve_lengths(SEED)[:SLOTS]))
    s1 = int(max(_serve_lengths(SEED)))
    print(f"   ssd plan (bf16, p {p}, n {n}, chunk {chunk}): {pl.kernel}, {pl.head_group} heads a "
          f"block, shared memory per launch {pl.smem_bytes} B; blocks per launch "
          f"{sd.blocks(pl, SLOTS, s_pass, h, p, n, chunk)} at the static pass, "
          f"{sd.blocks(pl, 1, s1, h, p, n, chunk)} at a batch-1 admission (1, {s1}); workspace "
          f"{sd.workspace_bytes(pl, SLOTS, s_pass, h, p, n, chunk) / 1e6:.1f} MB / "
          f"{sd.workspace_bytes(pl, 1, s1, h, p, n, chunk) / 1e6:.1f} MB")
    err = 0.0
    for label, b, s, init, n_ in (("static pass", SLOTS, s_pass, False, n),
                                  ("partial trailing chunk", 2, 100, False, n),
                                  ("s < chunk", 2, 40, False, n),
                                  ("initial state", 2, 130, True, n),
                                  ("zamba2 state width", 2, 150, True, 64)):
        x, dt, A, B, C, s0 = inputs(b, s, init, n_)
        y, sf = sd.ssd(x, dt, A, B, C, chunk=chunk, initial_state=s0, return_state=True)
        y_want, sf_want = ref.ssd(x, dt, A, B, C, initial_state=s0, return_state=True)
        shape = f"({b}, {s}, {h}, {p}), n {n_}, chunk {chunk}"
        err = max(err, _check(torch, f"ssd {label} {shape}: y", y, y_want),
                  _check(torch, f"ssd {label}: final state", sf, sf_want))
        if label == "initial state":
            _rejects(torch, "ssd plain without the initial state", ref.ssd(x, dt, A, B, C), y_want)
        if label == "static pass":
            short = ref.ssd(x[:, :-1], dt[:, :-1], A, B[:, :-1], C[:, :-1], return_state=True)[1]
            _rejects(torch, "ssd plain final state one timestep short", short, sf_want)
            pass_inputs = (x, dt, A, B, C)
    x, dt, A, B, C = pass_inputs
    b, s = SLOTS, s_pass
    nbytes = 2 * 2 * b * s * h * p + 2 * 2 * b * s * n + 4 * b * s * h + 4 * h + 2 * b * h * p * n
    sets = _rotation(nbytes, lambda i: (x.clone(), dt.clone(), A, B.clone(), C.clone()))
    records = {"ssd": dict(
        err=err,
        **_timed(torch, cpm,
                 lambda *a: sd.ssd(*a, chunk=chunk, return_state=True),
                 lambda *a: ref.ssd(*a, return_state=True), None, sets, []),
        bound=_bound_ms(nbytes, _ssd_flops(b, s, h, p, n, chunk)),
        shape=f"x ({b}, {s}, {h}, {p}) bf16, B/C n {n}, chunk {chunk}, final state out",
    )}
    del sets
    # a continuous admission: one row of the longest serve prompt
    one = inputs(1, s1, False)[:5]
    ms1, _ = _time_ms(torch, lambda *a: sd.ssd(*a, chunk=chunk, return_state=True),
                      _rotation(nbytes * s1 // (SLOTS * s), lambda i: tuple(t.clone() for t in one)),
                      cpm)
    print(f"   ssd at a batch-1 admission x (1, {s1}, {h}, {p}): kernel_ms {ms1:.4f} "
          f"(blocks per launch {sd.blocks(pl, 1, s1, h, p, n, chunk)} on the card's 132 SMs)")
    _print_records(records)
    return records


def _tiled_requests(n, lo, hi, new_tokens, vocab, seed):
    """Repetitive prompts, as ``benchmarks/bench_spec.py`` makes them: a
    short random phrase (3-5 tokens) tiled to a length uniform in
    ``[lo, hi]``, the document-grounded text that prompt lookup drafts
    from."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        phrase = rng.integers(0, vocab, (int(rng.integers(3, 6)),))
        length = int(rng.integers(lo, hi + 1))
        prompt = np.tile(phrase, length // len(phrase) + 1)[:length].astype(np.int32)
        reqs.append(ServeRequest(request_id=i, prompt=prompt, max_new_tokens=new_tokens))
    return reqs


def _agreement(want, got):
    """(tokens equal position by position, tokens in all, the first
    divergence as (request, index) at the smallest index, or None)."""
    import numpy as np

    same = total = 0
    first = None
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = np.asarray(a), np.asarray(b)
        n = min(len(a), len(b))
        eq = a[:n] == b[:n]
        same += int(eq.sum())
        total += len(a)
        if not eq.all() or len(a) != len(b):
            at = int(np.argmin(eq)) if not eq.all() else n
            if first is None or at < first[1]:
                first = (i, at)
    return same, total, first


def _fmt_repeats(results, n=3):
    """How repetitive the greedy streams are: prompt lookup drafts only
    from a repeat of the last ``n`` tokens."""
    distinct = [len(set(r.tokens.tolist())) for r in results]
    repeating = sum(
        1 for r in results
        if len({tuple(r.tokens[i:i + n]) for i in range(len(r.tokens) - n + 1)})
        < len(r.tokens) - n + 1)
    return (f"distinct tokens per request {min(distinct)}-{max(distinct)} of "
            f"{len(results[0].tokens)}, requests repeating a {n}-gram {repeating}/{len(results)}")


def _fmt_agreement(want, got):
    same, total, first = _agreement(want, got)
    where = "none" if first is None else f"request {first[0]} token {first[1]}"
    return f"{same}/{total} tokens equal, first divergence: {where}"


def check_phase(torch, dev):
    """Reduced glm4-9b in float32: the card's greedy tokens equal the CPU's,
    plain and speculative, and speculative equals plain; card vs CPU on
    int8 and fp8 pools is printed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import ServingEngine

    cfg = get_config("glm4-9b", reduced=True)
    cpu_model = DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu_params = cpu_model.init(seed=SEED)
    gpu_model = DecoderLM(cfg, device=dev, dtype=torch.float32)
    gpu_params = _to_device(cpu_params, dev)
    plain_reqs = lambda: make_requests(6, 5, 60, 8, cfg.vocab_size, SEED)
    tiled_reqs = lambda: _tiled_requests(6, 16, 60, 16, cfg.vocab_size, SEED)
    runs = {}
    for kv_dtype in KV_MODES:
        for name, model, params in (("cpu", cpu_model, cpu_params),
                                    ("cuda", gpu_model, gpu_params)):
            engine = ServingEngine(model, params, max_batch=3, max_seq=96, page_size=PAGE,
                                   device=model.device, kv_dtype=kv_dtype)
            runs[name, kv_dtype, 0] = engine.serve_paged(plain_reqs(), prefill_budget=64)
            if kv_dtype is None:
                for k in (0, SPEC_K):
                    runs[name, "tiled", k] = engine.serve_paged(
                        tiled_reqs(), prefill_budget=64, spec_k=k, spec_ngram=1)
    tok = lambda key: [r.tokens for r in runs[key].results]
    same = lambda a, b: _agreement(tok(a), tok(b))[2] is None
    plain_ok = same(("cpu", None, 0), ("cuda", None, 0))
    print(f"   reduced glm4-9b f32, 6 requests: cuda tokens == cpu tokens: {plain_ok}")
    spec = runs["cuda", "tiled", SPEC_K]
    spec_ok = (same(("cpu", "tiled", SPEC_K), ("cuda", "tiled", SPEC_K))
               and same(("cuda", "tiled", 0), ("cuda", "tiled", SPEC_K))
               and same(("cpu", "tiled", 0), ("cuda", "tiled", 0)))
    print(f"   reduced glm4-9b f32, 6 tiled prompts, spec_k {SPEC_K}: cuda spec tokens == cpu "
          f"spec tokens == cuda plain tokens: {spec_ok}; cuda {spec.spec_stats}")
    if not plain_ok:
        raise SystemExit("the card's greedy tokens differ from the CPU reference")
    if not spec_ok:
        raise SystemExit("speculative tokens differ from the CPU's or from plain decoding")
    if not spec.spec_stats["spec_launches"]:
        raise SystemExit("the reduced speculative check ran no verify step")
    for mode in KV_MODES[1:]:
        print(f"   reduced glm4-9b f32, {mode} pool, card vs CPU: "
              f"{_fmt_agreement(tok(('cpu', mode, 0)), tok(('cuda', mode, 0)))}")


def dense_check_phase(torch, dev, arch="glm4-9b"):
    """Reduced ``arch`` in float32 on the dense engines: the card's greedy
    tokens from ``generate`` and ``serve_continuous`` equal the CPU's, and
    ``forward`` logits agree."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import ServingEngine

    cfg = get_config(arch, reduced=True)
    cpu_model = DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu_params = cpu_model.init(seed=SEED)
    gpu_model = DecoderLM(cfg, device=dev, dtype=torch.float32)
    gpu_params = _to_device(cpu_params, dev)
    reqs = make_requests(6, 5, 60, 8, cfg.vocab_size, SEED)
    prompts = [r.prompt for r in reqs]
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 48)))
    out = {}
    for name, model, params in (("cpu", cpu_model, cpu_params), ("cuda", gpu_model, gpu_params)):
        engine = ServingEngine(model, params, max_batch=3, max_seq=96, page_size=PAGE,
                               device=model.device)
        static = np.concatenate([engine.generate(prompts[i:i + 3], 8).tokens for i in (0, 3)])
        cont = engine.serve_continuous(make_requests(6, 5, 60, 8, cfg.vocab_size, SEED))
        logits, _ = model.forward(params, {"tokens": tokens.to(model.device)})
        out[name] = (static, [r.tokens for r in cont.results], logits.cpu())
    static_ok = bool((out["cpu"][0] == out["cuda"][0]).all())
    cont_ok = _agreement(out["cpu"][1], out["cuda"][1])[2] is None
    diff = float((out["cpu"][2] - out["cuda"][2]).abs().max())
    logits_ok = bool(torch.allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4, atol=1e-4))
    print(f"   {cfg.name} f32, 6 requests: generate cuda tokens == cpu tokens: {static_ok}; "
          f"serve_continuous cuda == cpu: {cont_ok}; forward logits {tuple(out['cpu'][2].shape)} "
          f"max |cuda - cpu| {diff:.3e} (within 1e-4 + 1e-4 |cpu|: {logits_ok}); "
          f"continuous == generate on the card: "
          f"{_agreement(list(out['cuda'][0]), out['cuda'][1])[2] is None}")
    if not (static_ok and cont_ok and logits_ok):
        raise SystemExit(f"{cfg.name}: the dense engines on the card differ from the CPU reference")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


# the end-to-end metrics this script prints, as the driver defines them
# (repro_torch.launch.serve.static_metrics / engine_metrics)
SERVE_KEYS = ("prefill_tok_per_s", "decode_tok_per_s", "decode_step_ms", "ttft_p50_ms",
              "ttft_p99_ms", "wall_s")


def _serve_metrics(m):
    return {k: m[k] for k in SERVE_KEYS}


def _fmt_metrics(m, stats):
    return (f"prefill {stats.prefill_launches} launches, {stats.prefill_tokens} tokens, "
            f"{m['prefill_tok_per_s']:.1f} tok/s; decode {stats.steps} steps, "
            f"{m['decode_tok_per_s']:.1f} tok/s, mean step {m['decode_step_ms']:.3f} ms; "
            f"ttft p50 {m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; "
            f"wall {m['wall_s']:.3f} s")


def _median_spread(label, runs):
    med = {k: sorted(r[k] for r in runs)[len(runs) // 2] for k in runs[0]}
    spread = {k: max(r[k] for r in runs) - min(r[k] for r in runs) for k in runs[0]}
    print(f"   {label}median of {len(runs)} runs: " + ", ".join(
        f"{k} {med[k]:.3f} (max-min {spread[k]:.3f})" for k in med))


def _expected_launches(stats, num_layers):
    """Launches each kernel must show for one serve run: 81 rmsnorm per
    pass (prefill launch or decode step), 40 attention per layer pass of
    its kind (verify steps launch spec_verify, plain steps paged_attention)."""
    verify = int(stats.spec_stats.get("spec_launches", 0))
    return {
        "rmsnorm": (2 * num_layers + 1) * (stats.steps + stats.prefill_launches),
        "paged_attention": num_layers * (stats.steps - verify),
        "spec_verify": num_layers * verify,
        "varlen_prefill": num_layers * stats.prefill_launches,
    }


def _zero(counters):
    for mod in counters.values():
        mod.launches = 0


def _check_counts(label, counters, expect, done, total):
    """Fail unless every request completed and each kernel launched exactly
    as often as the run's passes imply."""
    counts = {name: mod.launches for name, mod in counters.items()}
    if done != total:
        raise SystemExit(f"{label}: only {done} of {total} requests completed")
    for name, n in counts.items():
        if n != expect.get(name, 0):
            raise SystemExit(f"{label}: {n} {name} launches, expected {expect.get(name, 0)}")
    return counts


def _completed(token_lists, vocab):
    """Requests that hold NEW_TOKENS tokens, all inside the vocabulary."""
    return sum(1 for t in token_lists if len(t) == NEW_TOKENS and all(0 <= x < vocab for x in t))


def _counted_serve(torch, engine, reqs, counters, need, **kw):
    """One serve run with the launch counts zeroed just before and read just
    after; fails unless every request completed, every count is what the
    run's steps imply, and every kernel in ``need`` launched."""
    _zero(counters)
    stats = engine.serve_paged(reqs, num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET,
                               **kw)
    done = _completed([r.tokens for r in stats.results if r.status == "completed"],
                      engine.model.cfg.vocab_size)
    counts = _check_counts("serve_paged", counters,
                           _expected_launches(stats, engine.model.cfg.num_layers), done, len(reqs))
    missing = [name for name in need if counts[name] == 0]
    if missing:
        raise SystemExit(f"serve_paged: no launch of {missing} in a run that needs them")
    return stats, counts


def full_model(torch, dev, arch="glm4-9b"):
    """``arch`` at published width and depth, random bf16 weights from a
    seeded CUDA generator."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM, count_params

    cfg = get_config(arch)
    model = DecoderLM(cfg, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(seed=SEED)
    torch.cuda.synchronize()
    n_params = count_params(model.param_defs())
    print(f"   {cfg.name}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B params, "
          f"bf16 weights {n_params * 2 / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s")
    return model, params


def serve_phase(torch, dev, counters, model, params):
    from repro_torch.kernels import kvquant
    from repro_torch.launch.serve import engine_metrics, make_requests
    from repro_torch.serve.engine import ServingEngine

    cfg = model.cfg
    engines = {
        mode: ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                            device=dev, kv_dtype=mode)
        for mode in KV_MODES
    }
    engine = engines[None]
    # warm-up (cuBLAS handles, allocator, each pool type and the verify
    # step) on two short requests, not counted
    for mode, eng in engines.items():
        for k in (0, SPEC_K):
            eng.serve_paged(_tiled_requests(2, 16, 32, 6, cfg.vocab_size, SEED + 1),
                            prefill_budget=BUDGET, spec_k=k, spec_ngram=1)
    reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, cfg.vocab_size, SEED)
    if [len(r.prompt) for r in reqs] != list(_serve_lengths(SEED)):
        raise SystemExit("serve prompts differ from the lengths the kernel phase used")
    torch.cuda.reset_peak_memory_stats(dev)
    plain_need = ("rmsnorm", "paged_attention", "varlen_prefill")
    stats, counts = _counted_serve(torch, engine, reqs, counters, plain_need)
    print(f"   requests {len(reqs)} (prompts {PROMPT_MIN}-{PROMPT_MAX}, {NEW_TOKENS} new), "
          f"completed {len(stats.results)}, slots {SLOTS}, page {PAGE}, max_seq {MAX_SEQ}, "
          f"budget {BUDGET}, pool pages {stats.num_pages}, "
          f"kv bytes/token {stats.kv_bytes_per_token:.0f}, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    runs = [_serve_metrics(engine_metrics(stats))]
    print(f"   run 1: {_fmt_metrics(runs[0], stats)}; {_fmt_repeats(stats.results)}")
    print(f"   launches in run 1: {counts}")
    launches = {name: counts[name] for name in plain_need}
    # the same requests again: the spread of the end-to-end metrics
    for i in range(2, REPEATS + 1):
        again = engine.serve_paged(reqs, num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET)
        same = all(bool((a.tokens == b.tokens).all()) for a, b in zip(again.results, stats.results))
        runs.append(_serve_metrics(engine_metrics(again)))
        print(f"   run {i}: {_fmt_metrics(runs[-1], again)}; tokens as run 1: {same}")
    _median_spread("", runs)

    # speculative decoding on tiled prompts, and int8/fp8 pools: each run
    # counted alone, tokens held against the bf16 plain run of its prompts
    tiled = _tiled_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, cfg.vocab_size, SEED)
    base_tiled = engine.serve_paged(tiled, num_slots=SLOTS, page_size=PAGE,
                                    prefill_budget=BUDGET)
    print(f"   tiled prompts, bf16 plain: "
          f"{_fmt_metrics(engine_metrics(base_tiled), base_tiled)}; "
          f"{_fmt_repeats(base_tiled.results)}")
    bf16_bytes = kvquant.kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads,
                                            cfg.resolved_head_dim, "bfloat16")
    plan = [(None, SPEC_K, SPEC_NGRAM)]
    for mode in KV_MODES:
        plan += [(mode, 0, None)] if mode else []
        plan += [(mode, SPEC_K, DRAFT_NGRAM)]
    for mode, k, ngram in plan:
        prompts, base = (tiled, base_tiled) if k else (reqs, stats)
        need = plain_need if not k else ("rmsnorm", "varlen_prefill") + (
            ("spec_verify",) if ngram == DRAFT_NGRAM else ())
        st, cnt = _counted_serve(torch, engines[mode], prompts, counters, need,
                                 spec_k=k, spec_ngram=ngram or 1)
        label = f"{mode or 'bf16'} pool, " + (
            f"spec_k {k} spec_ngram {ngram}, tiled prompts" if k else "plain, the run-1 prompts")
        want_bytes = bf16_bytes if mode is None else kvquant.kv_bytes_per_token(
            cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, mode)
        print(f"   {label}: {_fmt_metrics(engine_metrics(st), st)}")
        print(f"      spec_stats {st.spec_stats or 'off'}; pool bytes/token "
              f"{st.kv_bytes_per_token:.0f} (bf16 {bf16_bytes}); launches {cnt}; vs bf16 "
              f"plain: {_fmt_agreement([r.tokens for r in base.results], [r.tokens for r in st.results])}")
        if st.kv_bytes_per_token != want_bytes:
            raise SystemExit(f"{label}: {st.kv_bytes_per_token} pool bytes per token, "
                             f"expected {want_bytes}")
        if ngram != SPEC_NGRAM:
            for name in need:
                if name != "rmsnorm":
                    launches.setdefault(_name(name, mode), cnt[name])
    return launches, engine, reqs


def _dense_expected(model, passes, steps):
    """Launches a dense-engine run of ``passes`` prefill passes and
    ``steps`` decode steps must show: 2L + 1 rmsnorm per pass and per step;
    per layer one flash_attention per pass and one decode_attention per step
    (dense family), or one ssd per pass and none per step (SSM family, whose
    decode step is plain torch).  Every other kernel: none."""
    L = model.cfg.num_layers
    expect = {"rmsnorm": (2 * L + 1) * (passes + steps)}
    if model.ssm:
        expect["ssd"] = L * passes
    else:
        expect.update(flash_attention=L * passes, decode_attention=L * steps)
    return expect


def dense_serve_phase(torch, dev, counters, model, params):
    """``model`` through the dense engines: the static path (Poisson
    arrivals, the threaded scheduler batching ``generate``) and
    ``serve_continuous``, REPEATS runs each on the serve phase's requests,
    each run counted alone (``_dense_expected``): for glm4-9b 40
    flash_attention and 81 rmsnorm launches per prefill pass, 40
    decode_attention and 81 rmsnorm per decode step; for mamba2-130m 24 ssd
    and 49 rmsnorm per pass, 49 rmsnorm per step; no other kernel."""
    from repro_torch.core.workload import PoissonLoad
    from repro_torch.launch.serve import engine_metrics, make_requests, serve_static, static_metrics
    from repro_torch.serve.engine import ServingEngine

    cfg = model.cfg
    vocab = cfg.vocab_size
    engine = ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                           device=dev)
    reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, vocab, SEED)
    prompts = [r.prompt for r in reqs]
    arrivals = [r.arrival_s for r in PoissonLoad(REQUESTS, RATE_HZ, seed=SEED).requests()]
    # warm-up (allocator, cuBLAS handles, the scheduler thread), not counted
    warm = make_requests(2, 16, 32, 4, vocab, SEED + 1)
    serve_static(engine, [r.prompt for r in warm], [0.0, 0.0], 4, BATCH_TIMEOUT_MS,
                 log=lambda _: None)
    engine.serve_continuous(warm, num_slots=SLOTS)
    metrics = {"static": [], "continuous": []}
    launches, tokens = {}, {}
    # the SSM family left-pads to the exact longest prompt of each batch or
    # admission set; the dense family right-pads to the pow2 bucket
    pad = ("left-padded to the batch's longest" if model.ssm
           else "right-padded to the batch bucket")
    cont_len = max(len(p) for p in prompts) if model.ssm else PREFILL_LEN
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(1, REPEATS + 1):
        _zero(counters)
        run = serve_static(engine, prompts, arrivals, NEW_TOKENS, BATCH_TIMEOUT_MS,
                           log=lambda _: None)
        passes = len(run.batches)
        steps = passes * NEW_TOKENS
        counts = _check_counts(f"{cfg.name} static run {i}", counters,
                               _dense_expected(model, passes, steps),
                               _completed(run.tokens, vocab), len(reqs))
        m = _serve_metrics(static_metrics(run))
        metrics["static"].append(m)
        print(f"   static run {i}: batches {[bt[0] for bt in run.batches]}, prefill passes "
              f"{passes} ({sum(bt[1] for bt in run.batches)} prompt tokens, {pad}), decode "
              f"steps {steps}; "
              + ", ".join(f"{k} {v:.3f}" for k, v in m.items()) + f"; launches {counts}")
        if i == 1:
            launches.update(counts)
            tokens["static"] = run.tokens
        _zero(counters)
        st = engine.serve_continuous(reqs, num_slots=SLOTS)
        counts = _check_counts(f"{cfg.name} continuous run {i}", counters,
                               _dense_expected(model, len(reqs), st.steps),
                               _completed([r.tokens for r in st.results], vocab), len(reqs))
        m = _serve_metrics(engine_metrics(st))
        metrics["continuous"].append(m)
        print(f"   continuous run {i}: {len(reqs)} admissions (batch-1 prefills padded to "
              f"{cont_len}), decode steps {st.steps}, mean slot occupancy "
              f"{st.mean_slot_occupancy:.2f}; " + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
              + f"; launches {counts}")
        if i == 1:
            tokens["continuous"] = [r.tokens for r in st.results]
    for path, runs in metrics.items():
        _median_spread(f"{path}, ", runs)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"   peak device memory {peak / 1e9:.2f} GB, {(peak - resident) / 1e9:.2f} GB above "
          f"the {resident / 1e9:.2f} GB resident before the runs; "
          f"continuous vs static tokens (bf16, other batch shapes): "
          f"{_fmt_agreement(tokens['static'], tokens['continuous'])}")
    return launches, engine, prompts


_CLASSES = (
    ("flash_attention", ("flash_attention_kernel",)),
    ("decode_attention", ("decode_attention_kernel",)),
    ("paged_attention", ("paged_attention_kernel",)),
    ("spec_verify", ("spec_verify_kernel",)),
    ("varlen_prefill", ("varlen_prefill_kernel",)),
    ("ssd", ("ssd_kernel",)),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
)


def _kernel_class(name, split_class):
    """The class of a device kernel by name; the bf16 decode family's
    split-KV routine (``decode_split_kernel`` and its combine) is reported
    under ``split_class``, the kernel of the engine being profiled."""
    if "decode_split" in name:
        return split_class
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def _profiled(torch, fn, split_class):
    """Run ``fn()`` under torch.profiler; (its result, wall ms, device ms
    per kernel class, the split-KV routine's under ``split_class``, and
    device ms and launches of each ``ssd`` kernel by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {cls: 0.0 for cls, _ in _CLASSES}
    by_class["other"] = 0.0
    ssd_kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        cls = _kernel_class(e.key, split_class)
        by_class[cls] += float(us) / 1e3
        if cls == "ssd":
            m = re.search(r"ssd_kernel\w*(<[^>]*>)?", e.key)
            ssd_kernels[m.group(0) if m else e.key] = (float(us) / 1e3, e.count)
    return stats, wall_ms, by_class, ssd_kernels


def profile_phase(torch, engine, reqs):
    """Where the time goes: the first SLOTS serve requests run twice under
    torch.profiler, once with one new token (prefill launches only) and once
    with 16 (the same prefill plus 15 decode steps); decode = the
    difference.  Host and profiler overhead count as device idle time."""
    from repro_torch.serve.engine import ServeRequest

    runs = {}
    for new in (1, 16):
        sub = [ServeRequest(r.request_id, r.prompt, new) for r in reqs[:SLOTS]]
        runs[new] = _profiled(torch, lambda: engine.serve_paged(
            sub, num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET), "paged_attention")
    (s1, w1, c1, _), (s16, w16, c16, _) = runs[1], runs[16]
    if sum(c16.values()) <= 0:
        print("   profiler saw no device time: breakdown not measured")
        return
    fmt = lambda d, n: ", ".join(f"{k} {v / n:.3f}" for k, v in d.items())
    busy1 = sum(c1.values())
    print(f"   prefill only: {s1.prefill_launches} launches, {s1.prefill_tokens} tokens; per "
          f"launch wall {w1 / s1.prefill_launches:.3f} ms, device busy "
          f"{busy1 / s1.prefill_launches:.3f} ms (idle {1 - busy1 / w1:.3f}); "
          f"device ms per launch: {fmt(c1, s1.prefill_launches)}")
    steps = s16.steps
    dec = {k: c16[k] - c1[k] for k in c16}
    busy = sum(dec.values())
    wall = w16 - w1
    print(f"   decode: {steps} steps of {SLOTS} slots; per step wall {wall / steps:.3f} ms, "
          f"device busy {busy / steps:.3f} ms (idle {1 - busy / wall:.3f}); "
          f"device ms per step: {fmt(dec, steps)}")
    # the same classes per launch: a check on phase 2's event timings
    L = engine.model.cfg.num_layers
    n1 = s1.prefill_launches
    print(f"   device ms per kernel launch: varlen_prefill {c1['varlen_prefill'] / (L * n1):.4f}, "
          f"rmsnorm at {BUDGET} rows {c1['rmsnorm'] / ((2 * L + 1) * n1):.4f}, "
          f"paged_attention {dec['paged_attention'] / (L * steps):.4f}, "
          f"rmsnorm at {SLOTS} rows {dec['rmsnorm'] / ((2 * L + 1) * steps):.4f}")


def dense_profile_phase(torch, engine, prompts):
    """Where the time goes on the dense path: ``generate`` on the first
    SLOTS prompts under torch.profiler with 0 and with 16 new tokens (one
    prefill pass, then 16 decode steps); a decode step is the difference
    over 16 steps.  Host and profiler overhead count as device idle time."""
    runs = {new: _profiled(torch, lambda n=new: engine.generate(prompts[:SLOTS], n),
                           "decode_attention")
            for new in (0, 16)}
    (_, pre_wall, prefill, ssd_kernels), (_, w16, c16, _) = runs[0], runs[16]
    if sum(c16.values()) <= 0:
        print("   profiler saw no device time: breakdown not measured")
        return
    fmt = lambda dct: ", ".join(f"{k} {v:.3f}" for k, v in dct.items())
    step = {k: (c16[k] - prefill[k]) / 16 for k in c16}
    step_wall = (w16 - pre_wall) / 16
    model = engine.model
    L = model.cfg.num_layers
    lens = [len(p) for p in prompts[:SLOTS]]
    print(f"   {model.cfg.name}: dense prefill pass ({SLOTS} prompts of {min(lens)}-{max(lens)} tokens, padded to "
          f"{engine._pad_prompts(prompts[:SLOTS])[0].shape[1]}): wall {pre_wall:.3f} ms, device "
          f"busy {sum(prefill.values()):.3f} ms (idle {1 - sum(prefill.values()) / pre_wall:.3f}); "
          f"device ms: {fmt(prefill)}")
    print(f"   {model.cfg.name}: dense decode step ({SLOTS} rows): wall {step_wall:.3f} ms, device busy "
          f"{sum(step.values()):.3f} ms (idle {1 - sum(step.values()) / step_wall:.3f}); "
          f"device ms: {fmt(step)}")
    per_launch = ([("ssd", prefill["ssd"] / L)] if model.ssm else
                  [("flash_attention", prefill["flash_attention"] / L),
                   ("decode_attention", step["decode_attention"] / L)])
    per_launch += [("rmsnorm per pass", prefill["rmsnorm"] / (2 * L + 1)),
                   ("rmsnorm per step", step["rmsnorm"] / (2 * L + 1))]
    print("   device ms per kernel launch: " + ", ".join(f"{k} {v:.4f}" for k, v in per_launch))
    if model.ssm:
        # the tensor-core ssd is three CUDA launches a call (one ``launches`` count)
        print(f"   {model.cfg.name}: ssd kernels in the prefill pass ({L} calls): " + ", ".join(
            f"{k} {ms:.3f} ms over {cnt} launches" for k, (ms, cnt) in sorted(ssd_kernels.items())))
        if not any("ssd_kernel_chunk_" in k for k in ssd_kernels):
            raise SystemExit(f"ssd: no ssd_kernel_chunk_* launch in the profiled pass "
                             f"({sorted(ssd_kernels)})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run from a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    # the float32 matmuls of the check phase stay full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = _phase("1. environment and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit not readable"
    print(card)
    print(f"   python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.kernels import ssd as sd
    from repro_torch.kernels import varlen_prefill as vp

    info = _build.build_info()
    print(f"   kernels: {info.path} ({'built' if info.built else 'cached'} "
          f"in {info.seconds:.1f} s by nvcc, one process per source)")
    build_report(info, _build._nvcc())
    _done(torch, "1. environment and build", t0)

    t0 = _phase("2. kernels vs plain versions (glm4-9b and mamba2-130m widths, bf16; "
                "bf16/int8/fp8 pools)")
    records = kernels_phase(torch, dev)
    records.update(dense_kernels_phase(torch, dev))
    records.update(ssd_kernels_phase(torch, dev))
    _done(torch, "2. kernels", t0)

    t0 = _phase("3. check: reduced glm4-9b and mamba2-130m, card vs CPU reference")
    check_phase(torch, dev)
    dense_check_phase(torch, dev)
    dense_check_phase(torch, dev, "mamba2-130m")
    _done(torch, "3. check", t0)

    t0 = _phase("4. serve: glm4-9b and mamba2-130m, full width and depth, random bf16 weights")
    counters = {"rmsnorm": rn, "paged_attention": pa, "spec_verify": sv, "varlen_prefill": vp,
                "flash_attention": fa, "decode_attention": da, "ssd": sd}
    model, params = full_model(torch, dev)
    launches, engine, reqs = serve_phase(torch, dev, counters, model, params)
    print("   -- the dense engines (static generate behind the scheduler; serve_continuous)")
    dense_launches, dense_engine, prompts = dense_serve_phase(torch, dev, counters, model, params)
    for name in ("flash_attention", "decode_attention"):
        launches[name] = dense_launches[name]
    print("   -- mamba2-130m (SSM) through the same two engines")
    ssm_model, ssm_params = full_model(torch, dev, "mamba2-130m")
    ssm_launches, ssm_engine, ssm_prompts = dense_serve_phase(torch, dev, counters, ssm_model,
                                                              ssm_params)
    launches["ssd"] = ssm_launches["ssd"]
    _done(torch, "4. serve", t0)

    t0 = _phase("5. where the time goes (torch.profiler, device time by kernel class)")
    profile_phase(torch, engine, reqs)
    dense_profile_phase(torch, dense_engine, prompts)
    dense_profile_phase(torch, ssm_engine, ssm_prompts)
    _done(torch, "5. profile", t0)

    sources = {
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:26"),
        # the bf16 decode family (every record here is bf16) runs the split-KV
        # routine; float32 keeps csrc/{paged_attention,spec_verify,decode_attention}.cu
        "paged_attention": ("src/repro_torch/kernels/csrc/decode_split.cuh",
                            "src/repro/kernels/paged_attention.py:105"),
        "spec_verify": ("src/repro_torch/kernels/csrc/decode_split.cuh",
                        "src/repro/kernels/spec_verify.py:130"),
        # bf16 (every record here) runs the tensor-core routine; float32 and
        # other head dims keep csrc/varlen_prefill.cu
        "varlen_prefill": ("src/repro_torch/kernels/csrc/varlen_prefill_tc.cuh",
                           "src/repro/kernels/varlen_prefill.py:156"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:101"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_split.cuh",
                             "src/repro/kernels/decode_attention.py:82"),
        # bf16 (the record here) runs the tensor-core route; float32 and other
        # widths or chunks keep csrc/ssd.cu
        "ssd": ("src/repro_torch/kernels/csrc/ssd_tc.cu", "src/repro/kernels/ssd_scan.py:95"),
    }
    kernels = []
    for name, r in records.items():
        source, replaces = sources[name.split("[")[0]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
