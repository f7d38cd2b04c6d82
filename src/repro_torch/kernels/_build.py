"""Build and load the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, from the checkout's own sources, into
``build/repro_torch_kernels/<hash>/`` at the checkout's root, keyed by a
hash of the sources and flags; a package that does not sit in a checkout
(``<root>/src/repro_torch`` beside ``<root>/pyproject.toml``) refuses to
build, so no build lands in a shared environment; each ``.cu`` file compiles in its own
``nvcc`` process, all started together.  Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.  A missing
``nvcc`` or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
PACKAGE = CSRC.parents[1]                  # <root>/src/repro_torch
CHECKOUT = PACKAGE.parents[1]              # <root>
SOURCES = ("rmsnorm.cu", "paged_attention.cu", "varlen_prefill.cu", "spec_verify.cu",
           "flash_attention.cu", "decode_attention.cu", "ssd.cu", "decode_split_bf16.cu",
           "decode_split_quant.cu", "varlen_prefill_bf16.cu", "varlen_prefill_quant.cu",
           "ssd_tc.cu", "flash_attention_bwd.cu", "rmsnorm_bwd.cu", "ssd_bwd.cu",
           "ssd_bwd_tc.cu")
HEADERS = ("common.cuh", "mma.cuh", "flash_tile.cuh", "decode_split.cuh", "varlen_prefill_tc.cuh",
           "ssd_tile.cuh")
BUILD_ROOT = CHECKOUT / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "librepro_torch_kernels.so"

# runtime dtype codes of csrc/common.cuh: the compute dtype (q, activations,
# outputs) and, apart from it, the storage of a paged K/V pool (KVStore):
# 0 = the compute dtype, else 1-byte codes with float32 scales
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_STORE_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
# shared memory one block may use on an H100 (csrc/common.cuh allow_smem)
SMEM_LIMIT = 227 * 1024

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# every C entry point, with its argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "rt_rmsnorm": (_P, _P, _P, _LL, _LL, _F, _I, _P),
    "rt_paged_attention_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _F, _F, _I, _P),
    "rt_varlen_prefill": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    # the varlen prefill tensor-core routine, over a bf16 pool and over int8/fp8 codes
    **{f"rt_varlen_prefill_{kind}": (_P,) * 13 + (_I,) * 13 + (_F, _F, _P)
       for kind in ("bf16", "quant")},
    "rt_spec_verify_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F, _F, _I, _I, _P),
    # q, k, v, out and lse (null: none), then the shape and options
    "rt_flash_attention_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _F, _P),
    "rt_flash_attention_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _F, _P),
    # q, k, v, o, dout, lse, the D scratch, dq, dk, dv; the shape, tile and options
    "rt_flash_attention_bwd": (_P,) * 10 + (_I,) * 11 + (_F, _F, _I, _P),
    # the bf16 tensor-core route: the same pointers (the statistics scratch in
    # D's place) and the split partials; the shape, splits, options and the
    # score error bound
    "rt_flash_attention_bwd_tc": (_P,) * 11 + (_I,) * 10 + (_F, _F, _F, _P),
    # x, w, dy, dx, dw, the dw partials; rows, D, eps, blocks, threads a row
    # (0: the scalar path), dtype
    "rt_rmsnorm_bwd": (_P,) * 6 + (_LL, _LL, _F, _I, _I, _I, _P),
    "rt_decode_attention_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                _F, _P),
    # the split-KV decode routine, over a bf16 pool and over int8/fp8 codes
    **{f"rt_decode_split_{kind}": (_P,) * 12 + (_I,) * 15 + (_F, _F, _P)
       for kind in ("bf16", "quant")},
    "rt_ssd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL,
               _LL, _LL, _I, _P),
    # the bf16 chunk-parallel scan on the tensor cores, with its two workspaces
    "rt_ssd_tc": (_P,) * 10 + (_I,) * 6 + (_LL,) * 6 + (_P,),
    # x, dt, A, B, C, s0, dy, d_final; dx, ddt, dA, dB, dC, d_initial; six
    # workspaces; the shape and chunk, the strides of x, B and C, dtype
    "rt_ssd_bwd": (_P,) * 20 + (_I,) * 6 + (_LL,) * 6 + (_I, _P),
    # the bf16 backward on the tensor cores: the same pointers (cum and states
    # the forward's where kept), whether they are kept, the shape and chunk,
    # the strides of x, B and C
    "rt_ssd_bwd_tc": (_P,) * 20 + (_I,) * 7 + (_LL,) * 6 + (_P,),
}


@dataclass(frozen=True)
class BuildInfo:
    """Where the library came from: path, whether this process compiled it,
    the wall seconds that took, and the compiler's register/spill report."""

    path: Path
    built: bool
    seconds: float
    log: str


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None
# held over the first load or build: a fleet's workers run in threads, and
# none may compile or load the library a second time
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """Compile every source in its own nvcc process, all at once, then link.
    Returns the compilers' combined output (the -Xptxas -v report)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log, failed = [], []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name}\n{text}")
            if proc.returncode:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        # atomic publish: a concurrent build never loads a half-written file
        os.replace(tmp_lib, out_dir / LIB_NAME)
    text = "\n".join(log)
    (out_dir / "build.log").write_text(text)
    return text


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once a process: the
    first caller loads or builds it under a lock, the others wait)."""
    if _lib is not None:
        return _lib
    with _LOCK:
        return _lib if _lib is not None else _load()


def _load() -> ctypes.CDLL:
    """Build the library if this checkout has none of these sources, load
    it and bind its entry points (the caller holds ``_LOCK``)."""
    global _lib, _info
    if PACKAGE.parent.name != "src" or not (CHECKOUT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"the kernels build into the checkout that holds their sources, and "
            f"{PACKAGE} is not <checkout>/src/repro_torch; run from a checkout "
            f"(PYTHONPATH=<checkout>/src)"
        )
    out_dir = BUILD_ROOT / source_hash()
    path = out_dir / LIB_NAME
    built, seconds, log = False, 0.0, ""
    if not path.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile(out_dir)
        seconds = time.perf_counter() - t0
        built = True
    elif (out_dir / "build.log").exists():
        log = (out_dir / "build.log").read_text()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib, _info = lib, BuildInfo(path, built, seconds, log)
    return lib


def build_info() -> BuildInfo:
    """How the library of this process was obtained (builds on first use)."""
    library()
    return _info


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {t.dtype} not supported by the CUDA kernel "
            f"(expected one of {list(DTYPE_CODES)})"
        )
    return DTYPE_CODES[t.dtype]


def require(cond: bool, msg: str) -> None:
    """Argument check of a kernel wrapper: raise on what the kernel does not take."""
    if not cond:
        raise ValueError(msg)


class SharedMemoryError(ValueError):
    """An attention tile that needs more shared memory than one block of
    the card has: the kernel cannot run it, and nothing falls back."""


def tile_floats(rows: int, page_size: int, d: int) -> int:
    """Floats of the common.cuh tile (``tile_floats`` there)."""
    return (rows * (d + 1) + page_size * (d + 1) + page_size * d
            + rows * page_size + 3 * rows + rows * d)


def check_tile(name: str, rows: int, page_size: int, d: int) -> None:
    """Raise :class:`SharedMemoryError` when the common.cuh tile of ``rows``
    query rows, ``page_size`` keys and head dim ``d`` (all float32)
    exceeds :data:`SMEM_LIMIT`."""
    floats = tile_floats(rows, page_size, d)
    if 4 * floats > SMEM_LIMIT:
        raise SharedMemoryError(
            f"{name}: a tile of {rows} query rows x {page_size} keys at head dim {d} "
            f"needs {4 * floats} bytes of shared memory, above the card's {SMEM_LIMIT}"
        )


def kv_store_code(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, k_scales: Optional[torch.Tensor],
                  v_scales: Optional[torch.Tensor]) -> int:
    """The KVStore code of a pool pairing the kernels take: pools of q's
    dtype with no scales (0), or int8/fp8 pools with float32 scales of the
    pool's shape less its last axis (1, 2).  Raises on anything else."""
    require(k_pages.dtype == v_pages.dtype, f"{name}: k and v pools differ in dtype")
    if k_pages.dtype == q.dtype:
        require(k_scales is None and v_scales is None,
                f"{name}: scales given for a full-precision {k_pages.dtype} pool")
        return 0
    if k_pages.dtype not in KV_STORE_CODES:
        raise TypeError(
            f"{name}: pool dtype {k_pages.dtype} with q {q.dtype} not supported by the "
            f"CUDA kernel (expected q's dtype or one of {list(KV_STORE_CODES)})"
        )
    require(k_scales is not None and v_scales is not None,
            f"{name}: an {k_pages.dtype} pool needs k_scales and v_scales")
    for s in (k_scales, v_scales):
        require(s.dtype == torch.float32 and tuple(s.shape) == tuple(k_pages.shape[:-1]),
                f"{name}: scales must be float32 {tuple(k_pages.shape[:-1])}")
        require(s.device == q.device and s.is_contiguous(),
                f"{name}: scales must be contiguous on {q.device}")
    return KV_STORE_CODES[k_pages.dtype]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()
