"""Build, load and count the port's hand-written CUDA kernels.

Each kernel library is one source under `csrc/` compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, loaded with
ctypes. Nothing here runs at import time: the first launch on a CUDA
tensor builds the library it needs (seconds per source), and `build()`
compiles several at once, one `nvcc` process per source. Libraries are
cached in `build/kernels/` at the root of the checkout under a name that
hashes the source, the shared headers and the compiler flags, so an edited
source rebuilds and an unchanged one loads as it is.

`launches` counts kernel launches by name. A wrapper adds one exactly where
it launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels (`reset_launches()` before, read after).

Each library compiled (`kernel_build`) and each first load into the process
(`kernel_load`) reports to the program-event sentinel
(analysis/compilewatch.py, inert unless enabled).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from ..analysis import compilewatch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Element type codes shared with csrc/common.cuh (ktwe::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# library -> {exported launcher: argtypes}; every pointer is c_void_p so a
# 64-bit address is never cut to a C int.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "rms": {"ktwe_rms_norm_fwd": [_P, _P, _P, _LL, _I, _F, _I, _I, _I, _P],
            "ktwe_rms_norm_bwd": [_P, _P, _P, _P, _P, _P, _LL, _I, _F, _I, _I,
                                  _I, _I, _P]},
    "rope": {"ktwe_rope_fwd": [_P] * 4 + [_LL, _I, _I, _I] + [_LL] * 4
             + [_I, _I, _I, _P],
             "ktwe_rope_t": [_P] * 4 + [_LL, _I, _I, _I] + [_LL] * 4
             + [_I, _I, _I, _P]},
    "flash_attention": {"ktwe_flash_attention_fwd": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _F, _I,
        _I, _P], "ktwe_flash_attention_smem": [_I, _I]},
    "flash_attention_bwd": {
        "ktwe_flash_bwd_dq": [_P] * 9 + [_I] * 6 + [_LL, _LL, _F, _I, _I, _P],
        "ktwe_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_LL, _LL, _F, _I, _I,
                                                     _P],
        "ktwe_flash_bwd_dkv_stash": [_P] * 6 + [_I] * 6 + [_LL, _LL, _I, _I,
                                                           _P],
        "ktwe_flash_bwd_dq_flagged": [_P] * 9 + [_I] * 6 + [_LL, _LL, _F, _I,
                                                          _I, _P, _P],
        "ktwe_flash_bwd_wgmma": [_I, _I, _I],
        "ktwe_flash_bwd_dmax": [_I, _I, _I],
        "ktwe_flash_bwd_smem": [_I, _I, _I]},
    "fused_ce": {"ktwe_fused_ce_fwd": [_P] * 7 + [_I] * 6 + [_P],
                 "ktwe_fused_ce_bwd": [_P] * 7 + [_I] * 5 + [_P],
                 "ktwe_fused_ce_splits": [_I, _I, _I],
                 "ktwe_fused_ce_wgmma": [_I],
                 "ktwe_fused_ce_tile": [_I, _I, _I]},
    "paged_decode": {"ktwe_paged_decode_fwd": [_P] * 8 + [_I] * 8
                     + [_F, _I, _I, _P],
                     "ktwe_paged_decode_split": [_P] * 7 + [_I] * 8
                     + [_F, _I, _I, _P],
                     "ktwe_paged_decode_combine": [_P] * 3 + [_I] * 5 + [_P],
                     "ktwe_paged_decode_split_len": [_I] * 4 + [_LL, _I]},
    "embed": {"ktwe_embed_gather": [_P, _P, _P] + [_LL] * 5
              + [_I, _F] + [_I] * 5 + [_P]},
    "relayout": {"ktwe_relayout": [_P, _P, _LL, _LL, _LL] + [_I] * 4
                 + [_P]},
}

launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on first use")
    return path


def library_path(name: str) -> Path:
    """Where `name`'s compiled library lives for the current sources."""
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's report (ptxas registers, shared memory, spills) of
    the library built for the current sources; empty if not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every library in `names` that is not built yet, one `nvcc`
    process per source, all started together. Returns seconds per library
    compiled (0.0 for one already built). Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        if name not in SIGNATURES:
            raise KeyError(f"unknown kernel library {name!r}")
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        compilewatch.record("kernel_build", name, seconds[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.ktwe_error_string.argtypes = [ctypes.c_int]
            lib.ktwe_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            compilewatch.record("kernel_load", name,
                                time.perf_counter() - t0)
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launcher reported a refused launch or a bad argument."""
    if code != 0:
        msg = lib.ktwe_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed ({code}): {msg}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, dtypes=tuple(DTYPE_CODES)) -> None:
    """Checks shared by every wrapper before it hands `t` to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} dtype {t.dtype} not taken by the kernel "
                        f"(takes {', '.join(map(str, dtypes))})")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")
