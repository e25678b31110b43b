"""Build the CUDA sources in ``repro_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` exposes a plain C launch function and compiles on
its own into a shared library (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``. Builds happen at first use, never at
import, into ``build/repro_torch/`` at the checkout's root, keyed by a hash
of the source, the ``csrc`` headers it includes and the flags; the nvcc
processes for every missing library are started together. A missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
#: library name -> (launch symbol, argtypes). Pointers and the stream are
#: c_void_p, so ctypes never cuts a 64-bit address to a 32-bit int. A
#: float kernel takes a dtype code (``DTYPE_CODES``) and dispatches to a
#: template on it.
SIGNATURES: Dict[str, Tuple[str, List[type]]] = {
    # (a, b, out, B, Da, Db, sentinel, device, stream)
    "sorted_intersect": ("sorted_intersect_launch",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # (ids, cand, adj, out, B, Dc, D, sentinel, device, stream)
    "gather_intersect": ("gather_intersect_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # (x, gamma, out, R, d, eps, dtype, body, vec, warps, rows_per_block,
    #  grid, device, stream): the launch plan of kernels/rmsnorm.py
    "rmsnorm": ("rmsnorm_launch", [_P, _P, _P, _I, _I, _F, _I, _I, _I, _I,
                                   _I, _I, _I, _P]),
    # (q, k, v, out, lse, B, Hq, Hkv, Tq, Tk, dqk, dv, strides, causal,
    #  scale, dtype, device, stream); strides: 12 int64, (batch, head, row)
    #  of q, k, v, out; lse: [B, Hq, Tq] f32 or null
    "flash_attention": ("flash_attention_launch",
                        [_P] * 5 + [_I] * 7 + [_LL, _I, _F, _I, _I, _P]),
    # (q, k, v, out, dout, lse, D, dq, dk, dv, B, Hq, Hkv, Tq, Tk, dqk,
    #  dv, strides, causal, scale, dtype, device, stream); strides: 24
    #  int64, (batch, head, row) of q, k, v, out, dout, dq, dk, dv; D: a
    #  scratch of 2 * B * Hq * ceil(Tq / 64) * 64 f32
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_P] * 10 + [_I] * 7 + [_LL, _I, _F, _I, _I,
                                                    _P]),
    # (x, gamma, g, dx, dgamma, partial, R, d, eps, chunks, body, warps,
    #  dtype, device, stream); partial: [chunks, d] f32 scratch; body and
    #  warps from the forward's plan
    "rmsnorm_bwd": ("rmsnorm_bwd_launch",
                    [_P] * 6 + [_I, _I, _F, _I, _I, _I, _I, _I, _P]),
}

#: dtype code passed to a float kernel (``csrc/*.cu`` switch on it)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype) -> int:
    """The ``DTYPE_CODES`` entry of a torch dtype; raises on any other."""
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise ValueError(f"the CUDA kernels take {sorted(DTYPE_CODES)}, "
                         f"not {dtype}")
    return DTYPE_CODES[name]


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (the ptxas register / shared-memory report) per library
#: built by this process
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA kernels "
                       "of repro_torch cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes (quoted
    ``#include``, followed through the headers), in a fixed order."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / m.decode() for m in _INCLUDE.findall(
            path.read_bytes()) if (CSRC / m.decode()).is_file()]
    return out


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: keyed by the
    bytes of the source, of the headers it includes and of the flags."""
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    per source, all started together. Returns seconds per built library."""
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        seconds: Dict[str, float] = {}
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            seconds[n] = time.perf_counter() - t0
            build_log[n] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{n}.cu "
                              f"(rc {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("\n".join(failed))
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
