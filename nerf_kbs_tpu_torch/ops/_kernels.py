"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` source is compiled at first use by ``nvcc`` into a shared
library with a plain C interface under ``build/`` at the repository root
(listed in ``.gitignore``) and loaded with ctypes. The library's file name
carries a hash of its sources and flags, so an edited source is rebuilt and
a stale library is never loaded. Nothing here runs at import time: the CPU
tests import this module on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("fourier_mlp_fwd", "fourier_field_fwd", "fourier_mlp_bwd", "fourier_field_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "fourier_mlp_fwd": (
        "nkt_fourier_mlp_fwd",
        [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P],
    ),
    "fourier_field_fwd": (
        "nkt_fourier_field_fwd",
        [_P, _P, _I, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P],
    ),
    "fourier_mlp_bwd": (
        "nkt_fourier_mlp_bwd",
        [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _L,
         _P],
    ),
    "fourier_field_bwd": (
        "nkt_fourier_field_bwd",
        [_P, _P, _I, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P,
         _I, _I, _P, _P, _I, _P, _I, _P, _L, _P],
    ),
    # a test bench for the wgmma wrappers, built only when a test asks for it
    "wgmma_probe": (
        "nkt_wgmma_probe",
        [_P, _I, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    ),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source whose library is missing, one nvcc process
    per source, all started together. Returns the library paths; raises with
    nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        if name not in _libs:
            path = build((name,))[name]
            dll = ctypes.CDLL(str(path))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(dll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            dll.nkt_error_string.argtypes = [ctypes.c_int]
            dll.nkt_error_string.restype = ctypes.c_char_p
            _libs[name] = dll
        return _libs[name]


def call(name: str, *args) -> None:
    """Launch through the C entry point of ``name``; raises on a non-zero
    return (argument error or cudaGetLastError after the launch)."""
    dll = lib(name)
    fn_name, _ = _SIGNATURES[name]
    code = getattr(dll, fn_name)(*args)
    if code != 0:
        msg = dll.nkt_error_string(code).decode()
        raise RuntimeError(f"{name} kernel failed (code {code}): {msg}")


def int_array(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * len(values))(*values)
