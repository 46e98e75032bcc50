"""Build the host sampler library (``ray_sampler.cpp``) with g++.

The library goes to ``build/`` at the repository root (listed in
``.gitignore``), named after a hash of the source, the flags and what
``-march=native`` means on this host, so an edited source is rebuilt and a
library built for another CPU is never loaded. A failed build raises with
the compiler's output: nothing falls back. Run by hand with

    python -m nerf_kbs_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "ray_sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the native sampler: {cmd[0]} not found") from e


def target() -> Path:
    """The library's path for this source, these flags and this host's
    ``-march=native``."""
    native = _run([CXX, "-march=native", "-Q", "--help=target"])
    if native.returncode != 0:
        raise RuntimeError(f"{CXX} -march=native -Q --help=target failed:\n{native.stderr}")
    h = hashlib.sha256(" ".join((CXX,) + FLAGS).encode())
    h.update(native.stdout.encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libnkt_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library, compiled first when missing. Raises RuntimeError with
    the compiler's output when the build fails."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = _run([CXX, *FLAGS, str(SRC), "-o", str(tmp)])
    if proc.returncode != 0:
        raise RuntimeError(f"building the native sampler failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built: {build()}")
