"""Build and load the package's CUDA kernels.

Each source under `csrc/` is compiled with nvcc for sm_90a into a shared
library with a plain C interface and loaded with ctypes. The build runs at
first use, into `build/kernels/` beside the package (listed in .gitignore),
and the library name carries a hash of the source, of every header it
includes with quotes (`csrc/*.cuh`, followed recursively) and of the nvcc
flags, so an edited source or header is rebuilt and a stale library is
never loaded. Nothing here runs at import time: the CPU tests import every
module on a host with no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                   "bin", "nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc")


def sources(src: Path) -> list[Path]:
    """`src` and every file it includes with quotes from beside itself
    (where nvcc looks first), recursively, each once, in a fixed order.
    A quoted include found nowhere beside it is a system header."""
    found: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            near = [path.parent / inc
                    for inc in _INCLUDE.findall(path.read_text())]
            todo += [p for p in reversed(near) if p.is_file()]
    return found


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu, as its sources and the flags
    stand now, is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(CSRC / f"{name}.cu"):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of these exact sources
    exists. Returns the library path; records the compile time in
    build_seconds."""
    src = CSRC / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a loader never sees a partial file
    build_seconds[name] = time.perf_counter() - t0
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
