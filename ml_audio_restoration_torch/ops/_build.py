"""Build and load the package's native libraries.

Each CUDA source under `csrc/` is compiled with nvcc for sm_90a into a
shared library with a plain C interface and loaded with ctypes; the host
libraries of HOST_LIBRARIES (the audio codec) are compiled the same way
with g++. The build runs at first use, into `build/kernels/` beside the
package (listed in .gitignore), and the library name carries a hash of the
sources, of every header they include with quotes (followed recursively)
and of the compiler flags, so an edited source or header is rebuilt and a
stale library is never loaded. Nothing here runs at import time: the CPU
tests import every module on a host with no nvcc.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
#: nvcc flags of one library beyond NVCC_FLAGS: the int8 conv's epilogue,
#: the IIR scans' steps and the conv epilogue must round each operation on
#: their own, as their plain versions do
EXTRA_NVCC_FLAGS = {"int8_conv": ["-fmad=false"], "iir_scan": ["-fmad=false"],
                    "conv_epilogue": ["-fmad=false"]}
#: libraries built with g++ for the host: name -> translation units in csrc/
HOST_LIBRARIES = {"wavio": ("wavio.cpp", "flacio.cpp")}

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_loaded: dict[str, ctypes.CDLL] = {}
# one load (and build) at a time: a build's temp name is per process
_lock = threading.Lock()
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


def _units(name: str) -> list[Path]:
    """The translation units of library `name`: csrc/<name>.cu, or the
    sources HOST_LIBRARIES lists."""
    return [CSRC / u for u in HOST_LIBRARIES.get(name, (f"{name}.cu",))]


def _flags(name: str) -> list[str]:
    if name in HOST_LIBRARIES:
        return GXX_FLAGS
    return NVCC_FLAGS + EXTRA_NVCC_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    """Where library `name`, as its sources and the flags stand now, is
    built."""
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    hashed: list[Path] = []
    for unit in _units(name):
        hashed += [p for p in sources(unit) if p not in hashed]
    for path in hashed:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the audio codec is built with g++")
    return found


def build(name: str) -> Path:
    """Compile library `name` unless a library of these exact sources
    exists. Returns the library path; records the compile time in
    build_seconds. A failed compile raises with the compiler's output."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    compiler = _gxx() if name in HOST_LIBRARIES else _nvcc()
    cmd = [compiler, *_flags(name), "-o", str(tmp),
           *(str(u) for u in _units(name))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed for {name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a loader never sees a partial file
    build_seconds[name] = time.perf_counter() - t0
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library `name`; cached per process. The
    CDLL is local to its handle (RTLD_LOCAL), so libraries exporting the
    same symbols, like the JAX package's codec, do not interpose."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
