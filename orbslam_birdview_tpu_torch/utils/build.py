"""Build the port's native sources and load them with ctypes: CUDA sources
(`.cu`) with nvcc, host C++ sources (`.cpp`) with the host compiler.

Each library is compiled at first use into `build/torch_kernels/` at the
root of the checkout (listed in .gitignore; $ORBSLAM_TORCH_BUILD_DIR names
another directory), under a name that carries a
hash of its sources and flags, so an edited source is rebuilt and an
unchanged one is reused. The sources have a plain C interface and include
no PyTorch header, which keeps a build to seconds. Nothing here runs when
a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = Path(os.environ.get("ORBSLAM_TORCH_BUILD_DIR")
                 or PACKAGE_DIR.parent / "build" / "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

# name -> loaded library; filled by load_library, read by tests
LOADED: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return nvcc


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else c++ or g++ on the PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(name) if name else None
        if path is not None:
            return path
    raise RuntimeError("no host C++ compiler (c++ / g++) found: the port's "
                       "C++ sources are built on first use and need one")


def _compiler(sources: list[Path]) -> tuple[list[str], tuple]:
    """The compiler command and flags for `sources`: nvcc when any of them
    is CUDA, the host C++ compiler otherwise."""
    if any(src.suffix == ".cu" for src in sources):
        return [find_nvcc()], NVCC_FLAGS
    return [find_cxx()], CXX_FLAGS


def _digest(sources: list[Path], flags: tuple) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library(name: str, sources: list[Path]) -> Path:
    """Compile `sources` into one shared library unless an identical build
    exists; returns its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler, flags = _compiler(sources)
    target = BUILD_DIR / f"lib{name}-{_digest(sources, flags)}.so"
    if target.exists():
        return target
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*compiler, *flags, "-o", tmp, *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler[0]).name} failed "
                               f"({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build (if needed) and load the library `name` from files in csrc/."""
    with _lock:
        lib = LOADED.get(name)
        if lib is None:
            path = build_library(name, [CSRC / s for s in sources])
            lib = LOADED[name] = ctypes.CDLL(str(path))
        return lib
