"""Build the port's native sources and load them with ctypes: CUDA sources
(`.cu`) with nvcc, host C++ sources (`.cpp`) with the host compiler; and
launch the hand-written kernels through their C entry points (`launch`).

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
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

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


def _digest(files: list[Path], flags: tuple) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_libraries(specs) -> list[Path]:
    """Compile each library of `specs`, (name, sources, headers) with the
    files in csrc/, unless an identical build exists: one compiler process
    a library, all started together. Returns their paths in order.
    `headers`, included by the sources, are hashed with them, so an edited
    header is rebuilt too."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, jobs = [], []
    for name, sources, headers in specs:
        sources = [CSRC / s for s in sources]
        compiler, flags = _compiler(sources)
        digest = _digest([*sources, *(CSRC / h for h in headers)], flags)
        target = BUILD_DIR / f"lib{name}-{digest}.so"
        paths.append(target)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [*compiler, *flags, "-o", tmp, *map(str, sources)]
        log = tempfile.TemporaryFile("w+")
        jobs.append((cmd, tmp, target, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, tmp, target, log, proc in jobs:
        if proc.wait() == 0:
            os.replace(tmp, target)
        else:
            log.seek(0)
            failed.append(f"{Path(cmd[0]).name} failed ({proc.returncode}):"
                          f"\n{' '.join(cmd)}\n{log.read()}")
        log.close()
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name: str, sources: list[str],
                 headers: list[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library `name` from files in csrc/."""
    with _lock:
        lib = LOADED.get(name)
        if lib is None:
            path, = build_libraries([(name, sources, headers)])
            lib = LOADED[name] = ctypes.CDLL(str(path))
        return lib


class EntryPoint(NamedTuple):
    """A kernel's C entry point: the `library` it is in, as `load_library`
    takes it (name, sources, headers), its `name`, and the ctypes types of
    its arguments but the last, which is the CUDA stream. It returns a CUDA
    error code, 0 on success."""
    library: tuple
    name: str
    argtypes: tuple


# entry point's name -> its launches, counted by `launch`; read by tests
LAUNCHES: Counter = Counter()
_functions: dict = {}


def _function(entry: EntryPoint):
    """`entry`'s ctypes function: its library built and loaded, and its
    argument and return types set, at the first call."""
    fn = _functions.get(entry.name)
    if fn is None:
        fn = getattr(load_library(*entry.library), entry.name)
        fn.argtypes = [*entry.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _functions[entry.name] = fn
    return fn


def launch(entry: EntryPoint, device, *args) -> None:
    """Call `entry` with `args` and the current stream of the CUDA
    `device`, under the device's guard and inside an op-scoped profiler
    range named after the entry point: the profiler links a launch made
    outside every torch op only to such a range, not to a user range such
    as `record_function`. Raises RuntimeError on a nonzero return, and
    counts the launch in LAUNCHES."""
    fn = _function(entry)
    with torch.cuda.device(device), \
            torch._C._profiler._RecordFunctionFast(entry.name):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry.name} kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[entry.name] += 1
