"""Build a CUDA source into a shared library at first use; load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles one ``.cu`` file with a plain C interface (no PyTorch headers, so a
build takes seconds) into ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the source and the flags.  Each library
builds under its own lock and writes to a temporary name before an atomic
rename: replica factories run in worker threads, so two replicas can reach
the first build at once, while different libraries may build at the same
time (one ``nvcc`` each).  A build failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_locks_lock = threading.Lock()
_locks: dict = {}  # library name -> its build lock
_libs: dict = {}
build_log: dict = {}  # library name -> {"seconds", "ptxas", "path"}


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``,
    ``cu++filt``): on ``PATH`` or under ``$CUDA_HOME/bin``."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def load_library(name: str, source: Path, defines=()) -> ctypes.CDLL:
    """Return the loaded library for ``source``, compiling it if needed;
    ``defines`` are ``NAME=VALUE`` macros passed to ``nvcc`` as ``-D``
    (one source may build several libraries, each under its own name)."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        text = source.read_bytes()
        flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        digest = hashlib.sha256(text + " ".join(flags).encode()
                                ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"{name}-{digest}.so"
        t0 = time.perf_counter()
        ptxas = ""
        if not target.exists():
            tmp = BUILD_DIR / f".{name}-{digest}.{os.getpid()}.tmp.so"
            proc = subprocess.run(
                [cuda_tool(), *flags, "-o", str(tmp), str(source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed to build {source.name}:\n{proc.stderr}")
            ptxas = proc.stderr
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": ptxas, "path": str(target)}
        _libs[name] = lib
        return lib
