"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled on its own by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
the minutes ``torch.utils.cpp_extension.load`` spends on PyTorch's headers).
All sources compile in parallel, one ``nvcc`` process each, on the first
call of :func:`library`. Libraries land in ``{package}/_build/`` under a name
that carries a hash of the source, the shared header and the flags, so an
edited source is rebuilt and a stale library is never loaded. Installs are a
pid-unique temp file plus an atomic ``os.replace`` (the same scheme as the
JAX package's native IO loader), so concurrent builds never tear a file.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a keeps wgmma/setmaxnreg available to later kernels; no fast-math, so
# expf/division stay IEEE-exact (the sigmoid-mask bit-identity contract)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then the
    toolkit's default prefix. Raises when there is none."""
    candidates: List[str] = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built from csrc/ at first use and need the "
        "CUDA toolkit"
    )


def sources() -> Dict[str, str]:
    """``{name: path}`` of every kernel source, name = file stem."""
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    }


def _digest(src: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(sources()[name])}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc`` processes
    started together; returns ``{name: library path}``. Raises with the
    compiler's output when any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {name: library_path(name) for name in sources()}
    pending = {}
    nvcc = None
    for name, target in targets.items():
        if os.path.exists(target):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, sources()[name]]
        pending[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
            tmp,
            target,
        )
    failures = []
    for name, (proc, tmp, target) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc rc={proc.returncode}\n{out.decode()}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, building every kernel on
    the first call."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is not None:
            return lib
        paths = build_all()
        if name not in paths:
            raise KeyError(f"no kernel source csrc/{name}.cu")
        for n, path in paths.items():
            if n not in _libs:
                loaded = ctypes.CDLL(path)
                loaded.tfdl_error_string.restype = ctypes.c_char_p
                loaded.tfdl_error_string.argtypes = [ctypes.c_int]
                _libs[n] = loaded
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.tfdl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")
