"""Build the port's CUDA kernels from the sources in ``ops/csrc``.

Each source is compiled at first use by ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o ops/_build/<name>-<hash>.so ops/csrc/<name>.cu

A source that includes no PyTorch header builds in seconds, where
``torch.utils.cpp_extension.load`` (which also needs ``ninja``) takes
minutes for one that does; the kernels therefore take raw pointers and
a stream, and the Python wrappers do the checking.

The library's name carries a hash of the source and the flags, so a
changed source never loads a stale build, and a file lock lets
concurrent processes (a server and a smoke test) share one build.  A
failed build raises :class:`KernelBuildError`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """A kernel source failed to compile or load."""


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put the CUDA toolkit's bin on PATH)"
    )


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def build_key(name: str) -> str:
    """Hash of the source text and the compiler flags."""
    h = hashlib.sha256()
    h.update(source_path(name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{build_key(name)}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out), str(source_path(name))]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source
    exists; returns the library's path."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process finished it meanwhile
                return lib
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = nvcc_command(name, tmp)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(
                    f"nvcc failed for {source_path(name)} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _LIBS[name] = lib
        return lib
