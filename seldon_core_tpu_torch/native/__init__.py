"""The port's ctypes binding of the C++ data-plane library in ``native/``.

``libseldon_tpu_native.so`` holds the native ingress (``frontserver.cc``,
``h2grpc.cc``), the SRT1 table and codec loops (``codec.cc``) and the C++ load
clients (``loadgen.cc``).  The port builds its own copy at first use from
the repo's ``native/`` sources, with ``native/Makefile``'s flags:

    g++ -O3 -fPIC -Wall -std=c++17 -march=native -pthread -shared \\
        -o seldon_core_tpu_torch/native/_build/libseldon_tpu_native-<hash>.so \\
        native/codec.cc native/frontserver.cc native/h2grpc.cc native/loadgen.cc

The name carries a hash of the sources, the flags and the host CPU's
features, so neither a changed source nor a build copied from another
machine is loaded, and a file lock lets concurrent processes share one
build.  Nothing is written into ``native/``.
``SELDON_TPU_NATIVE_SO`` names a prebuilt library to load instead.

The native ingress and the C++ load clients use the library, and the
KV containers' CRC32C trailer (``codec/bufview.crc32c``) takes its
``srt1_crc32c`` when it loads; the rest of the codec and the batcher
stay on stdlib ``base64`` and numpy.  Nothing builds it until one of
them asks, and a failed build is logged and makes ``get_lib()`` return
None (``available()`` is then False), so the ingress raises and the
CRC runs its table loop, while every other lane serves as before.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

SOURCE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the library's inputs: native/Makefile's SRCS and the header they share
SOURCES = ("codec.cc", "frontserver.cc", "h2grpc.cc", "loadgen.cc")
HEADERS = ("h2grpc.h",)
CXXFLAGS = ["-O3", "-fPIC", "-Wall", "-std=c++17", "-march=native", "-pthread", "-shared"]
ABI_VERSION = 4  # native_abi_version() of the sources this binding speaks

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native library failed to compile or load."""


def _cpu_flags() -> str:
    """The host CPU's feature flags: ``-march=native`` builds for them, so
    a build copied to another machine must not be taken for its own."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine()


def build_key() -> str:
    """Hash of the sources, the header, the compiler flags and the CPU."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SOURCE_DIR / name).read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_cpu_flags().encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libseldon_tpu_native-{build_key()}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists;
    returns its path.  Raises :class:`NativeBuildError`."""
    missing = [n for n in SOURCES + HEADERS if not (SOURCE_DIR / n).is_file()]
    if missing:
        raise NativeBuildError(f"native sources missing under {SOURCE_DIR}: {missing}")
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise NativeBuildError("no C++ compiler (g++) on PATH to build the native library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process finished it meanwhile
                return lib
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXXFLAGS, "-o", str(tmp), *(str(SOURCE_DIR / n) for n in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(
                    f"native build failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Check the ABI version and declare the SRT1 framing and CRC32C
    symbols (the front server and load clients declare their own)."""
    lib.native_abi_version.restype = ctypes.c_int32
    version = lib.native_abi_version()
    if version != ABI_VERSION:  # not assert: must survive python -O
        raise NativeBuildError(f"native library ABI {version}, this binding speaks {ABI_VERSION}")
    lib.srt1_item_size.restype = ctypes.c_int64
    lib.srt1_item_size.argtypes = [ctypes.c_int32]
    lib.srt1_header_bytes.restype = ctypes.c_int64
    lib.srt1_header_bytes.argtypes = [ctypes.c_int32]
    lib.srt1_magic.restype = ctypes.c_uint32
    lib.srt1_payload_bytes.restype = ctypes.c_int64
    lib.srt1_payload_bytes.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.srt1_crc_magic.restype = ctypes.c_uint32
    lib.srt1_crc32c.restype = ctypes.c_uint32
    # c_char_p: bytes pass by pointer, no staging copy of a multi-MB container
    lib.srt1_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
    return lib


def load() -> ctypes.CDLL:
    """Build (unless ``SELDON_TPU_NATIVE_SO`` names a library) and load
    the library.  Raises :class:`NativeBuildError`."""
    from seldon_core_tpu_torch.runtime import knobs

    path = knobs.raw("SELDON_TPU_NATIVE_SO") or str(build())
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeBuildError(f"cannot load {path}: {e}") from e
    _bind(lib)
    logger.info("native data-plane library loaded from %s", path)
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once per process; None (with the
    reason logged) when it cannot be."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = load()
            except (NativeBuildError, OSError, subprocess.SubprocessError) as e:
                # a read-only tree, a missing compiler named by CXX, a failed
                # build: the native ingress raises, nothing else needs it
                logger.warning("native library unavailable, the native ingress cannot start: %s", e)
        return _LIB


def available() -> bool:
    """True when the native library is loaded (the native ingress and the
    C++ load clients can run)."""
    return get_lib() is not None
