"""The port's host library: its FLAC decoder and edit-distance program
(``ssd_tpu_torch/native/*.cpp``, its own copies of the JAX package's
``native/`` sources), built with ``g++`` and bound with ctypes.

Nothing is built when the module is imported: :func:`load` compiles the two
sources into one shared library in the build directory on first use
(``utils/cuda_build.py``'s :func:`build_dir`: ``--compile-cache`` /
``$SSD_COMPILE_CACHE``, else ``ssd_tpu_torch/_build/``), named by a hash of
the sources and the flags (an edited source is rebuilt, an unchanged one
reused, as for the CUDA sources), and loads it once a process. A build that fails raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ssd_tpu_torch.utils.cuda_build import PACKAGE_DIR, build_dir, make_build_dir

NATIVE_DIR = PACKAGE_DIR / "native"
SOURCES = ("flac_decoder.cpp", "edit_distance.cpp")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class FlacInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("total_samples", ctypes.c_uint64),
    ]


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return build_dir() / f"libssd_native-{digest.hexdigest()[:16]}.so"


def _compile(path: Path) -> None:
    make_build_dir(path.parent)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host library failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial .so


def load() -> ctypes.CDLL:
    """The host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            lib.flac_decode.restype = ctypes.c_longlong
            lib.flac_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_size_t,
                ctypes.POINTER(FlacInfo),
            ]
            lib.edit_distance_counts.restype = None
            lib.edit_distance_counts.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        return _lib
