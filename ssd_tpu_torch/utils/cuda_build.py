"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each kernel source under ``ssd_tpu_torch/csrc/`` exposes a plain C entry
point that returns ``cudaError_t``; no PyTorch header is included, so a
build takes seconds. The shared library lands in ``ssd_tpu_torch/_build/``
under a name keyed by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is built when a
module is imported: :meth:`CudaLibrary.load` runs at the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is required")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


class CudaLibrary:
    """One ``csrc`` source compiled into one shared library, loaded once.

    ``functions`` maps each exported C symbol to ``(argtypes, restype)``.
    After :meth:`load`, ``build_seconds`` holds the time this process spent
    compiling (0.0 when the cached library was reused) and ``build_log``
    holds nvcc's output, ptxas's register and shared-memory report included.
    """

    def __init__(self, name: str, source: str, functions: Dict[str, tuple]):
        self.name = name
        self.source = CSRC_DIR / source
        self.functions = functions
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self.library_path()
                if not path.exists():
                    self._compile(path)
                lib = ctypes.CDLL(str(path))
                for fn, (argtypes, restype) in self.functions.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = restype
                self._lib = lib
            return self._lib

    def _compile(self, path: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd: Sequence[str] = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (exit {proc.returncode}):\n"
                f"{self.build_log}"
            )
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial .so
