"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each kernel source under ``ssd_tpu_torch/csrc/`` exposes plain C entry
points that return ``cudaError_t`` and a function naming such an error; no
PyTorch header is included, so a build takes seconds. The shared library
lands in ``ssd_tpu_torch/_build/`` under a name keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built when a module is imported: :meth:`CudaLibrary.load`
runs at the first launch.

:class:`CudaKernel` is what every kernel wrapper shares: the launch on the
current stream, the error check after it and the count of launches;
:func:`check_cuda_tensor` the checks a wrapper makes before it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

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

    ``functions`` maps each exported C symbol to ``(argtypes, restype)``;
    ``error_string`` names the exported ``const char* (int)`` that turns a
    ``cudaError_t`` into its message. After :meth:`load`, ``build_seconds``
    holds the time this process spent compiling (0.0 when the cached library
    was reused) and ``build_log`` holds nvcc's output, ptxas's register and
    shared-memory report included.
    """

    def __init__(self, name: str, source: str, functions: Dict[str, tuple], error_string: str):
        self.name = name
        self.source = CSRC_DIR / source
        self.functions = {**functions, error_string: ([ctypes.c_int], ctypes.c_char_p)}
        self.error_string = error_string
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


class CudaKernel:
    """A kernel wrapper's launch: ``fn(*args, stream)`` from ``library`` on
    the current stream of ``device``, a ``RuntimeError`` when it returns a
    CUDA error (a refused launch never runs, and no later synchronize would
    report it), and ``launches``, a plain integer incremented once per
    successful launch call and nowhere else, so a run can show that the
    main path reached the kernel.
    """

    def __init__(self, library: CudaLibrary) -> None:
        self.library = library
        self.launches = 0

    def launch(self, fn: str, device: torch.device, *args) -> None:
        lib = self.library.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        if err != 0:
            message = getattr(lib, self.library.error_string)(err).decode()
            raise RuntimeError(f"{fn} failed: {message}")
        self.launches += 1


def check_cuda_tensor(
    name: str,
    t: torch.Tensor,
    shape: tuple,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
    contiguous: bool = True,
) -> None:
    """Raise unless ``t`` is a CUDA tensor (on ``device``, when given) of
    ``shape`` and ``dtype`` (and contiguous, when asked)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
