"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each kernel source under ``ssd_tpu_torch/csrc/`` exposes plain C entry
points that return ``cudaError_t`` and a function naming such an error; no
PyTorch header is included, so a build takes seconds. The shared library
lands in the build directory (:func:`build_dir`: ``--compile-cache`` /
``$SSD_COMPILE_CACHE``, else ``ssd_tpu_torch/_build/``) under a name keyed
by a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused, by every process and checkout that shares the
directory. Nothing is built when a module is imported:
:meth:`CudaLibrary.load` runs at the first launch.

:class:`CudaKernel` is what every kernel wrapper shares: the launch on the
current stream, the error check after it and the count of launches;
:func:`check_cuda_tensor` the checks a wrapper makes before it;
:func:`instance_for` the choice among a kernel's instances, one per dtype
(C entry points ``…_launch`` for fp32, ``…_bf16_launch`` for bf16).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"  # the default build directory
CACHE_ENV = "SSD_COMPILE_CACHE"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def build_dir() -> Path:
    """Where the kernels and the host library are built and looked for:
    ``$SSD_COMPILE_CACHE`` (``~`` expanded, made absolute) when set, else
    :data:`BUILD_DIR`. The one reader of the variable, called at each
    build, so :func:`enable_compile_cache` moves every later build."""
    env = os.environ.get(CACHE_ENV)
    return Path(env).expanduser().resolve() if env else BUILD_DIR


def make_build_dir(path: Path) -> None:
    """Create ``path`` for a build; an ``OSError`` when it cannot be written
    names the flag and the variable that move it."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=path):
            pass
    except OSError as e:
        raise OSError(f"the build directory {path} cannot be written ({e}); give "
                      f"--compile-cache DIR or set ${CACHE_ENV}") from e


def enable_compile_cache(cache_dir: "str | os.PathLike | None" = None) -> str:
    """The port's counterpart of the JAX package's ``enable_compile_cache``:
    point the build cache at ``cache_dir``, else ``$SSD_COMPILE_CACHE``, else
    ``ssd_tpu_torch/_build/``, so that restarts, other processes and other
    checkouts that share it reuse every kernel built there. Returns the
    active path.

    A cache that was asked for is created (``OSError`` when it cannot be
    written) and exported, absolute, as ``$SSD_COMPILE_CACHE``, so the
    processes this one starts (torchrun ranks, the orchestrator's children)
    build into it too; that lasts for the rest of the process, so only the
    CLIs' ``main`` call this with a path. The default is left alone: a
    read-only install whose kernels are built starts, and a build that
    finds it unwritable raises then. A library a process has loaded stays
    loaded.
    """
    path = Path(cache_dir).expanduser().resolve() if cache_dir else build_dir()
    if path != BUILD_DIR:
        make_build_dir(path)
        os.environ[CACHE_ENV] = str(path)
    return str(path)


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
        return build_dir() / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

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
        make_build_dir(path.parent)
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


# the C entry points' suffix for each dtype a kernel is instantiated for
DTYPE_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


class CudaKernel:
    """A kernel wrapper's launch: ``fn(*args, stream)`` from ``library`` on
    the current stream of ``device``, a ``RuntimeError`` when it returns a
    CUDA error (a refused launch never runs, and no later synchronize would
    report it), and ``launches``, a plain integer incremented once per
    successful launch call and nowhere else, so a run can show that the
    main path reached the kernel. ``dtype``: the element type of the
    instance the wrapper launches.
    """

    def __init__(self, library: CudaLibrary, dtype: torch.dtype = torch.float32) -> None:
        self.library = library
        self.dtype = dtype
        self.launches = 0

    def entry(self, base: str) -> str:
        """The C entry point of this instance: ``base`` + dtype suffix + ``_launch``."""
        return f"{base}{DTYPE_SUFFIX[self.dtype]}_launch"

    def launch(self, fn: str, device: torch.device, *args) -> None:
        lib = self.library.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        if err != 0:
            message = getattr(lib, self.library.error_string)(err).decode()
            raise RuntimeError(f"{fn} failed: {message}")
        self.launches += 1


def instance_for(kernels: Sequence[CudaKernel], name: str, t: torch.Tensor) -> CudaKernel:
    """The instance among ``kernels`` built for ``t``'s dtype; a CUDA tensor
    of another dtype raises (there is no fallback to another instance)."""
    by_dtype = {k.dtype: k for k in kernels}
    check_cuda_tensor(name, t, tuple(t.shape), tuple(by_dtype), contiguous=False)
    return by_dtype[t.dtype]


def check_cuda_tensor(
    name: str,
    t: torch.Tensor,
    shape: tuple,
    dtype: torch.dtype | tuple = torch.float32,
    device: Optional[torch.device] = None,
    contiguous: bool = True,
) -> None:
    """Raise unless ``t`` is a CUDA tensor (on ``device``, when given) of
    ``shape`` and ``dtype`` — or of one of the dtypes, when ``dtype`` is a
    tuple — (and contiguous, when asked)."""
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in allowed:
        want = allowed[0] if len(allowed) == 1 else " or ".join(map(str, allowed))
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
