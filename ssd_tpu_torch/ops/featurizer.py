"""EMG log-mel featurizer (PyTorch port of ``ssd_tpu/ops/featurizer.py``).

Per channel: STFT (``center=False``, periodic Hann) → power spectrum →
Slaney mel filterbank → ``10·log10(max(x, 1e-10))`` → per-channel 80 dB
clip over the valid frames → ``(frames, channels, n_mels)`` → per-file
z-normalization with ``std + 1e-8``.

The frame → mel → log core (:func:`logmel_core`) is the custom op
``ssd_tpu_torch::logmel_core``, so that a captured graph (``torch.export``)
holds it as one node; PyTorch's dispatcher picks the implementation by the
device of its input: a CUDA tensor goes to the hand-written kernel in
``csrc/logmel.cu`` (the counterpart of the Pallas ``_fused_kernel``; a
shared-memory FFT with a banded mel projection, planned on the host by
:func:`fft_radices`, :func:`fft_twiddles` and :func:`mel_bands`), a CPU
tensor to the plain version :func:`logmel_core_plain`. There is no fall
back: a CUDA tensor reaches the kernel or raises. The clip and the z-norm
stay in plain torch around the core, where they sit outside the Pallas
kernel in JAX too.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ssd_tpu_torch.ops import mel as melmod
from ssd_tpu_torch.utils.cuda_build import CudaKernel, CudaLibrary

_DB_FLOOR = 1e-10
_TOP_DB = 80.0


@dataclass(frozen=True)
class FeaturizerConfig:
    """Mirrors the reference ``EMGConfig`` (``preprocessing.py:32-40``)."""

    sample_rate: int = 1000
    n_fft: int = 320
    hop_length: int = 10
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None
    normalize: str = "per_file"  # per_file | none

    @property
    def n_bins(self) -> int:
        return 1 + self.n_fft // 2

    def frame_count(self, n_samples: int) -> int:
        return melmod.num_frames(n_samples, self.n_fft, self.hop_length)

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "FeaturizerConfig":
        """The run config's ``features.emg`` block, the keys (and defaults)
        the JAX trainer and eval CLI read for ``data.train_from_raw``."""
        femg = cfg.get("features", {}).get("emg", {}) or {}
        return cls(
            sample_rate=int(femg.get("sample_rate", 1000)),
            n_fft=int(femg.get("n_fft", 320)),
            hop_length=int(femg.get("hop_length", 10)),
            n_mels=int(femg.get("n_mels", 80)),
            normalize=femg.get("normalize", "per_file"),
        )


# --------------------------------------------------------------------------
# Batched featurization
# --------------------------------------------------------------------------


def logmel_batch(
    emg: torch.Tensor, sample_lengths: torch.Tensor, cfg: FeaturizerConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched featurization of padded raw EMG.

    Args:
      emg: ``(B, L_pad, C)`` float32 raw EMG, zero-padded.
      sample_lengths: ``(B,)`` valid sample counts, on ``emg``'s device.
      cfg: featurizer config.

    Returns:
      ``(features, frame_lengths, means, stds)`` where features is
      ``(B, T_pad, C, n_mels)`` float32 — normalized per file when
      ``cfg.normalize == 'per_file'`` — frame_lengths is ``(B,)`` int32, and
      means/stds are the per-file statistics (zeros/ones when normalization
      is off).
    """
    return normalize_logmels(logmel_core(emg, cfg), sample_lengths, cfg)


def normalize_logmels(
    logmels: torch.Tensor, sample_lengths: torch.Tensor, cfg: FeaturizerConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """80 dB clip + layout + z-norm around the core (``featurizer.py:127-157``).

    ``logmels`` is the core's un-clipped ``(B, C, T_pad, M)`` output.
    """
    B, C, T_pad, M = logmels.shape
    dev = logmels.device
    n = (sample_lengths.to(torch.int64) - cfg.n_fft).div(cfg.hop_length, rounding_mode="floor")
    frame_lengths = torch.clamp(1 + n, min=0, max=T_pad).to(torch.int32)

    # librosa.power_to_db clips each per-channel call to (max − 80 dB)
    frame_mask = torch.arange(T_pad, device=dev)[None, :] < frame_lengths[:, None]
    masked = torch.where(frame_mask[:, None, :, None], logmels, -1e30)
    ch_max = torch.amax(masked, dim=(2, 3), keepdim=True)  # (B, C, 1, 1)
    logmels = torch.maximum(logmels, ch_max - _TOP_DB)

    features = logmels.permute(0, 2, 1, 3)  # (B, T_pad, C, M)
    valid = frame_mask[:, :, None, None]
    if cfg.normalize == "per_file":
        denom = torch.clamp(frame_lengths, min=1).to(torch.float32) * (C * M)
        x = torch.where(valid, features, 0.0)
        mean = x.sum(dim=(1, 2, 3)) / denom
        dev2 = torch.where(valid, (features - mean[:, None, None, None]) ** 2, 0.0)
        std = torch.sqrt(dev2.sum(dim=(1, 2, 3)) / denom) + 1e-8
        features = (features - mean[:, None, None, None]) / std[:, None, None, None]
        features = torch.where(valid, features, 0.0)
    else:
        mean = torch.zeros((B,), dtype=torch.float32, device=dev)
        std = torch.ones((B,), dtype=torch.float32, device=dev)
        features = torch.where(valid, features, 0.0)
    return features.contiguous(), frame_lengths, mean, std


def logmel_core(emg: torch.Tensor, cfg: FeaturizerConfig) -> torch.Tensor:
    """(B, L, C) → (B, C, T, M) un-clipped log-mel, through the custom op
    ``ssd_tpu_torch::logmel_core``: the dispatcher sends a CUDA tensor to the
    :data:`LOGMEL` kernel and a CPU tensor to :func:`logmel_core_plain`."""
    return torch.ops.ssd_tpu_torch.logmel_core(emg, *_core_fields(cfg))


def _core_fields(cfg: FeaturizerConfig) -> tuple:
    """The config's fields the core reads, as the op's scalar arguments."""
    return cfg.sample_rate, cfg.n_fft, cfg.hop_length, cfg.n_mels, cfg.fmin, cfg.fmax


def _core_cfg(sample_rate: int, n_fft: int, hop_length: int, n_mels: int, fmin: float,
              fmax: Optional[float]) -> FeaturizerConfig:
    return FeaturizerConfig(sample_rate, n_fft, hop_length, n_mels, fmin, fmax)


# --------------------------------------------------------------------------
# Plain PyTorch version (CPU path; the card's reference for the kernel)
# --------------------------------------------------------------------------


def _check_fp32_matmul(t: torch.Tensor) -> None:
    # JAX runs these products at Precision.HIGHEST; TF32 would break the
    # 2e-4 feature contract, so the plain version refuses to run under it
    if t.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "logmel_core_plain needs full-fp32 matmuls on CUDA: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


def logmel_core_plain(emg: torch.Tensor, cfg: FeaturizerConfig) -> torch.Tensor:
    """(B, L, C) → (B, C, T, M): framing by ``unfold``, then the DFT-matrix
    products (the arithmetic of ``_fused_kernel``), all fp32."""
    _check_fp32_matmul(emg)
    B, L, C = emg.shape
    T = cfg.frame_count(L)
    if T <= 0:
        raise ValueError(f"padded length {L} shorter than n_fft={cfg.n_fft}")
    dev = emg.device
    window = torch.from_numpy(melmod.hann_window(cfg.n_fft)).to(dev)
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in melmod.dft_matrices(cfg.n_fft))
    mel_t = torch.from_numpy(
        np.ascontiguousarray(
            melmod.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax).T
        )
    ).to(dev)  # (n_bins, M)

    sig = emg.to(torch.float32).permute(0, 2, 1).reshape(B * C, L)
    frames = sig.unfold(1, cfg.n_fft, cfg.hop_length)  # (B·C, T, n_fft) view
    fw = frames * window
    xr = torch.matmul(fw, cos_m)
    xi = torch.matmul(fw, sin_m)
    power = xr * xr + xi * xi  # (B·C, T, n_bins)
    mels = torch.matmul(power, mel_t)
    return (10.0 * torch.log10(torch.clamp(mels, min=_DB_FLOOR))).reshape(B, C, T, cfg.n_mels)


# --------------------------------------------------------------------------
# The kernel's host-side plan (also what the CPU tests emulate)
# --------------------------------------------------------------------------

# butterflies written out in csrc/logmel.cu, in the order the plan takes
# them; any other prime factor p gets the generic p-point pass
FFT_RADICES = (4, 2, 5, 3)


def fft_radices(n: int) -> Tuple[int, ...]:
    """The passes of the kernel's mixed-radix Stockham FFT of length ``n``:
    :data:`FFT_RADICES` in order, each as often as it divides, then the
    other primes ascending. 320 → (4, 4, 4, 5); 322 → (2, 7, 23)."""
    out = []
    for p in FFT_RADICES:
        while n % p == 0:
            out.append(p)
            n //= p
    p = 7
    while n > 1:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 2
    return tuple(out)


def fft_twiddles(n: int) -> np.ndarray:
    """(n, 2) float32 roots of unity ``e^{−2πi m/n}`` (re, im), computed in
    float64: every twiddle and every generic-pass root is a read of it."""
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def mel_bands(fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a ``(n_mels, n_bins)`` filterbank as bands: each filter's first
    bin ``lo`` (int32, n_mels) and ``max_band`` weights from it (float32,
    zero past the filter's last non-zero bin). ``lo`` is moved down where a
    band would run past the last bin, its weights shifted to match, so that
    ``lo + max_band ≤ n_bins`` and scattering the bands back gives ``fb``
    exactly."""
    n_mels, n_bins = fb.shape
    spans = []
    for row in fb:
        nz = np.flatnonzero(row)
        spans.append((int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 1))
    width = max(hi - lo for lo, hi in spans)
    lo = np.zeros(n_mels, np.int32)
    w = np.zeros((n_mels, width), np.float32)
    for m, (a, _) in enumerate(spans):
        lo[m] = min(a, n_bins - width)
        w[m] = fb[m, lo[m] : lo[m] + width]
    return lo, w


def fft_flops(n: int) -> int:
    """Real flops of one ``n``-point complex transform in the kernel's plan.
    A pass of radix R after passes of product Ns has n / R butterflies; the
    (n / R)·(1 − 1/Ns) of them whose twiddle index k = j mod Ns is not 0
    multiply inputs 1 … R − 1 by a twiddle (6 each), the others by 1 (none:
    the whole first pass); each butterfly then costs radix 2: 4, 3: 18,
    4: 16, 5: 48 real adds and multiplies. A generic pass of a prime R sums
    R terms for each of its n outputs: a complex multiply-add (8) for each
    term after the first whose root is not 1, a complex add (2) where it
    is."""
    own = {2: 4, 3: 18, 4: 16, 5: 48}
    total, ns = 0, 1
    for r in fft_radices(n):
        m, stride = n // r, n // (ns * r)
        if r in own:
            total += (m - m // ns) * 6 * (r - 1) + m * own[r]  # m // ns butterflies have k = 0
        else:
            step = ((np.arange(m) % ns)[:, None] + ns * np.arange(r)) * stride  # (j, r')
            ones = int(((step[:, :, None] * np.arange(1, r)) % n == 0).sum())
            total += 8 * (n * (r - 1) - ones) + 2 * ones
        ns *= r
    return total


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_BINS = 176  # n_fft ≤ 351
MAX_MELS = 80
MAX_ROWS = 65535  # B·C: the grid's y dimension
SMEM_LIMIT = 227 * 1024  # a CTA's dynamic shared memory on Hopper
FRAMES_PER_CTA = 16  # halved where its shared memory would pass SMEM_LIMIT


def logmel_smem_bytes(frames: int, hop: int, n_fft: int) -> int:
    """Shared memory of a CTA of ``frames`` frames (as ``csrc/logmel.cu``'s
    ``smem_bytes``): the signal span, 16-byte aligned, and two ping-pong
    buffers of ``frames / 2`` complex transforms."""
    span = ((frames - 1) * hop + n_fft + 3) & ~3
    return 4 * (span + 2 * frames * n_fft)


class LogmelKernel(CudaKernel):
    """Wrapper of ``csrc/logmel.cu``: checks, allocates, launches, counts
    (``launches``, :class:`CudaKernel`'s)."""

    def __init__(self) -> None:
        super().__init__(CudaLibrary(
            "ssd_logmel",
            "logmel.cu",
            {
                "ssd_logmel_launch": ([_P] * 7 + [_I] * 10 + [_P], _I),
            },
            error_string="ssd_cuda_error_string",
        ))
        self._consts: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    def geometry(self, cfg: FeaturizerConfig, B: int, L: int, C: int) -> Tuple[int, int]:
        """``(T, frames)`` of a launch on a ``(B, L, C)`` input; raises, before
        anything is built, on what the kernel does not take."""
        T = cfg.frame_count(L)
        if T <= 0:
            raise ValueError(f"padded length {L} shorter than n_fft={cfg.n_fft}")
        if cfg.n_bins > MAX_BINS or cfg.n_mels > MAX_MELS:
            raise ValueError(
                f"logmel kernel supports n_fft/2+1 <= {MAX_BINS} and n_mels <= {MAX_MELS}; "
                f"got n_bins={cfg.n_bins}, n_mels={cfg.n_mels}"
            )
        if B * C > MAX_ROWS:
            raise ValueError(f"logmel kernel takes at most {MAX_ROWS} signal rows, got {B * C}")
        frames = FRAMES_PER_CTA
        while frames > 2 and logmel_smem_bytes(frames, cfg.hop_length, cfg.n_fft) > SMEM_LIMIT:
            frames //= 2
        if logmel_smem_bytes(frames, cfg.hop_length, cfg.n_fft) > SMEM_LIMIT:
            raise ValueError(
                f"logmel kernel: hop_length={cfg.hop_length} with n_fft={cfg.n_fft} needs more "
                f"than {SMEM_LIMIT} bytes of shared memory for two frames a CTA"
            )
        return T, frames

    def _constants(self, cfg: FeaturizerConfig, device: torch.device):
        """The FFT plan (radices, twiddles, window) and the packed mel bands,
        kept on ``device`` per config."""
        key = (cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, str(device))
        with self._lock:
            hit = self._consts.get(key)
            if hit is None:
                radix = np.asarray(fft_radices(cfg.n_fft), np.int32)
                lo, w = mel_bands(
                    melmod.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
                )
                arrays = (radix, fft_twiddles(cfg.n_fft), melmod.hann_window(cfg.n_fft), lo, w)
                hit = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
                self._consts[key] = hit
            return hit

    def __call__(self, emg: torch.Tensor, cfg: FeaturizerConfig) -> torch.Tensor:
        if emg.device.type != "cuda":
            raise ValueError(f"logmel kernel needs a CUDA tensor, got {emg.device}")
        if emg.dtype != torch.float32:
            raise TypeError(f"logmel kernel needs float32 input, got {emg.dtype}")
        if emg.dim() != 3 or not emg.is_contiguous():
            raise ValueError(f"logmel kernel needs a contiguous (B, L, C) tensor, got {tuple(emg.shape)}")
        B, L, C = emg.shape
        T, frames = self.geometry(cfg, B, L, C)
        radix, tw, win, lo, w = self._constants(cfg, emg.device)
        out = torch.empty((B * C, T, cfg.n_mels), dtype=torch.float32, device=emg.device)
        self.launch(
            "ssd_logmel_launch", emg.device,
            emg.data_ptr(), radix.data_ptr(), tw.data_ptr(), win.data_ptr(), lo.data_ptr(),
            w.data_ptr(), out.data_ptr(),
            B, L, C, T, cfg.hop_length, cfg.n_fft, radix.numel(), cfg.n_mels, w.shape[1], frames,
        )
        return out.view(B, C, T, cfg.n_mels)


LOGMEL = LogmelKernel()


# --------------------------------------------------------------------------
# The core as a custom op: opaque to graph capture (torch.export keeps one
# node where tracing the Python would bake the CPU version in or launch the
# kernel on fake tensors), one schema on both devices
# --------------------------------------------------------------------------


@torch.library.custom_op(
    "ssd_tpu_torch::logmel_core", mutates_args=(), device_types="cpu",
    schema="(Tensor emg, int sample_rate, int n_fft, int hop_length, int n_mels, float fmin, "
           "float? fmax) -> Tensor",
)
def _logmel_core_op(emg, *fields):
    return logmel_core_plain(emg, _core_cfg(*fields))


@_logmel_core_op.register_kernel("cuda")
def _logmel_core_cuda(emg, *fields):
    return LOGMEL(emg, _core_cfg(*fields))


@_logmel_core_op.register_fake
def _logmel_core_fake(emg, *fields):
    cfg = _core_cfg(*fields)
    B, L, C = emg.shape
    T = cfg.frame_count(L)
    if T <= 0:
        raise ValueError(f"padded length {L} shorter than n_fft={cfg.n_fft}")
    return emg.new_empty((B, C, T, cfg.n_mels), dtype=torch.float32)
