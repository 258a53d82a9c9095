"""EMG log-mel featurizer (PyTorch port of ``ssd_tpu/ops/featurizer.py``).

Per channel: STFT (``center=False``, periodic Hann) → power spectrum →
Slaney mel filterbank → ``10·log10(max(x, 1e-10))`` → per-channel 80 dB
clip over the valid frames → ``(frames, channels, n_mels)`` → per-file
z-normalization with ``std + 1e-8``.

The frame → mel → log core (:func:`logmel_core`) dispatches on the device
of its input: a CUDA tensor goes to the hand-written kernel in
``csrc/logmel.cu`` (the counterpart of the Pallas ``_fused_kernel``), a CPU
tensor to the plain version :func:`logmel_core_plain`. There is no fall
back: a CUDA tensor reaches the kernel or raises. The clip and the z-norm
stay in plain torch around the core, where they sit outside the Pallas
kernel in JAX too.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
    """(B, L, C) → (B, C, T, M) un-clipped log-mel.

    CUDA tensor → :data:`LOGMEL` kernel; CPU tensor → :func:`logmel_core_plain`.
    """
    if emg.device.type == "cpu":
        return logmel_core_plain(emg, cfg)
    if emg.device.type != "cuda":
        raise ValueError(f"logmel_core: unsupported device {emg.device}")
    return LOGMEL(emg, cfg)


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
# CUDA kernel wrapper
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class LogmelKernel(CudaKernel):
    """Wrapper of ``csrc/logmel.cu``: checks, allocates, launches, counts
    (``launches``, :class:`CudaKernel`'s)."""

    def __init__(self) -> None:
        super().__init__(CudaLibrary(
            "ssd_logmel",
            "logmel.cu",
            {
                "ssd_logmel_launch": ([_P, _P, _P, _P] + [_I] * 7 + [_P], _I),
                "ssd_logmel_bins_pad": ([], _I),
                "ssd_logmel_mels_pad": ([], _I),
                "ssd_logmel_chunk": ([], _I),
            },
            error_string="ssd_cuda_error_string",
        ))
        self._consts: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, int]] = {}
        self._lock = threading.Lock()

    def _constants(self, cfg: FeaturizerConfig, device: torch.device, lib):
        """Windowed (cos, sin) DFT matrix and mel matrix, padded to the
        kernel's tile sizes and kept on ``device``."""
        key = (cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, str(device))
        with self._lock:
            hit = self._consts.get(key)
            if hit is not None:
                return hit
            bins_pad, mels_pad, chunk = (
                lib.ssd_logmel_bins_pad(), lib.ssd_logmel_mels_pad(), lib.ssd_logmel_chunk()
            )
            if cfg.n_bins > bins_pad or cfg.n_mels > mels_pad:
                raise ValueError(
                    f"logmel kernel supports n_fft/2+1 <= {bins_pad} and n_mels <= "
                    f"{mels_pad}; got n_bins={cfg.n_bins}, n_mels={cfg.n_mels}"
                )
            n_fft_pad = -(-cfg.n_fft // chunk) * chunk
            window = melmod.hann_window(cfg.n_fft, np.float64)[:, None]
            cos_m, sin_m = melmod.dft_matrices(cfg.n_fft, np.float64)
            dft = np.zeros((n_fft_pad, bins_pad, 2), np.float32)
            dft[: cfg.n_fft, : cfg.n_bins, 0] = window * cos_m
            dft[: cfg.n_fft, : cfg.n_bins, 1] = window * sin_m
            mel = np.zeros((bins_pad, mels_pad), np.float32)
            mel[: cfg.n_bins, : cfg.n_mels] = melmod.mel_filterbank(
                cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax
            ).T
            hit = (torch.from_numpy(dft).to(device), torch.from_numpy(mel).to(device), n_fft_pad)
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
        T = cfg.frame_count(L)
        if T <= 0:
            raise ValueError(f"padded length {L} shorter than n_fft={cfg.n_fft}")
        if B * C > 65535:
            raise ValueError(f"logmel kernel takes at most 65535 signal rows, got {B * C}")
        lib = self.library.load()
        dft, mel, n_fft_pad = self._constants(cfg, emg.device, lib)
        # shared memory grows with hop; a request past the device's limit
        # makes cudaFuncSetAttribute fail, which raises below
        out = torch.empty((B * C, T, cfg.n_mels), dtype=torch.float32, device=emg.device)
        self.launch(
            "ssd_logmel_launch", emg.device,
            emg.data_ptr(), dft.data_ptr(), mel.data_ptr(), out.data_ptr(),
            B, L, C, T, cfg.hop_length, n_fft_pad, cfg.n_mels,
        )
        return out.view(B, C, T, cfg.n_mels)


LOGMEL = LogmelKernel()
