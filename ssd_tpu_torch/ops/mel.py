"""Mel filterbank and window constants, librosa-parity.

The reference featurizer (``src/data/preprocessing.py:67-85``) uses
``librosa.filters.mel`` (Slaney scale, ``norm='slaney'``) and
``librosa.stft(center=False)`` with a periodic Hann window. librosa is not a
dependency of this framework, so the same math is implemented here from the
published Slaney auditory-toolbox formulas; features produced with these
constants must match the reference cache to numerical tolerance
(BASELINE.md "Numerics" target).

Everything in this module is host-side numpy producing constants that the
featurizer moves to the device once per config. This is the port's own copy
of ``ssd_tpu/ops/mel.py``: the two packages share no code.
"""

from __future__ import annotations

import numpy as np

# Slaney mel scale constants: linear below 1 kHz, logarithmic above.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray | float) -> np.ndarray:
    """Hz → mel (Slaney / auditory-toolbox variant, librosa ``htk=False``)."""
    f = np.asanyarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    """Mel → Hz (inverse of :func:`hz_to_mel`)."""
    m = np.asanyarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """``n_mels`` frequencies uniformly spaced on the mel scale, in Hz."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``.

    Slaney-normalized triangles (each filter scaled by 2 / bandwidth), matching
    ``librosa.filters.mel(..., htk=False, norm='slaney')`` bit-for-bit in
    float64 before the final cast.
    """
    if fmax is None:
        fmax = sr / 2.0

    fftfreqs = fft_frequencies(sr, n_fft)  # (n_bins,)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)  # (n_mels + 2,)

    fdiff = np.diff(mel_f)  # (n_mels + 1,)
    ramps = mel_f[:, None] - fftfreqs[None, :]  # (n_mels + 2, n_bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization: constant energy per channel.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)


def hann_window(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Periodic ("fftbins") Hann window — librosa's STFT default."""
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(dtype)


def dft_matrices(n_fft: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices ``(n_fft, 1 + n_fft//2)`` for rFFT-as-matmul.

    A small real FFT as two dense products: ``X_re = frames @ C``,
    ``X_im = frames @ S`` with ``C[n,k] = cos(-2πnk/N)``,
    ``S[n,k] = sin(-2πnk/N)``. The arithmetic of the Pallas kernel, kept by
    the log-mel kernel's plain PyTorch version (the CUDA kernel runs an FFT).
    """
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def num_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    """Frame count for ``center=False`` framing: ``1 + (L - n_fft) // hop``."""
    if n_samples < n_fft:
        return 0
    return 1 + (n_samples - n_fft) // hop_length
