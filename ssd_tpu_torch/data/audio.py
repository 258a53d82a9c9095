"""Audio loading and resampling for the teacher path (PyTorch port's own
copy of ``ssd_tpu/data/audio.py``).

WAV through the standard library's :mod:`wave`, FLAC through the port's
host decoder (:mod:`ssd_tpu_torch.data.flac`); the first channel of a
multi-channel file; then ``scipy.signal.resample_poly`` (imported only when
a file is not at the target rate) to the teacher's rate. Other formats
raise.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def _load_wav(path: Path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width {width} in {path}")
    if channels > 1:
        data = data.reshape(-1, channels)[:, 0]  # keep the first channel (mono)
    return data, sr


def _load_flac(path: Path) -> tuple[np.ndarray, int]:
    from ssd_tpu_torch.data.flac import decode_flac

    data, sr = decode_flac(path)
    if data.ndim > 1:
        data = data[:, 0]
    return data.astype(np.float32), sr


def resample(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling ``sr`` → ``target_sr`` (the identity when equal)."""
    if sr == target_sr:
        return data
    from scipy.signal import resample_poly

    g = np.gcd(int(sr), int(target_sr))
    return resample_poly(data, target_sr // g, sr // g).astype(np.float32)


def load_audio(path: Path, target_sr: int) -> np.ndarray:
    """Load audio as mono float32 resampled to ``target_sr``."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        data, sr = _load_wav(path)
    elif suffix == ".flac":
        data, sr = _load_flac(path)
    else:
        raise ValueError(f"Unsupported audio format: {path}")
    return resample(data, sr, target_sr).astype(np.float32)
