"""FLAC decoding through the port's host library (PyTorch port's own copy of
``ssd_tpu/data/flac.py``).

The decoder (``ssd_tpu_torch/native/flac_decoder.cpp``) covers the subset
the Gaddy & Klein corpus uses: 16-bit mono or stereo streams with constant,
verbatim, fixed and LPC subframes and Rice residuals.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from ssd_tpu_torch.utils.native import FlacInfo, load


def decode_flac(path: Path) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file → (float32 samples in [-1, 1], sample_rate).

    Stereo returns shape ``(n, channels)``; mono returns ``(n,)``.
    """
    lib = load()
    data = Path(path).read_bytes()
    info = FlacInfo()
    lib.flac_decode(data, len(data), None, 0, ctypes.byref(info))  # capacity query
    if info.channels == 0:
        raise ValueError(f"Not a decodable FLAC stream: {path}")
    capacity = int(info.total_samples) * info.channels
    if capacity == 0:
        # unknown length in STREAMINFO — size generously from the bitstream
        capacity = max(len(data) * 4, 1 << 20)
    out = np.empty(capacity, dtype=np.int32)
    n = lib.flac_decode(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        capacity,
        ctypes.byref(info),
    )
    if n < 0:
        raise ValueError(f"FLAC decode failed with code {n} for {path}")
    scale = float(1 << (info.bits_per_sample - 1))
    audio = out[:n].astype(np.float32) / scale
    if info.channels > 1:
        audio = audio.reshape(-1, info.channels)
    return audio, int(info.sample_rate)
