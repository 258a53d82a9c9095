"""Frozen WavLM teacher wrapper (PyTorch port of ``ssd_tpu/models/teacher.py``).

The reference's ``FrozenWavLM`` surface (``src/models/teacher.py``), though
training reads precomputed teacher features; it delegates to the port's
WavLM (:mod:`ssd_tpu_torch.models.wavlm`), which needs local weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ssd_tpu_torch.data.audio import resample
from ssd_tpu_torch.models.wavlm import WavLMTeacher


@dataclass
class TeacherConfig:
    model_name: str = "microsoft/wavlm-base-plus"
    layer: int = 9


class FrozenWavLM:
    """Runtime teacher: waveform (16 kHz mono) → layer hidden states, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: TeacherConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self._teacher = WavLMTeacher.from_pretrained(cfg.model_name, layer=cfg.layer,
                                                     device=device)

    def __call__(self, waveform: np.ndarray, sampling_rate: int = 16000) -> np.ndarray:
        """Returns (frames, dim) float32; resamples if needed."""
        waveform = resample(np.asarray(waveform, np.float32), sampling_rate, 16000)
        return self._teacher.extract(np.asarray(waveform, np.float32))
