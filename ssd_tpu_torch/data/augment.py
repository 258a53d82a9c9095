"""Training-time augmentations: SpecAugment and EMG channel dropout (the
port's own copy of ``ssd_tpu/data/augment.py``).

* SpecAugment operates on the **flattened** ``(T, C·M)`` features — with
  probability ``p`` per sample, zero ``time_masks`` random spans of width
  ``int(time_mask_width · T)`` and ``freq_masks`` random column spans of
  width ``min(freq_mask_width, F)``.
* Channel dropout operates on the pre-flatten ``(T, C, M)`` tensor — with
  probability ``p``, zero 1..max_channels random channels (never all).

Two backends. numpy (the host loader): bit-identical to the JAX package's
under the same ``numpy.random.Generator``. torch (on device, inside the
train step): each function draws its random numbers from a
``torch.Generator`` and hands them to a pure function of those draws
(``_spec_augment_from_uniforms``, ``_channel_dropout_from_uniforms``), the
arithmetic of ``spec_augment_jax`` / ``channel_dropout_jax``. The two
frameworks' generators differ, so a test feeds the JAX draws to the pure
functions and compares exactly. torch is imported inside the torch
functions: the host loader's worker processes import this module and need
numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class SpecAugmentConfig:
    time_masks: int = 2
    time_mask_width: float = 0.05  # fraction of sequence length
    freq_masks: int = 2
    freq_mask_width: int = 8
    p: float = 0.0


@dataclass(frozen=True)
class ChannelDropoutConfig:
    p: float = 0.0
    max_channels: int = 1


# ----------------------------------------------------------------- numpy


def spec_augment_np(
    feat: np.ndarray, cfg: SpecAugmentConfig, rng: np.random.Generator
) -> np.ndarray:
    """Apply SpecAugment to one (T, F) array in place-safe fashion."""
    if cfg.p <= 0 or rng.random() > cfg.p:
        return feat
    t, f = feat.shape
    out = feat.copy()
    for _ in range(cfg.time_masks):
        width = int(cfg.time_mask_width * t)
        if width <= 0:
            continue
        start = rng.integers(0, max(t - width, 0) + 1)
        out[start : start + width] = 0.0
    for _ in range(cfg.freq_masks):
        width = min(cfg.freq_mask_width, f)
        if width <= 0:
            continue
        start = rng.integers(0, max(f - width, 0) + 1)
        out[:, start : start + width] = 0.0
    return out


def channel_dropout_np(
    feat: np.ndarray, cfg: ChannelDropoutConfig, rng: np.random.Generator
) -> np.ndarray:
    """Apply channel dropout to one (T, C, M) array."""
    if cfg.p <= 0 or feat.ndim != 3 or rng.random() > cfg.p:
        return feat
    channels = feat.shape[1]
    if channels <= 1:
        return feat
    max_drop = min(max(1, cfg.max_channels), channels - 1)
    drop_n = int(rng.integers(1, max_drop + 1))
    idx = rng.choice(channels, size=drop_n, replace=False)
    out = feat.copy()
    out[:, idx, :] = 0.0
    return out


# ----------------------------------------------------------------- torch


def spec_augment(
    feats: torch.Tensor,
    lengths: torch.Tensor,
    cfg: SpecAugmentConfig,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Vectorized on-device SpecAugment for a padded (B, T, F) batch; the
    time-mask width scales with each sample's valid length."""
    import torch

    if cfg.p <= 0:
        return feats
    B, dev = feats.shape[0], feats.device
    u_apply = torch.rand((B,), generator=generator, device=dev)
    u_t = torch.rand((B, cfg.time_masks), generator=generator, device=dev)
    u_f = torch.rand((B, cfg.freq_masks), generator=generator, device=dev)
    return _spec_augment_from_uniforms(feats, lengths, cfg, u_apply, u_t, u_f)


def _spec_augment_from_uniforms(feats, lengths, cfg, u_apply, u_t, u_f) -> torch.Tensor:
    import torch

    B, T, F = feats.shape
    dev = feats.device
    apply = u_apply < cfg.p

    t_idx = torch.arange(T, device=dev)[None, None, :]
    lengths = lengths.to(torch.int32)
    widths = (cfg.time_mask_width * lengths).to(torch.int32)  # (B,)
    room = torch.clamp(lengths[:, None] - widths[:, None], min=0)
    # +1 inside the scale so the last valid offset L−w is reachable, as in
    # the host path's inclusive integers(0, L−w+1)
    t_starts = torch.minimum((u_t * (room + 1)).to(torch.int32), room)
    t_mask = (
        (t_idx >= t_starts[:, :, None]) & (t_idx < (t_starts + widths[:, None])[:, :, None])
    ).any(dim=1)  # (B, T)

    f_idx = torch.arange(F, device=dev)[None, None, :]
    f_width = min(cfg.freq_mask_width, F)
    f_room = max(F - f_width, 0)
    f_starts = torch.clamp((u_f * (f_room + 1)).to(torch.int32), max=f_room)
    f_mask = ((f_idx >= f_starts[:, :, None]) & (f_idx < f_starts[:, :, None] + f_width)).any(dim=1)

    zero = (t_mask[:, :, None] | f_mask[:, None, :]) & apply[:, None, None]
    return torch.where(zero, 0.0, feats)


def channel_dropout(
    feats: torch.Tensor, cfg: ChannelDropoutConfig, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Vectorized channel dropout for a (B, T, C, M) batch."""
    import torch

    if cfg.p <= 0:
        return feats
    B, _, C, _ = feats.shape
    if C <= 1:
        return feats
    dev = feats.device
    max_drop = min(max(1, cfg.max_channels), C - 1)
    u_apply = torch.rand((B,), generator=generator, device=dev)
    drop_n = torch.randint(1, max_drop + 1, (B,), generator=generator, device=dev)
    scores = torch.rand((B, C), generator=generator, device=dev)
    return _channel_dropout_from_uniforms(feats, cfg, u_apply, drop_n, scores)


def _channel_dropout_from_uniforms(feats, cfg, u_apply, drop_n, scores) -> torch.Tensor:
    import torch

    apply = u_apply < cfg.p
    # rank channels by random score; drop the first drop_n
    ranks = torch.argsort(torch.argsort(scores, dim=1), dim=1)
    dropped = (ranks < drop_n[:, None]) & apply[:, None]  # (B, C)
    return torch.where(dropped[:, None, :, None], 0.0, feats)
