"""Plain reference of the input side: log-mel features of raw EMG, the
training-time SpecAugment (host and device forms), and the bucketed padding
of a batch. Written from the published definitions (librosa's Slaney mel
filterbank and periodic Hann window, ``center=False`` framing), independent
of the measured package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

TIME_BUCKET = 128  # feature frames a batch's time axis rounds up to
TOKEN_BUCKET = 32
TEACHER_BUCKET = 64
DB_FLOOR = 1e-10
TOP_DB = 80.0


def round_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def frame_count(n_samples: int, n_fft: int, hop: int) -> int:
    return 0 if n_samples < n_fft else 1 + (n_samples - n_fft) // hop


# ------------------------------------------------------------------ log-mel


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    logstep = math.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / logstep, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (np.maximum(m, 15.0) - 15.0)),
                    m * (200.0 / 3))


def mel_filterbank(sr: float, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalised triangles, (n_mels, n_fft // 2 + 1), float64."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return weights * (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]


def logmel(emg: torch.Tensor, lengths: torch.Tensor, sr: int, n_fft: int, hop: int,
           n_mels: int) -> tuple:
    """(B, L, C) zero-padded raw EMG, (B,) valid sample counts → ((B, T, C·M)
    per-file z-normalised log-mels, zero past each row's frames; (B,) frames).
    Power spectrum of periodic-Hann frames, mel, 10·log10 floored at 1e-10,
    each channel clipped to its valid frames' max − 80 dB."""
    B, L, C = emg.shape
    dev = emg.device
    sig = emg.float().permute(0, 2, 1).reshape(B * C, L)
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=dev).float()
    spec = torch.stft(sig, n_fft, hop_length=hop, win_length=n_fft, window=window,
                      center=False, return_complex=True)  # (B·C, bins, T)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels).astype(np.float32)).to(dev)
    mels = torch.einsum("mf,nft->ntm", fb, power)
    db = 10.0 * torch.log10(torch.clamp(mels, min=DB_FLOOR))
    T = db.shape[1]
    db = db.reshape(B, C, T, n_mels)
    frames = torch.clamp(torch.div(lengths.to(torch.int64) - n_fft, hop, rounding_mode="floor") + 1,
                         min=0, max=T)
    valid = torch.arange(T, device=dev)[None, :] < frames[:, None]  # (B, T)
    peak = torch.where(valid[:, None, :, None], db, -1e30).amax(dim=(2, 3), keepdim=True)
    db = torch.maximum(db, peak - TOP_DB).permute(0, 2, 1, 3)  # (B, T, C, M)
    v = valid[:, :, None, None]
    n = torch.clamp(frames, min=1).float() * (C * n_mels)
    mean = torch.where(v, db, 0.0).sum(dim=(1, 2, 3)) / n
    centred = db - mean[:, None, None, None]
    std = torch.sqrt(torch.where(v, centred.square(), 0.0).sum(dim=(1, 2, 3)) / n) + 1e-8
    feats = torch.where(v, centred / std[:, None, None, None], 0.0)
    return feats.reshape(B, T, C * n_mels), frames


# ------------------------------------------------------------------ SpecAugment


def spec_augment_device(feats: torch.Tensor, lengths: torch.Tensor, aug: dict,
                        generator: torch.Generator) -> torch.Tensor:
    """On-device SpecAugment of a (B, T, F) batch: with probability p a row
    gets ``time_masks`` spans of ``int(width · frames)`` and ``freq_masks``
    column spans of ``min(freq_width, F)``, starts drawn as
    ``floor(u · (room + 1))`` from three uniform draws: (B,), (B, time_masks),
    (B, freq_masks)."""
    B, T, Fd = feats.shape
    dev = feats.device
    u_apply = torch.rand((B,), generator=generator, device=dev)
    u_t = torch.rand((B, aug["time_masks"]), generator=generator, device=dev)
    u_f = torch.rand((B, aug["freq_masks"]), generator=generator, device=dev)
    lengths = lengths.to(torch.int32)
    widths = (aug["time_mask_width"] * lengths).to(torch.int32)
    room = torch.clamp(lengths - widths, min=0)[:, None]
    t0 = torch.minimum((u_t * (room + 1)).to(torch.int32), room)
    t = torch.arange(T, device=dev)[None, None, :]
    t_mask = ((t >= t0[:, :, None]) & (t < (t0 + widths[:, None])[:, :, None])).any(dim=1)
    fw = min(aug["freq_mask_width"], Fd)
    f_room = max(Fd - fw, 0)
    f0 = torch.clamp((u_f * (f_room + 1)).to(torch.int32), max=f_room)
    f = torch.arange(Fd, device=dev)[None, None, :]
    f_mask = ((f >= f0[:, :, None]) & (f < f0[:, :, None] + fw)).any(dim=1)
    zero = (t_mask[:, :, None] | f_mask[:, None, :]) & (u_apply < aug["p"])[:, None, None]
    return torch.where(zero, 0.0, feats)


def spec_augment_host(feat: np.ndarray, aug: dict, rng: np.random.Generator) -> np.ndarray:
    """Host SpecAugment of one (T, F) item, drawing from ``rng`` in this
    order: the apply draw, then each time-mask start, then each
    frequency-mask start (inclusive integer ranges)."""
    if aug["p"] <= 0 or rng.random() > aug["p"]:
        return feat
    t, f = feat.shape
    out = feat.copy()
    for _ in range(aug["time_masks"]):
        w = int(aug["time_mask_width"] * t)
        if w > 0:
            s = rng.integers(0, max(t - w, 0) + 1)
            out[s:s + w] = 0.0
    for _ in range(aug["freq_masks"]):
        w = min(aug["freq_mask_width"], f)
        if w > 0:
            s = rng.integers(0, max(f - w, 0) + 1)
            out[:, s:s + w] = 0.0
    return out


# ------------------------------------------------------------------ batches


def pad_batch(items: Sequence[Dict], pad_id: int, time_bucket: int,
              host_aug: Optional[dict] = None,
              rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """Items of ``emg`` (T, F), ``teacher`` (Tt, D), ``tokens`` (S,) → one
    batch: time rounded up to ``time_bucket``, tokens to 32, teacher frames
    to 64, zeros (tokens: ``pad_id``) past each row. ``host_aug`` augments
    each item's EMG in row order from ``rng`` first."""
    lens = np.asarray([len(it["emg"]) for it in items], np.int32)
    tok_lens = np.asarray([len(it["tokens"]) for it in items], np.int32)
    t_lens = np.asarray([len(it["teacher"]) for it in items], np.int32)
    B = len(items)
    emg = np.zeros((B, round_up(int(lens.max()), time_bucket), items[0]["emg"].shape[1]), np.float32)
    tokens = np.full((B, round_up(int(tok_lens.max()), TOKEN_BUCKET)), pad_id, np.int32)
    teacher = np.zeros((B, round_up(int(t_lens.max()), TEACHER_BUCKET),
                        items[0]["teacher"].shape[1]), np.float32)
    for i, it in enumerate(items):
        x = it["emg"]
        if host_aug is not None:
            x = spec_augment_host(x, host_aug, rng)
        emg[i, :len(x)] = x
        tokens[i, :len(it["tokens"])] = it["tokens"]
        teacher[i, :len(it["teacher"])] = it["teacher"]
    return {"emg": emg, "emg_lengths": lens, "tokens": tokens, "token_lengths": tok_lens,
            "teacher": teacher, "teacher_lengths": t_lens}


def collapse(frame_tokens: np.ndarray, blank_id: int) -> List[int]:
    """Greedy CTC read-out of one row's per-frame tokens: repeats merged,
    blanks dropped."""
    out, prev = [], -1
    for t in frame_tokens.tolist():
        if t != blank_id and t != prev:
            out.append(t)
        prev = t
    return out
