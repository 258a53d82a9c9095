"""The one traffic generator: every workload file's parameters become
utterances, batches and arrival schedules here, from ``--seed``.

Every seed gets the same set of sizes and of arrival gaps, in another order
(stratified draws, then a seeded permutation), so two seeds do the same
work. Signal contents are drawn on the device in a few large calls.
"""

from __future__ import annotations

import string
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

LETTERS = string.ascii_lowercase


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's seed and keys."""
    return int(np.random.SeedSequence((int(seed), *keys)).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), *keys))


def stratified(lo: float, hi: float, n: int, r: np.random.Generator) -> np.ndarray:
    """``n`` values spread evenly over [lo, hi], in a seeded order."""
    return r.permutation(lo + (hi - lo) * (np.arange(n) + 0.5) / n)


def round_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def transcript(n_chars: int, r: np.random.Generator) -> str:
    """Random lower-case words of 1–8 letters, one space between, exactly
    ``n_chars`` characters, no space at either end."""
    out: List[str] = []
    size = 0
    while size < n_chars:
        w = "".join(r.choice(list(LETTERS), size=int(r.integers(1, 9))))
        out.append(w)
        size += len(w) + 1
    return " ".join(out)[:n_chars].strip().ljust(n_chars, "e")


def _device_normal(sizes: Sequence[int], width: int, seed: int, device, dtype) -> List[np.ndarray]:
    """One (n, width) float32 host array a size, all drawn in one call on the
    device (bf16 values where ``dtype`` is bf16)."""
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn((int(sum(sizes)), width), generator=g, device=device, dtype=dtype)
    host = flat.float().cpu().numpy()
    return np.split(host, np.cumsum(sizes)[:-1])


def train_items(cell: Dict, cfg: Dict, tokens: List[str], seed: int, device) -> List[Dict]:
    """The ring's utterances: raw EMG (samples, channels) or cached features
    (frames, channels · mels), teacher frames, a transcript and its ids."""
    n = cell["ring_batches"] * cell["batch_size"]
    r = rng(seed, 1)
    samples = np.rint(stratified(cell["min_samples"], cell["max_samples"], n, r)).astype(int)
    rate = stratified(cell["chars_per_s"][0], cell["chars_per_s"][1], n, r)
    femg = cfg["features"]["emg"]
    sr, hop, n_fft = femg["sample_rate"], femg["hop_length"], femg["n_fft"]
    if cfg["data"].get("train_from_raw", False):
        sizes, width = samples.tolist(), cell["channels"]
    else:
        sizes = [1 + (s - n_fft) // hop for s in samples]
        width = cell["channels"] * femg["n_mels"]
    t_sizes = [int(round(s * cell["teacher_fps"] / sr)) for s in samples]
    emg = _device_normal(sizes, width, sub_seed(seed, 2), device, torch.float32)
    tdt = torch.bfloat16 if cfg["data"].get("teacher_dtype") == "bfloat16" else torch.float32
    teacher = _device_normal(t_sizes, cfg["features"]["teacher"]["dim"], sub_seed(seed, 3),
                             device, tdt)
    ids = {t: i for i, t in enumerate(tokens)}
    items = []
    for i in range(n):
        text = transcript(int(round(rate[i] * samples[i] / sr)), r)
        items.append({"utterance_id": f"u{i:05d}", "transcript": text, "emg": emg[i],
                      "teacher": teacher[i],
                      "tokens": np.asarray([ids[c] for c in text], np.int32)})
    return items


def ring_groups(lengths: Sequence[int], batch_size: int, time_bucket: int,
                r: np.random.Generator) -> List[List[int]]:
    """The loader's batching: a seeded shuffle, a stable sort by bucketed
    length, then cut into rows of ``batch_size``."""
    idx = list(r.permutation(len(lengths)))
    idx.sort(key=lambda i: round_up(int(lengths[i]), time_bucket))
    return [[int(i) for i in idx[k:k + batch_size]] for k in range(0, len(idx), batch_size)]


def walk(n: int, r: np.random.Generator) -> Iterator[int]:
    """Ring positions forever: each pass a fresh seeded permutation."""
    while True:
        yield from (int(i) for i in r.permutation(n))


def serve_pool(cell: Dict, seed: int, device) -> List[np.ndarray]:
    """The distinct request signals: raw EMG of stratified lengths."""
    r = rng(seed, 4)
    lengths = np.rint(stratified(cell["min_samples"], cell["max_samples"], cell["pool"], r))
    return _device_normal(lengths.astype(int).tolist(), cell["channels"], sub_seed(seed, 5),
                          device, torch.float32)


def arrivals(rate: float, seconds: float, pool_size: int, seed: int, stretch: int = 0) -> tuple:
    """Open-loop Poisson arrivals at ``rate``/s over ``seconds``: gaps are
    the exponential distribution's stratified quantiles in a seeded order.
    ``stretch`` numbers further schedules of the same seed (the traced
    stretches after the window). Returns (due times from 0, pool index of
    each request)."""
    r = rng(seed, 6, stretch)
    n = max(1, int(round(rate * seconds)))
    gaps = r.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])  # the stratified sum stays under n / rate
    due = due[due < seconds]
    picks = np.concatenate([r.permutation(pool_size) for _ in range(-(-len(due) // pool_size))])
    return due, picks[:len(due)]
