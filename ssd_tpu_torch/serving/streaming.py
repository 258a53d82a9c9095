"""Chunked streaming transcription with bounded recompute (PyTorch port of
``ssd_tpu/serving/streaming.py``).

Re-running the whole pipeline over the buffered stream at every update
(:class:`~ssd_tpu_torch.serving.engine.StreamingTranscriber`) costs O(T²)
over an unbounded stream. Here each update encodes one fixed-shape window

    [ left context W | new chunk S | lookahead R ]   (frames, all even)

and emits CTC outputs only for the chunk, whose frames have W frames of
history and R frames of future context:

    raw window samples ─ log-mel core (the card's kernel) ─ running z-norm
    ─ encoder ─ CTC head ─ log-probs  +  the new chunk's feature statistics

The window is one plain function on tensors, :func:`stream_window`, over
the engine's model: PyTorch runs eagerly, so there is no per-geometry
compile to cache (the JAX engine keeps one jitted window per geometry).
Its log-probs and statistics come back to the host in one device→host copy
a window. It runs under the engine's lock: one device and one stream serve
the micro-batcher and every session.

The departures from the offline pipeline are the JAX package's:

* **attention context** is truncated to [W left, R right] for emitted
  frames (offline attends over the whole utterance);
* **per-file z-normalization** becomes a *running* z-norm: mean / std over
  every frame seen so far. The host keeps the totals ``(sum, sumsq,
  count)`` in float64 / int (fp32 accumulators drift over an unbounded
  stream); the device sees the prior moments as fp32 scalars. At the end of
  a stream the statistics equal the per-file ones, so a stream that fits
  one window decodes exactly like the offline path;
* **the 80 dB dynamic-range clip** is applied per window, not per file.

Window starts stay congruent to 0 mod ``subsample_factor``, so the strided
subsampler sees the phase it would offline: emitted frame j of a window
starting at frame ``a`` is offline output frame ``a / subsample + j``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ssd_tpu_torch.ops.featurizer import FeaturizerConfig, logmel_batch


def collapse_ids(ids, carry: int, blank_id: int, pad_id: int) -> Tuple[List[int], int]:
    """CTC-collapse a run of per-frame argmax ids against a carried token.

    ``carry`` is the previous run's final raw id (or ``blank_id`` at the
    start): a chunk that begins with the token its predecessor ended with
    is one repeated emission, not two. Returns (emitted token ids, new carry).
    """
    out: List[int] = []
    for t in ids:
        t = int(t)
        if t != carry and t != blank_id and t != pad_id:
            out.append(t)
        carry = t
    return out, carry


def stream_window(
    engine,
    feat_cfg: FeaturizerConfig,
    raw: torch.Tensor,
    n_samples: int,
    chunk_start: int,
    chunk_frames: int,
    prior: Tuple[float, float, float],
) -> Tuple[np.ndarray, int, float, float, int]:
    """One streaming update on the engine's device.

    Args:
      engine: the :class:`~ssd_tpu_torch.serving.engine.InferenceEngine`
        whose model encodes the window.
      feat_cfg: the engine's featurizer config with ``normalize="none"``.
      raw: ``(1, Lw, C)`` float32 window samples on the engine's device,
        zero-padded on the right.
      n_samples: the window's valid sample count.
      chunk_start: the first NEW frame within the window.
      chunk_frames: S, the new frames the window may hold.
      prior: the running statistics before this chunk, in moment form
        ``(mean, mean of squares, count)``.

    Returns ``(log_probs (T', V) float32, out_length, chunk_sum,
    chunk_sumsq, chunk_count)``: the whole window's log-probs and the NEW
    frames' feature statistics (sums bounded by the window, so fp32 holds
    them), which the host folds into its float64 totals.
    """
    dev = raw.device
    feats, frame_lengths, _, _ = logmel_batch(
        raw, torch.tensor([n_samples], dtype=torch.int32, device=dev), feat_cfg
    )  # (1, Tw, C, M), clipped, not normalized, zeros past the valid frames
    _, Tw, C, M = feats.shape
    frames = min(max(0, 1 + (n_samples - feat_cfg.n_fft) // feat_cfg.hop_length), Tw)
    n_new = max(0, min(chunk_frames, frames - chunk_start))
    # statistics over the NEW frames only (each stream frame counts once)
    chunk = feats.narrow(1, chunk_start, n_new)
    chunk_sum, chunk_sumsq = chunk.sum(), chunk.square().sum()
    # merge with the prior moments, then normalize the whole window — the
    # running analogue of the per-file z-norm (std + 1e-8, as the reference)
    prior_mean, prior_meansq, prior_cnt, chunk_cnt = torch.tensor(
        [*prior, n_new * C * M], dtype=torch.float32
    ).to(dev).unbind()
    denom = torch.clamp(prior_cnt + chunk_cnt, min=1.0)
    mean = (prior_mean * prior_cnt + chunk_sum) / denom
    meansq = (prior_meansq * prior_cnt + chunk_sumsq) / denom
    std = torch.sqrt(torch.clamp(meansq - mean.square(), min=0.0)) + 1e-8
    valid = (torch.arange(Tw, device=dev) < frames)[None, :, None, None]
    feats = torch.where(valid, (feats - mean) / std, 0.0)
    log_probs, out_lengths = engine.encode(feats, frame_lengths)
    V = log_probs.shape[-1]
    # one device→host copy: the log-probs, then the length and the two sums
    host = torch.cat([
        log_probs[0].reshape(-1),
        torch.stack([out_lengths[0].to(torch.float32), chunk_sum, chunk_sumsq]),
    ]).cpu().numpy()
    lp = host[:-3].reshape(-1, V)
    return lp, int(host[-3]), float(host[-2]), float(host[-1]), n_new * C * M


class ChunkedStreamingTranscriber:
    """Incremental EMG transcription with O(window) compute per update.

    Args:
      engine: an :class:`~ssd_tpu_torch.serving.engine.InferenceEngine`
        (model, device, featurizer config and vocab are taken from it).
      chunk_frames: S — new feature frames per emission step.
      left_context_frames: W — history frames re-encoded with every chunk.
      right_context_frames: R — lookahead; emission lags the stream head by
        R frames (R·hop ms of algorithmic latency) so emitted frames always
        have R frames of future context.
      blank_bias: additive blank bias for the incremental greedy decode.
    """

    def __init__(
        self,
        engine,
        chunk_frames: int = 96,
        left_context_frames: int = 512,
        right_context_frames: int = 32,
        blank_bias: float = 0.0,
    ) -> None:
        self.engine = engine
        self.vocab = engine.vocab
        self.blank_bias = float(blank_bias)
        cfg = engine.feat_cfg
        # the window featurizes WITHOUT normalization; the z-norm runs
        # against the carried statistics
        self.feat_cfg = FeaturizerConfig(
            sample_rate=cfg.sample_rate,
            n_fft=cfg.n_fft,
            hop_length=cfg.hop_length,
            n_mels=cfg.n_mels,
            fmin=cfg.fmin,
            fmax=cfg.fmax,
            normalize="none",
        )
        factor = int(engine.cfg["model"]["encoder"].get("subsample_factor", 2))
        self.factor = factor

        def up(n: int) -> int:
            return max(factor, ((int(n) + factor - 1) // factor) * factor)

        self.S = up(chunk_frames)
        self.W = up(left_context_frames)
        self.R = up(right_context_frames)
        self.Tw = self.W + self.S + self.R  # window frames
        hop, n_fft = cfg.hop_length, cfg.n_fft
        self.Lw = (self.Tw - 1) * hop + n_fft  # window samples
        self.channels = int(engine.cfg["model"]["encoder"]["input_dim"]) // cfg.n_mels
        self.reset()

    # ------------------------------------------------------------ internals

    def _complete_frames(self) -> int:
        n = self._total_samples
        cfg = self.feat_cfg
        return max(0, 1 + (n - cfg.n_fft) // cfg.hop_length) if n >= cfg.n_fft else 0

    def _window_samples(self, a: int) -> np.ndarray:
        """Assemble samples [a·hop, a·hop + Lw) from the pending pieces."""
        start = a * self.feat_cfg.hop_length
        out = np.zeros((self.Lw, self.channels), np.float32)
        pos = self._chunk_offset
        for piece in self._chunks:
            end = pos + len(piece)
            lo, hi = max(start, pos), min(start + self.Lw, end)
            if hi > lo:
                out[lo - start : hi - start] = piece[lo - pos : hi - pos]
            pos = end
        return out

    def _drop_consumed(self) -> None:
        """Discard sample pieces older than any future window can need."""
        needed_from = max(0, (self._emitted - self.W)) * self.feat_cfg.hop_length
        while self._chunks and self._chunk_offset + len(self._chunks[0]) <= needed_from:
            self._chunk_offset += len(self._chunks[0])
            self._chunks.pop(0)

    def _run_window(self, emit_until: int) -> None:
        """Encode one window and emit frames [self._emitted, emit_until)."""
        e = self._emitted
        a = max(0, e - self.W)
        a -= a % self.factor  # keep the subsampler's phase (already a multiple; guard)
        raw = self._window_samples(a)
        n_samp = min(self._total_samples - a * self.feat_cfg.hop_length, self.Lw)
        s, q, c = self._stats  # float64 sums + exact int count (host-side)
        prior = (np.float32(s / c if c else 0.0), np.float32(q / c if c else 0.0), np.float32(c))
        engine = self.engine
        with engine._lock, torch.inference_mode():
            lp, out_len, dsum, dsumsq, dcnt = stream_window(
                engine, self.feat_cfg, torch.from_numpy(raw[None]).to(engine.device), n_samp,
                e - a, self.S, prior,
            )
        self.windows += 1
        self._stats = (s + dsum, q + dsumsq, c + dcnt)
        j0 = (e - a) // self.factor
        if emit_until >= self._complete_frames():
            # final flush: take every remaining subsampled output
            # (out_len = ceil((F − a)/factor), which floor division misses)
            j1 = out_len
        else:
            j1 = min((emit_until - a) // self.factor, out_len)
        emitted_lp = lp[j0:j1]
        self._log_probs.append(emitted_lp)
        ids = np.argmax(self._biased(emitted_lp), axis=-1)
        toks, self._carry = collapse_ids(ids, self._carry, self.vocab.blank_id, self.vocab.pad_id)
        self._ids.extend(toks)
        self._emitted = emit_until
        self._drop_consumed()
        self.hypothesis = self.vocab.decode(self._ids)

    def _biased(self, lp: np.ndarray) -> np.ndarray:
        if not self.blank_bias:
            return lp
        out = lp.copy()
        out[:, self.vocab.blank_id] += self.blank_bias
        return out

    # -------------------------------------------------------------- public
    def feed(self, samples: np.ndarray) -> Optional[str]:
        """Append (n, C) raw samples; returns the hypothesis when it grew."""
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 2 or samples.shape[1] != self.channels:
            raise ValueError(f"expected (n, {self.channels}) samples, got {samples.shape}")
        self._chunks.append(samples)
        self._total_samples += len(samples)
        updated = False
        while self._complete_frames() >= self._emitted + self.S + self.R:
            self._run_window(self._emitted + self.S)
            updated = True
        return self.hypothesis if updated else None

    def finish(self, beam: bool = False) -> str:
        """Flush the tail (no lookahead left to wait for) and finalize.

        With ``beam=True`` the emitted per-frame log-probs get ONE beam pass
        (the engine's beam / LM configuration) on the engine's device: a
        single decode over the emitted sequence, no encoder recompute.
        """
        F = self._complete_frames()
        while self._emitted < F:
            self._run_window(min(self._emitted + self.S, F))
        if beam and self._log_probs:
            all_lp = np.concatenate(self._log_probs, axis=0)
            T = len(all_lp)
            # pad T to a multiple of 128, the JAX package's decode bucket
            T_pad = max(128, ((T + 127) // 128) * 128)
            padded = np.zeros((1, T_pad, all_lp.shape[-1]), np.float32)
            padded[0, :T] = all_lp
            engine = self.engine
            with engine._lock:
                # an explicit decoder: the shared engine's setting, read by
                # the micro-batcher's thread, is never changed
                self.hypothesis = engine.decode(
                    torch.from_numpy(padded).to(engine.device),
                    torch.tensor([T], dtype=torch.int32, device=engine.device),
                    decoder="beam",
                )[0]
        return self.hypothesis

    def reset(self) -> None:
        self._chunks: List[np.ndarray] = []  # pending raw sample pieces
        self._chunk_offset = 0  # absolute sample index of _chunks[0][0]
        self._total_samples = 0
        self._emitted = 0  # frames whose outputs are final
        self._stats = (0.0, 0.0, 0)  # running (sum, sumsq, count) of features
        self._ids: List[int] = []  # collapsed token ids so far
        self._carry = self.vocab.blank_id
        self._log_probs: List[np.ndarray] = []  # emitted per-frame log-probs
        self.windows = 0  # windows encoded since the last reset
        self.hypothesis = ""
