"""Inference engine: raw EMG → text on one device (PyTorch port of
``ssd_tpu/serving/engine.py``).

    engine = InferenceEngine.from_checkpoint("results/checkpoints/run/best")
    hyps = engine.transcribe([emg1, emg2])   # raw (samples, channels) arrays

The chain is the CUDA log-mel kernel (``ops/featurizer.py``), the Conformer
encoder and CTC head, and greedy or beam CTC decoding on the device — with
an ARPA ``lm_path`` the beam fuses the n-gram LM on the device
(``decoding/device_lm.py``); only the decoded tokens or backpointers come
back to the host. Requests pad to the JAX engine's
buckets — raw samples to ``SAMPLE_BUCKET`` multiples, batches to
``BATCH_BUCKETS`` — so both packages see the same shapes and padded rows
(length ``n_fft``) for the same request.

The engine runs on ``device="cuda"`` unless the caller asks for the CPU; a
missing card raises.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.decoding.ctc import build_beam_decoder, build_greedy_decoder
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig, logmel_batch
from ssd_tpu_torch.training.checkpoint import load_checkpoint, load_config_for
from ssd_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

SAMPLE_BUCKET = 2560  # raw-sample padding granularity (256 frames @ hop 10)
BATCH_BUCKETS = (1, 4, 8)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclass
class LatencyStats:
    samples: List[float] = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        if len(self.samples) > 10000:
            del self.samples[: len(self.samples) // 2]

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "count": int(arr.size),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "mean_ms": float(arr.mean() * 1e3),
        }


class InferenceEngine:
    """Raw 8-channel EMG → text."""

    def __init__(
        self,
        cfg: Dict[str, Any],
        state_dict: Mapping[str, torch.Tensor],
        vocab: Vocab,
        decoder: str = "greedy",
        beam_width: int = 50,
        blank_bias: float = 0.0,
        token_top_k: Optional[int] = None,
        lm_path: Optional[Path] = None,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        featurizer_cfg: Optional[FeaturizerConfig] = None,
        data_parallel: bool = False,
        quantize: Optional[str] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder must be 'greedy' or 'beam', got {decoder!r}")
        if data_parallel:
            raise NotImplementedError(
                "data-parallel serving is not ported to ssd_tpu_torch yet "
                "(ROADMAP.md queue 1 item 10)"
            )
        if quantize not in (None, "none"):
            raise NotImplementedError(
                f"quantize={quantize!r} is not ported to ssd_tpu_torch yet "
                "(ROADMAP.md queue 1 item 9)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = vocab
        self.decoder = decoder
        self.beam_width = beam_width
        self.blank_bias = blank_bias
        decoding_cfg = cfg.get("decoding", {}) or {}
        # LM fusion: path and weights from the constructor > the config's
        # decoding block > 0.5 / 0.0, as the JAX engine
        lm_path = lm_path or decoding_cfg.get("lm_path")
        self.alpha = float(alpha if alpha is not None else decoding_cfg.get("alpha", 0.5))
        self.beta = float(beta if beta is not None else decoding_cfg.get("beta", 0.0))
        # constructor arg > config decoding block > default 16
        if token_top_k is None:
            token_top_k = decoding_cfg.get("token_top_k", 16)
        self.token_top_k = min(int(token_top_k), vocab.size) if token_top_k else None
        # the decoder factory's closures: it loads the LM (the sidecar-cached
        # packed table) and warns for a path that does not exist
        self._decoders = {
            "greedy": build_greedy_decoder(vocab, blank_bias=blank_bias),
            "beam": build_beam_decoder(
                vocab,
                lm_path=Path(lm_path) if lm_path and decoder == "beam" else None,
                beam_width=beam_width,
                alpha=self.alpha,
                beta=self.beta,
                blank_bias=blank_bias,
                token_top_k=self.token_top_k,
            ),
        }
        self.has_lm = self._decoders["beam"].has_lm
        if self.has_lm:
            logger.info("Serving with LM fusion on %s: %s", self.device, lm_path)
        feat_cfg = cfg.get("features", {}).get("emg", {})
        self.feat_cfg = featurizer_cfg or FeaturizerConfig(
            sample_rate=feat_cfg.get("sample_rate", 1000),
            n_fft=feat_cfg.get("n_fft", 320),
            hop_length=feat_cfg.get("hop_length", 10),
            n_mels=feat_cfg.get("n_mels", 80),
            normalize=feat_cfg.get("normalize", "per_file"),
        )
        input_dim = cfg["model"]["encoder"].get("input_dim")
        if input_dim is None:
            raise ValueError("encoder.input_dim required for serving")
        model = build_model(cfg, input_dim=int(input_dim), vocab_size=vocab.size)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.stats = LatencyStats()
        # one device, one stream: requests from the HTTP threads and the
        # micro-batcher run the device work one batch at a time
        self._lock = threading.Lock()

    # ------------------------------------------------------------ factory
    @classmethod
    def from_checkpoint(
        cls, ckpt_path: Path, vocab_path: Optional[Path] = None, **kwargs
    ) -> "InferenceEngine":
        cfg = load_config_for(Path(ckpt_path))
        payload = load_checkpoint(Path(ckpt_path))
        vocab = Vocab.from_json(vocab_path or Path(cfg["data"]["vocab"]))
        return cls(cfg, payload["state_dict"], vocab, **kwargs)

    # ----------------------------------------------------------- pipeline
    def _pad(self, emg_arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Requests → the bucket-padded (B_pad, L_pad, C) batch + lengths."""
        n = len(emg_arrays)
        lengths = np.asarray([len(a) for a in emg_arrays], np.int32)
        L_pad = _round_up(int(lengths.max()), SAMPLE_BUCKET)
        B_pad = next((b for b in BATCH_BUCKETS if b >= n), _round_up(n, BATCH_BUCKETS[-1]))
        C = emg_arrays[0].shape[1]
        batch = np.zeros((B_pad, L_pad, C), np.float32)
        for i, a in enumerate(emg_arrays):
            batch[i, : len(a)] = a
        pad_lengths = np.concatenate(
            [lengths, np.full((B_pad - n,), self.feat_cfg.n_fft, np.int32)]
        )
        return batch, pad_lengths

    @torch.inference_mode()
    def forward(self, emg_arrays: Sequence[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw arrays → ``(log_probs (B_pad, T', V), out_lengths (B_pad,))``
        on the engine's device, for the whole padded batch."""
        batch, pad_lengths = self._pad(emg_arrays)
        emg = torch.from_numpy(batch).to(self.device)
        lens = torch.from_numpy(pad_lengths).to(self.device)
        feats, frame_lengths, _, _ = logmel_batch(emg, lens, self.feat_cfg)
        B, T, C, M = feats.shape
        return self.model.ctc_log_probs(feats.reshape(B, T, C * M), frame_lengths)

    @torch.inference_mode()
    def decode(
        self, log_probs: torch.Tensor, out_lengths: torch.Tensor, decoder: Optional[str] = None
    ) -> List[str]:
        """Decode log-probs with ``decoder`` (default: the engine's setting)
        on their device; only tokens / backpointers reach the host."""
        return self._decoders[decoder or self.decoder](log_probs, out_lengths)

    # ------------------------------------------------------------- public
    def transcribe(self, emg_arrays: Sequence[np.ndarray]) -> List[str]:
        """Transcribe a list of raw (samples, channels) float arrays."""
        t0 = time.perf_counter()
        n = len(emg_arrays)
        if n == 0:
            return []
        with self._lock:
            log_probs, out_lengths = self.forward(emg_arrays)
            hyps = self.decode(log_probs, out_lengths)[:n]
        per_utt = (time.perf_counter() - t0) / n
        for _ in range(n):
            self.stats.record(per_utt)
        return hyps

    def warmup(self, max_seconds: float = 12.0, grid: bool = False) -> None:
        """Run every batch bucket once (builds the kernel, warms the
        allocator and library heuristics) so the first request pays none of
        it. ``grid=True`` also runs every shorter length bucket."""
        C = int(self.cfg["model"]["encoder"]["input_dim"]) // self.feat_cfg.n_mels
        max_samples = int(max_seconds * self.feat_cfg.sample_rate)
        if grid:
            top = _round_up(max_samples, SAMPLE_BUCKET)
            lengths = list(range(SAMPLE_BUCKET, top + 1, SAMPLE_BUCKET))
        else:
            lengths = [max_samples]
        for n_samples in lengths:
            for b in BATCH_BUCKETS:
                self.transcribe([np.zeros((n_samples, C), np.float32)] * b)
        self.stats.samples.clear()


class StreamingTranscriber:
    """Incremental transcription over a growing EMG stream.

    Append raw samples with :meth:`feed`; every ``update_every_sec`` of new
    signal the engine re-runs the full pipeline over the buffered signal and
    returns the refreshed hypothesis (full recompute: the Conformer is
    bidirectional).
    """

    def __init__(self, engine: InferenceEngine, update_every_sec: float = 0.5):
        self.engine = engine
        self.update_samples = int(update_every_sec * engine.feat_cfg.sample_rate)
        self._chunks: List[np.ndarray] = []
        self._since_update = 0
        self.hypothesis = ""

    def feed(self, samples: np.ndarray) -> Optional[str]:
        """Append (n, C) samples; returns a new hypothesis when refreshed."""
        self._chunks.append(np.asarray(samples, np.float32))
        self._since_update += len(samples)
        total = sum(len(c) for c in self._chunks)
        if self._since_update < self.update_samples or total < self.engine.feat_cfg.n_fft:
            return None
        self._since_update = 0
        emg = np.concatenate(self._chunks, axis=0)
        self.hypothesis = self.engine.transcribe([emg])[0]
        return self.hypothesis

    def finish(self) -> str:
        """Final hypothesis over the complete stream."""
        if self._chunks:
            emg = np.concatenate(self._chunks, axis=0)
            if len(emg) >= self.engine.feat_cfg.n_fft:
                self.hypothesis = self.engine.transcribe([emg])[0]
        return self.hypothesis

    def reset(self) -> None:
        self._chunks.clear()
        self._since_update = 0
        self.hypothesis = ""
