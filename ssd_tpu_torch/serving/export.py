"""Serving artifact: checkpoint → one ``torch.export`` program per bucket
(PyTorch port of ``ssd_tpu/serving/export.py``).

Packages the whole raw-EMG → token pipeline (the log-mel core, the
Conformer encoder, the CTC head and the greedy decode) as
``torch.export`` programs, one per (batch, samples) bucket, padded as the
engine pads, so that a serving fleet runs it without the model code or the
checkpoint restore path:

    python -m ssd_tpu_torch.serving.export --checkpoint results/checkpoints/run/best \\
        --out results/export/run [--device cuda]
    ...
    t = ExportedTranscriber.load("results/export/run", device="cuda")
    texts = t.transcribe([emg])          # raw (samples, 8) float arrays

Artifact layout:

    manifest.json          buckets, channels, platform, versions
    vocab.json             the checkpoint's vocab (decoding ends on the host)
    fn_b{B}_l{L}.pt2       the exported program of each bucket

Notes:

* The port's kernels sit in the graph as its custom ops
  (``ssd_tpu_torch::logmel_core``, ``::attention_fwd``, ``::depthwise_fwd``;
  the last two under ``attention_impl: fused`` / ``depthwise_impl:
  pallas``), as the JAX artifact embeds its Pallas kernel as a Mosaic
  custom call. So, where the JAX artifact needs no model code at all, the
  port's needs the three modules that register those ops
  (``ssd_tpu_torch/ops/featurizer.py``, ``attention.py``,
  ``depthwise_conv.py``): :meth:`ExportedTranscriber.load` imports them,
  and nothing of the models or the checkpoint code.
* An export is platform-locked: tracing bakes the device into the graph
  (``torch.arange(..., device=...)`` and the weights). The manifest names
  the platform and ``load`` refuses any other. Export on the card to serve
  on the card.
* Greedy decoding only: beam search needs the host traceback of its
  backpointers, so beam deployments serve through
  ``ssd_tpu_torch.serving.server``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssd_tpu_torch.data.vocab import Vocab
# the custom ops an exported graph calls; importing these modules registers them
from ssd_tpu_torch.ops import attention as _attention  # noqa: F401
from ssd_tpu_torch.ops import depthwise_conv as _depthwise_conv  # noqa: F401
from ssd_tpu_torch.ops import featurizer as _featurizer  # noqa: F401
from ssd_tpu_torch.ops.ctc_decode import greedy_decode
from ssd_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_MANIFEST = "manifest.json"
FORMAT = "ssd_tpu_torch.torch_export.v1"
# the engine's raw-sample padding granularity (serving/engine.py's
# SAMPLE_BUCKET), kept here so that loading imports no engine code
SAMPLE_BUCKET = 2560


class BucketProgram(torch.nn.Module):
    """What one bucket exports: the engine's tensor-in pipeline, then
    ``greedy_decode`` → ``(tokens (B, T') int32, counts (B,) int32)``."""

    def __init__(self, engine, blank_bias: float) -> None:
        super().__init__()
        self.model = engine.model  # the weights, as the program's parameters
        self._pipeline = engine.pipeline
        self.blank_id, self.pad_id = engine.vocab.blank_id, engine.vocab.pad_id
        self.blank_bias = float(blank_bias)

    def forward(self, emg: torch.Tensor, sample_lengths: torch.Tensor):
        log_probs, out_lengths = self._pipeline(emg, sample_lengths)
        return greedy_decode(log_probs, out_lengths, blank_id=self.blank_id,
                             pad_id=self.pad_id, blank_bias=self.blank_bias)


def export_checkpoint(
    ckpt_path: Path,
    out_dir: Path,
    batch_sizes: Sequence[int] = (1, 8),
    sample_lengths: Sequence[int] = (SAMPLE_BUCKET, 4 * SAMPLE_BUCKET),
    vocab_path: Optional[Path] = None,
    blank_bias: float = 0.0,
    quantize: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> Path:
    """Export one program per (batch, samples) bucket on ``device`` (the
    card unless the caller asks for the CPU; a missing card raises).
    ``quantize`` (``int8`` / ``int8_prequant``) exports the engine's
    quantized forward: on the card each graph holds ``aten._int_mm`` and,
    under ``int8_prequant``, the int8 weights and their scales as buffers;
    the manifest records it."""
    from ssd_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine.from_checkpoint(
        Path(ckpt_path), vocab_path=vocab_path, decoder="greedy", quantize=quantize,
        device=device,
    )
    for p in engine.model.parameters():
        p.requires_grad_(False)  # an inference graph: no autograd in the trace
    channels = int(engine.cfg["model"]["encoder"]["input_dim"]) // engine.feat_cfg.n_mels
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    program = BucketProgram(engine, blank_bias).eval()
    buckets: List[Dict] = []
    for b in batch_sizes:
        for L in sample_lengths:
            args = (torch.zeros((b, int(L), channels), dtype=torch.float32, device=engine.device),
                    torch.full((b,), int(L), dtype=torch.int32, device=engine.device))
            t0 = time.perf_counter()
            exported = torch.export.export(program, args)
            name = f"fn_b{b}_l{int(L)}.pt2"
            torch.export.save(exported, out_dir / name)
            seconds = time.perf_counter() - t0
            buckets.append({"batch": int(b), "samples": int(L), "file": name,
                            "export_seconds": seconds})
            logger.info("exported %s on %s in %.2f s", name, engine.device, seconds)

    engine.vocab.to_json(out_dir / "vocab.json")
    manifest = {
        "format": FORMAT,
        "channels": channels,
        "sample_bucket": SAMPLE_BUCKET,
        "blank_bias": blank_bias,
        "buckets": buckets,
        "platforms": [engine.device.type],
        "torch_version": torch.__version__,
        "checkpoint": str(ckpt_path),
        "decoder": "greedy",
        "quantize": engine.cfg["model"]["encoder"].get("quantize", "none"),
    }
    (out_dir / _MANIFEST).write_text(json.dumps(manifest, indent=2))
    logger.info("wrote %s (%d buckets)", out_dir / _MANIFEST, len(buckets))
    return out_dir


class ExportedTranscriber:
    """Serve from an exported artifact directory: no model or checkpoint
    code, only the op registrations."""

    def __init__(self, manifest: Dict, fns: Dict[Tuple[int, int], torch.nn.Module],
                 vocab: Vocab, device: torch.device):
        self.manifest = manifest
        self._fns = fns
        self.vocab = vocab
        self.device = device
        self._batches = sorted({b for b, _ in fns})
        self._lengths = sorted({n for _, n in fns})

    @classmethod
    def load(cls, path: Path, device: str | torch.device = "cuda") -> "ExportedTranscriber":
        """Load every bucket's program to run on ``device`` (the card
        unless the caller asks for the CPU; a missing card raises)."""
        path = Path(path)
        manifest = json.loads((path / _MANIFEST).read_text())
        platforms = manifest.get("platforms") or []
        dev = resolve_device(device)
        if dev.type not in platforms:
            raise RuntimeError(
                f"artifact at {path} was exported for platforms {platforms} but is asked to "
                f"run on {dev.type!r}; re-export on the deployment platform (torch.export "
                "artifacts are platform-locked: the device is baked into the graph)"
            )
        fns = {
            (bucket["batch"], bucket["samples"]):
                torch.export.load(path / bucket["file"]).module()
            for bucket in manifest["buckets"]
        }
        return cls(manifest, fns, Vocab.from_json(path / "vocab.json"), dev)

    def _pick_bucket(self, n: int, max_len: int) -> Tuple[int, int]:
        bs = [b for b in self._batches if b >= n]
        ls = [n_ for n_ in self._lengths if n_ >= max_len]
        if not bs or not ls:
            raise ValueError(
                f"no exported bucket fits batch={n}, samples={max_len}; "
                f"have batches {self._batches}, lengths {self._lengths}"
            )
        return bs[0], ls[0]

    def call(self, emg_arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Pad the requests into the smallest bucket that fits and run its
        program → ``(tokens, counts)`` on the host, one row per request."""
        channels = self.manifest["channels"]
        n = len(emg_arrays)
        b, L = self._pick_bucket(n, max(a.shape[0] for a in emg_arrays))
        batch = np.zeros((b, L, channels), np.float32)
        lengths = np.zeros((b,), np.int32)
        for i, a in enumerate(emg_arrays):
            if a.ndim != 2 or a.shape[1] != channels:
                raise ValueError(f"expected (samples, {channels}) arrays, got {a.shape}")
            batch[i, : a.shape[0]] = a
            lengths[i] = a.shape[0]
        with torch.no_grad():
            tokens, counts = self._fns[(b, L)](
                torch.from_numpy(batch).to(self.device), torch.from_numpy(lengths).to(self.device)
            )
        return tokens[:n].cpu().numpy(), counts[:n].cpu().numpy()

    def transcribe(self, emg_arrays: Sequence[np.ndarray]) -> List[str]:
        tokens, counts = self.call(emg_arrays)
        return [self.vocab.decode(tokens[i, : counts[i]]) for i in range(len(tokens))]


def build_parser() -> argparse.ArgumentParser:
    """The JAX exporter's flags, plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True, type=Path)
    p.add_argument("--out", required=True, type=Path)
    p.add_argument("--vocab", type=Path, default=None)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 8])
    p.add_argument(
        "--sample-lengths", type=int, nargs="+", default=[SAMPLE_BUCKET, 4 * SAMPLE_BUCKET],
        help=f"raw-sample buckets (engine convention: multiples of {SAMPLE_BUCKET})",
    )
    p.add_argument("--blank-bias", type=float, default=0.0)
    p.add_argument("--quantize", choices=["none", "int8", "int8_prequant"], default=None,
                   help="Quantize the exported forward (int8_prequant embeds int8 weights "
                   "and per-channel scales; int8 quantizes them in the graph).")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu: the artifact's platform.")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ssd_tpu_torch.utils.config import setup_cli_logging

    setup_cli_logging()
    args = build_parser().parse_args(argv)
    export_checkpoint(
        args.checkpoint, args.out,
        batch_sizes=args.batch_sizes, sample_lengths=args.sample_lengths,
        vocab_path=args.vocab, blank_bias=args.blank_bias,
        quantize=None if args.quantize in (None, "none") else args.quantize,
        device=args.device,
    )


if __name__ == "__main__":
    main()
