"""Offline feature preprocessing CLI: EMG log-mels and WavLM teacher states
(PyTorch port of ``ssd_tpu/data/preprocessing.py``).

  python -m ssd_tpu_torch.data.preprocessing --mode emg --index results/index.jsonl \\
      --root data/emg_data --out results/features/emg [--device cuda|cpu]
  python -m ssd_tpu_torch.data.preprocessing --mode teacher --index results/index.jsonl \\
      --root data/emg_data --out results/features/teacher \\
      --teacher-model path/to/wavlm-base-plus.safetensors

The cache contract is the JAX package's: ``<utterance_id>.npy`` (float32)
and ``<utterance_id>.json`` metadata, existing files skipped unless
``--overwrite``. Work is length-sorted and batched: EMG batches are padded
to ``SAMPLE_BUCKET`` multiples and featurized by the port's
``logmel_batch`` (on the card, one launch of the CUDA log-mel kernel a
batch); teacher batches run :meth:`WavLMTeacher.extract_batch` on 1 s
sample buckets. Both run on the card unless ``--device cpu`` is given.

``--fetch-dtype bfloat16`` rounds the features to bf16 on the device,
halving the device → host bytes; the files stay float32. Double buffering
(off with ``--no-double-buffer``) copies each batch's features into pinned
host memory with ``non_blocking`` copies behind an event and writes them
out only after the next batch's compute is queued; the files are
bit-identical either way. ``--no-fused`` is accepted for the JAX CLI's
launch lines and not honoured: the card always runs the kernel.

The reference CLI's defaults (n_fft=400, hop=160) are kept; the training
configs pass 320/10.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ssd_tpu_torch.data.index_dataset import load_index
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig, logmel_batch
from ssd_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

SAMPLE_BUCKET = 2560  # raw-sample padding granularity (256 frames at hop 10)
TEACHER_SAMPLE_BUCKET = 16000  # 1 s at 16 kHz


def _out_paths(out_dir: Path, utterance_id: str) -> tuple[Path, Path]:
    feature_path = out_dir / f"{utterance_id}.npy"
    meta_path = out_dir / f"{utterance_id}.json"
    feature_path.parent.mkdir(parents=True, exist_ok=True)
    return feature_path, meta_path


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _work_list(rows: List[Dict[str, Any]], root: Path, out_dir: Path, path_key: str,
               overwrite: bool, limit: Optional[int]) -> List[tuple]:
    """Eligible (row, source path) pairs: the first ``limit`` in manifest
    order, then sorted by source file size (a duration proxy), so each
    padded batch is near-homogeneous."""
    work = []
    for row in rows:
        if limit and len(work) >= limit:
            break
        feature_path, _ = _out_paths(out_dir, row["utterance_id"])
        if feature_path.exists() and not overwrite:
            continue
        rel = row.get(path_key)
        if rel is None or not isinstance(rel, str):
            logger.debug("Skipping (no %s) %s", path_key, row["utterance_id"])
            continue
        src = root / rel
        if not src.exists():
            logger.warning("Missing %s for %s: %s", path_key, row["utterance_id"], src)
            continue
        work.append((row, src))
    work.sort(key=lambda rs: rs[1].stat().st_size)
    return work


# ---------------------------------------------------------------- EMG mode


class _Fetch:
    """One batch's features on their way to the host: ``non_blocking``
    copies into pinned buffers (on the card) and the event after them."""

    def __init__(self, rows, feats: torch.Tensor, frame_lengths: np.ndarray,
                 means: torch.Tensor, stds: torch.Tensor):
        self.rows, self.frame_lengths = rows, frame_lengths
        pin = feats.is_cuda
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in (feats, means, stds)]
        for dst, src in zip(self.host, (feats, means, stds)):
            dst.copy_(src, non_blocking=pin)
        self.event = None
        if pin:
            self.event = torch.cuda.Event()
            self.event.record()

    def result(self):
        if self.event is not None:
            self.event.synchronize()
        feats, means, stds = self.host
        return feats.float().numpy(), means.numpy(), stds.numpy()


def process_emg_rows(
    rows: List[Dict[str, Any]],
    root: Path,
    out_dir: Path,
    cfg: FeaturizerConfig,
    overwrite: bool,
    batch_size: int = 8,
    limit: Optional[int] = None,
    fetch_dtype: str = "float32",
    double_buffer: bool = True,
    device: str | torch.device = "cuda",
) -> int:
    """Featurize the manifest rows' EMG; returns the number written."""
    if fetch_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"fetch_dtype={fetch_dtype!r}")
    dev = resolve_device(device)
    pending: List[tuple] = []  # (row, emg array)
    inflight: Optional[_Fetch] = None
    written = 0

    def write_out(fetch: _Fetch) -> int:
        feats, means, stds = fetch.result()
        for i, row in enumerate(fetch.rows):
            out = feats[i, : int(fetch.frame_lengths[i])]
            feature_path, meta_path = _out_paths(out_dir, row["utterance_id"])
            np.save(feature_path, out)
            meta = {
                "utterance_id": row["utterance_id"],
                "frames": int(out.shape[0]),
                "channels": int(out.shape[1]),
                "n_mels": int(out.shape[2]),
                "sample_rate": cfg.sample_rate,
                "n_fft": cfg.n_fft,
                "hop_length": cfg.hop_length,
                "fmin": cfg.fmin,
                "fmax": cfg.fmax,
                "normalize": cfg.normalize,
            }
            if cfg.normalize == "per_file":
                meta["mean"] = float(means[i])
                meta["std"] = float(stds[i])
            meta_path.write_text(json.dumps(meta, indent=2))
        return len(fetch.rows)

    def flush() -> int:
        nonlocal pending, inflight
        if not pending:
            return 0
        lengths = np.asarray([e.shape[0] for _, e in pending], np.int32)
        L_pad = _round_up(int(lengths.max()), SAMPLE_BUCKET)
        batch = np.zeros((len(pending), L_pad, pending[0][1].shape[1]), np.float32)
        for i, (_, e) in enumerate(pending):
            batch[i, : e.shape[0]] = e
        feats, _, means, stds = logmel_batch(torch.from_numpy(batch).to(dev),
                                             torch.from_numpy(lengths).to(dev), cfg)
        # frame counts from the host's sample counts: no wait on the device
        frame_lengths = np.clip(1 + (lengths - cfg.n_fft) // cfg.hop_length, 0,
                                cfg.frame_count(L_pad)).astype(np.int32)
        feats = feats[:, : int(frame_lengths.max())]
        if fetch_dtype == "bfloat16":
            feats = feats.to(torch.bfloat16)  # rounded on the device
        fetch = _Fetch([row for row, _ in pending], feats, frame_lengths, means, stds)
        pending = []
        if not double_buffer:
            return write_out(fetch)
        # write the previous batch while this one's compute and copy run
        count = write_out(inflight) if inflight is not None else 0
        inflight = fetch
        return count

    with torch.inference_mode():
        for row, src in _work_list(rows, root, out_dir, "emg_path", overwrite, limit):
            emg = np.load(src)
            if emg.ndim != 2:
                logger.warning("Unexpected EMG shape %s for %s", emg.shape, src)
                continue
            if emg.shape[0] < cfg.n_fft:
                logger.warning("EMG too short (%d < n_fft) for %s", emg.shape[0], src)
                continue
            pending.append((row, emg.astype(np.float32)))
            if len(pending) >= batch_size:
                written += flush()
        written += flush()
        if inflight is not None:  # drain the double buffer's tail
            written += write_out(inflight)
    logger.info("EMG processed: %d", written)
    return written


# ------------------------------------------------------------ teacher mode


def process_teacher_rows(
    rows: List[Dict[str, Any]],
    root: Path,
    out_dir: Path,
    model_name: str,
    layer: int,
    sample_rate: int,
    overwrite: bool,
    limit: Optional[int] = None,
    batch_size: int = 8,
    teacher=None,
    device: str | torch.device = "cuda",
) -> int:
    """WavLM layer-``layer`` states of the rows with audio, batched on
    sample buckets; returns the number written. ``teacher`` injects a
    built :class:`~ssd_tpu_torch.models.wavlm.WavLMTeacher` (weights kept
    on the device across calls); by default ``model_name`` is loaded, a
    local ``.safetensors`` file or a directory holding one."""
    from ssd_tpu_torch.data.audio import load_audio
    from ssd_tpu_torch.models.wavlm import WavLMTeacher

    if teacher is None:
        teacher = WavLMTeacher.from_pretrained(model_name, layer=layer, device=device)
    written = 0
    pending: List[tuple] = []  # (row, waveform)

    def flush() -> int:
        nonlocal pending
        if not pending:
            return 0
        feats_list = teacher.extract_batch([w for _, w in pending],
                                           sample_bucket=TEACHER_SAMPLE_BUCKET)
        for (row, _), feats in zip(pending, feats_list):
            feature_path, meta_path = _out_paths(out_dir, row["utterance_id"])
            np.save(feature_path, feats)
            meta = {
                "utterance_id": row["utterance_id"],
                "frames": int(feats.shape[0]),
                "dim": int(feats.shape[1]),
                "layer": layer,
                "model_name": model_name,
                "sample_rate": sample_rate,
                "frame_stride_sec": 0.02,  # the WavLM conv stack's stride
            }
            meta_path.write_text(json.dumps(meta, indent=2))
        count, pending = len(pending), []
        return count

    for row, src in _work_list(rows, root, out_dir, "audio_path", overwrite, limit):
        pending.append((row, load_audio(src, target_sr=sample_rate)))
        if len(pending) >= batch_size:
            written += flush()
    written += flush()
    logger.info("Teacher processed: %d", written)
    return written


# -------------------------------------------------------------------- CLI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["emg", "teacher"], required=True)
    p.add_argument("--index", type=Path, required=True)
    p.add_argument("--root", type=Path, default=Path("data/emg_data"))
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--limit", type=int)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-fused", action="store_true",
                   help="Accepted and not honoured: the card always runs the log-mel kernel.")

    p.add_argument("--emg-sample-rate", type=int, default=1000)
    p.add_argument("--emg-n-fft", type=int, default=400)
    p.add_argument("--emg-hop-length", type=int, default=160)
    p.add_argument("--emg-n-mels", type=int, default=80)
    p.add_argument("--emg-normalize", choices=["per_file", "none"], default="per_file")
    p.add_argument(
        "--fetch-dtype", choices=["float32", "bfloat16"], default="float32",
        help="Device→host transfer dtype for EMG features (bfloat16 halves the fetch "
        "bytes; the .npy files stay float32 either way).",
    )
    p.add_argument(
        "--no-double-buffer", action="store_true",
        help="Write each batch out before the next batch's compute is queued (the "
        "files are identical).",
    )

    p.add_argument("--teacher-model", default="microsoft/wavlm-base-plus",
                   help="A local .safetensors file, or a directory holding one.")
    p.add_argument("--teacher-layer", type=int, default=9)
    p.add_argument("--teacher-sample-rate", type=int, default=16000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu.")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    from ssd_tpu_torch.utils.config import setup_cli_logging

    setup_cli_logging()
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # a missing card raises before any work
    if args.no_fused:
        logger.info("--no-fused is not honoured: the log-mel kernel always runs on the card")
    rows = load_index(args.index)
    root = args.root.expanduser().resolve()
    out_dir = args.out.expanduser()

    if args.mode == "emg":
        cfg = FeaturizerConfig(
            sample_rate=args.emg_sample_rate,
            n_fft=args.emg_n_fft,
            hop_length=args.emg_hop_length,
            n_mels=args.emg_n_mels,
            normalize=args.emg_normalize,
        )
        process_emg_rows(
            rows, root, out_dir, cfg,
            overwrite=args.overwrite,
            batch_size=args.batch_size,
            limit=args.limit,
            fetch_dtype=args.fetch_dtype,
            double_buffer=not args.no_double_buffer,
            device=args.device,
        )
    else:
        process_teacher_rows(
            rows, root, out_dir,
            model_name=args.teacher_model,
            layer=args.teacher_layer,
            sample_rate=args.teacher_sample_rate,
            overwrite=args.overwrite,
            limit=args.limit,
            batch_size=args.batch_size,
            device=args.device,
        )


if __name__ == "__main__":
    main()
