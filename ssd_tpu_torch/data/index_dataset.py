"""Dataset indexing for the Gaddy & Klein 2020 EMG corpus (PyTorch port's
own copy of ``ssd_tpu/data/index_dataset.py``).

Walks ``<root>/<split dir>/<session>/*_info.json``, drops unusable rows and
writes a 12-column manifest, as the JAX package does:

* the split directory layout (:data:`SPLIT_PATHS`);
* row filters: a missing EMG file, an empty transcript, a negative
  ``sentence_index``;
* ``*_audio_clean.flac`` preferred over ``*_audio.flac``;
* MD5(utterance_id) % 100 → 80/10/10 train/val/test for the voiced and
  silent parallel splits, bit for bit the reference's split; closed-vocab
  splits → ``closed_vocab``, the rest ``unused``.

A manifest is a list of row dicts with the 12 columns of :data:`COLUMNS`
(the JAX package holds a DataFrame). JSONL (one JSON object per line) is
read and written with :mod:`json` alone. Parquet needs ``pandas``, imported
only inside the functions and only for a ``.parquet`` path; where it is
missing they say to use a ``.jsonl`` index.

CLI: ``python -m ssd_tpu_torch.data.index_dataset --root … --out …
[--stats [--durations]] [--overwrite]``, or ``--index … --stats``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

#: logical split name → directory relative to the dataset root
SPLIT_PATHS: Dict[str, str] = {
    "voiced_parallel_data": "voiced_parallel_data",
    "silent_parallel_data": "silent_parallel_data",
    "closed_vocab_voiced": "closed_vocab/voiced",
    "closed_vocab_silent": "closed_vocab/silent",
    "nonparallel_data": "nonparallel_data",
}

DEFAULT_SPLITS: List[str] = [
    "voiced_parallel_data",
    "silent_parallel_data",
    "closed_vocab_voiced",
    "closed_vocab_silent",
]

EMG_SAMPLE_RATE = 1000  # Hz — used for duration stats only

_PARALLEL_SPLITS = frozenset({"voiced_parallel_data", "silent_parallel_data"})

#: manifest columns (``ssd_tpu/data/index_dataset.py:IndexEntry``)
COLUMNS = (
    "utterance_id",
    "split",
    "subset",
    "speaker",
    "stem",
    "emg_path",
    "audio_path",
    "transcript",
    "sentence_index",
    "book",
    "has_audio",
    "metadata_json",
)


def _pandas(path: Path):
    try:
        import pandas as pd
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading or writing a parquet index needs pandas, which is not "
            "installed; use a .jsonl index instead"
        ) from e
    return pd


def save_index(rows: Sequence[Dict[str, Any]], out_path: Path) -> None:
    """Write the manifest as JSONL (``.jsonl``/``.json``) or Parquet."""
    out_path = Path(out_path).expanduser()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    suffix = out_path.suffix.lower()
    if suffix in {".jsonl", ".json"}:
        with out_path.open("w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(dict(row), ensure_ascii=False) + "\n")
    elif suffix == ".parquet":
        _pandas(out_path).DataFrame(list(rows)).to_parquet(out_path, index=False)
    else:
        raise ValueError(f"Unsupported index format: {out_path}")
    logger.info("Wrote %d rows to %s", len(rows), out_path)


def load_index(index_path: Path) -> List[Dict[str, Any]]:
    """Read a manifest into a list of row dicts."""
    index_path = Path(index_path).expanduser()
    if not index_path.exists():
        raise FileNotFoundError(f"Index not found: {index_path}")
    suffix = index_path.suffix.lower()
    if suffix in {".jsonl", ".json"}:
        with index_path.open("r", encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]
    if suffix == ".parquet":
        return _pandas(index_path).read_parquet(index_path).to_dict("records")
    raise ValueError(f"Unsupported index format: {index_path}")


def assign_subset(split: str, utterance_id: str) -> str:
    """Parallel splits: MD5(utterance_id) % 100 → train (< 80), val (< 90),
    test; closed-vocab splits ``closed_vocab``; everything else ``unused``."""
    if split in _PARALLEL_SPLITS:
        h = int(hashlib.md5(utterance_id.encode("utf-8")).hexdigest(), 16) % 100
        if h < 80:
            return "train"
        if h < 90:
            return "val"
        return "test"
    if split.startswith("closed_vocab"):
        return "closed_vocab"
    return "unused"


def _preferred_audio(session_dir: Path, stem: str) -> Optional[Path]:
    for suffix in ("_audio_clean.flac", "_audio.flac"):
        candidate = session_dir / f"{stem}{suffix}"
        if candidate.exists():
            return candidate
    return None


def _entry_from_info(info_path: Path, root: Path, split: str) -> Optional[Dict[str, Any]]:
    with info_path.open("r", encoding="utf-8") as f:
        meta = json.load(f)

    transcript = (meta.get("text") or "").strip()
    sentence_index = meta.get("sentence_index", -1)
    if sentence_index is None or sentence_index < 0 or not transcript:
        return None

    stem = info_path.stem
    if stem.endswith("_info"):
        stem = stem[: -len("_info")]
    emg_path = info_path.with_name(f"{stem}_emg.npy")
    if not emg_path.exists():
        logger.warning("No EMG array next to %s; dropping row", info_path)
        return None

    audio_path = _preferred_audio(info_path.parent, stem)
    speaker = info_path.parent.name
    utterance_id = f"{split}/{speaker}/{stem}"
    return {
        "utterance_id": utterance_id,
        "split": split,
        "subset": assign_subset(split, utterance_id),
        "speaker": speaker,
        "stem": stem,
        "emg_path": str(emg_path.relative_to(root)),
        "audio_path": str(audio_path.relative_to(root)) if audio_path else None,
        "transcript": transcript,
        "sentence_index": int(sentence_index),
        "book": meta.get("book", ""),
        "has_audio": audio_path is not None,
        "metadata_json": json.dumps(meta, sort_keys=True),
    }


def build_index(root: Path, splits: Iterable[str]) -> List[Dict[str, Any]]:
    """Walk the dataset tree: the manifest's rows, sorted by split and
    utterance id (an empty list when nothing is indexed)."""
    root = Path(root).expanduser().resolve()
    rows: List[Dict[str, Any]] = []
    for split in splits:
        if split not in SPLIT_PATHS:
            raise ValueError(f"Unknown split {split!r}; known: {sorted(SPLIT_PATHS)}")
        split_dir = root / SPLIT_PATHS[split]
        if not split_dir.exists():
            logger.warning("Split directory missing: %s", split_dir)
            continue
        for info_path in sorted(split_dir.rglob("*_info.json")):
            row = _entry_from_info(info_path, root, split)
            if row is not None:
                rows.append(row)
    if not rows:
        logger.error("Indexed zero entries under %s", root)
    return sorted(rows, key=lambda r: (r["split"], r["utterance_id"]))


def summarize_index(
    rows: Sequence[Dict[str, Any]],
    root: Optional[Path] = None,
    include_durations: bool = False,
) -> Dict[str, Dict]:
    """Per-split counts, audio availability, subset counts (most frequent
    first) and, with ``include_durations``, the EMG durations."""
    summary: Dict[str, Dict] = {}
    root = Path(root).expanduser().resolve() if root else None
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for row in rows:
        groups.setdefault(row["split"], []).append(row)
    for split in sorted(groups):
        group = groups[split]
        subsets: Dict[str, int] = {}
        for row in group:
            subsets[row["subset"]] = subsets.get(row["subset"], 0) + 1
        stats: Dict = {
            "count": len(group),
            "with_audio": sum(bool(r["has_audio"]) for r in group),
            # pandas' value_counts order: by count, descending, ties as first seen
            "subset_counts": dict(sorted(subsets.items(), key=lambda kv: -kv[1])),
        }
        if include_durations and root is not None:
            durations: List[float] = []
            for row in group:
                p = root / row["emg_path"]
                if not p.exists():
                    logger.warning("EMG file missing during stats: %s", p)
                    continue
                durations.append(np.load(p, mmap_mode="r").shape[0] / EMG_SAMPLE_RATE)
            if durations:
                stats["mean_duration_sec"] = float(np.mean(durations))
                stats["total_hours"] = float(np.sum(durations) / 3600.0)
        summary[str(split)] = stats
    return summary


def _format_summary(summary: Dict[str, Dict]) -> str:
    lines = []
    for split in sorted(summary):
        s = summary[split]
        line = f"{split}: {s['count']} utterances ({s['with_audio']} with audio)"
        if "mean_duration_sec" in s:
            line += (
                f", mean duration {s['mean_duration_sec']:.2f}s,"
                f" total {s['total_hours']:.2f}h"
            )
        lines.append(line)
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", type=Path, help="Dataset root (needed to build).")
    p.add_argument("--out", type=Path, help="Manifest output (.parquet/.jsonl).")
    p.add_argument("--index", type=Path, help="Existing manifest (stats only).")
    p.add_argument(
        "--splits",
        nargs="+",
        default=DEFAULT_SPLITS,
        help=f"Splits to include; choices: {sorted(SPLIT_PATHS)}",
    )
    p.add_argument("--stats", action="store_true", help="Print summary stats.")
    p.add_argument(
        "--durations",
        action="store_true",
        help="With --stats: also compute durations from the EMG arrays.",
    )
    p.add_argument("--overwrite", action="store_true", help="Replace existing output.")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    from ssd_tpu_torch.utils.config import setup_cli_logging

    setup_cli_logging()
    args = build_parser().parse_args(argv)

    rows: Optional[List[Dict[str, Any]]] = None
    if args.out:
        if not args.root:
            raise SystemExit("--root is required when writing an index.")
        out_path = args.out.expanduser()
        if out_path.exists() and not args.overwrite:
            raise SystemExit(f"{out_path} exists; pass --overwrite to replace it.")
        rows = build_index(args.root, args.splits)
        if not rows:
            raise SystemExit("Indexing produced zero entries.")
        save_index(rows, out_path)

    if args.stats:
        if rows is None:
            if not args.index:
                raise SystemExit("Provide --index or --out with --stats.")
            rows = load_index(args.index)
        print(_format_summary(summarize_index(rows, args.root, args.durations)))

    if args.out is None and not args.stats:
        raise SystemExit("Nothing to do: pass --out and/or --stats.")


if __name__ == "__main__":
    main()
