"""The dataset manifest: schema, ``load_index`` and ``save_index`` (the
port's own copy of the parts of ``ssd_tpu/data/index_dataset.py`` the
trainer reads).

A manifest is a list of row dicts with the 12 columns of :data:`COLUMNS`.
JSONL (one JSON object per line, what the JAX package writes for a
``.jsonl`` path) is read and written with :mod:`json` alone. Parquet needs
``pandas``, imported only inside the two functions and only for a
``.parquet`` path; where it is missing they say to use a ``.jsonl`` index.
Building an index from the corpus tree (the indexing CLI) is not ported yet.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Sequence

logger = logging.getLogger(__name__)

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
