"""Build an in-domain n-gram LM from normalized transcripts (the port's own
copy of ``ssd_tpu/decoding/build_char_lm.py``, same flags and files).

  python -m ssd_tpu_torch.decoding.build_char_lm --index results/index.jsonl \\
      [--splits voiced_parallel_data] [--subsets train val] [--order 5] \\
      [--output results/lm/char_5gram.arpa] [--skip-kenlm] [--use-kenlm]

Filters the manifest (default voiced train + val), writes the normalized
transcripts as a corpus next to the output (``<output>.txt``), then trains a
5-gram ARPA with the native interpolated Kneser–Ney trainer
(:func:`ssd_tpu_torch.decoding.lm.train_ngram`), or with KenLM's ``lmplz``
under ``--use-kenlm`` when it is on PATH. A ``.jsonl`` index needs nothing
beyond the standard library; a ``.parquet`` one needs pandas.
"""

from __future__ import annotations

import argparse
import logging
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

from ssd_tpu_torch.data.index_dataset import load_index
from ssd_tpu_torch.data.text_normalizer import normalize_transcript
from ssd_tpu_torch.decoding.lm import train_ngram

logger = logging.getLogger(__name__)


def collect_transcripts(
    index_path: Path, splits: Sequence[str], subsets: Sequence[str] | None
) -> List[str]:
    """The normalized, non-empty transcripts of the rows in ``splits`` (and
    ``subsets``, when the manifest has that column), in manifest order."""
    rows = load_index(index_path)
    has_subset = any("subset" in r for r in rows)
    rows = [r for r in rows if r.get("split") in splits]
    if subsets and has_subset:
        rows = [r for r in rows if r.get("subset") in subsets]
    out = [normalize_transcript(r["transcript"]) for r in rows]
    return [t for t in out if t]


def write_corpus(lines: Sequence[str], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", type=Path, default=Path("results/index.parquet"))
    p.add_argument("--splits", nargs="+", default=["voiced_parallel_data"])
    p.add_argument("--subsets", nargs="+", default=["train", "val"])
    p.add_argument("--order", type=int, default=5)
    p.add_argument("--output", type=Path, default=Path("results/lm/char_5gram.arpa"))
    p.add_argument(
        "--skip-kenlm",
        action="store_true",
        help="Only write the corpus; do not train an LM (reference flag).",
    )
    p.add_argument(
        "--use-kenlm",
        action="store_true",
        help="Train with KenLM lmplz if available instead of the native trainer.",
    )
    return p


def main(argv: Optional[List[str]] = None) -> None:
    from ssd_tpu_torch.utils.config import setup_cli_logging

    setup_cli_logging()
    args = build_parser().parse_args(argv)
    transcripts = collect_transcripts(args.index, args.splits, args.subsets)
    if not transcripts:
        raise ValueError("No transcripts after filtering; check splits/subsets.")

    corpus_path = args.output.with_suffix(".txt")
    write_corpus(transcripts, corpus_path)
    logger.info("Wrote %d normalized lines to %s", len(transcripts), corpus_path)

    if args.skip_kenlm:
        logger.info("Skipping LM training (--skip-kenlm).")
        return

    args.output.parent.mkdir(parents=True, exist_ok=True)
    if args.use_kenlm and shutil.which("lmplz"):
        subprocess.run(
            ["lmplz", "-o", str(args.order), "--text", str(corpus_path), "--arpa", str(args.output)],
            check=True,
        )
    else:
        train_ngram(transcripts, order=args.order).to_arpa(args.output)
    logger.info("ARPA LM saved to %s", args.output)


if __name__ == "__main__":
    main()
