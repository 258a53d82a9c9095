"""WER / CER and the word-level error breakdown (the port's own copy of
``ssd_tpu/evaluation/metrics.py``).

Edit distances come from an O(N·M) dynamic program over token lists that
also counts insertions, deletions, substitutions and hits, tie-breaking as
the JAX package does: minimal cost, then maximal hits. It runs in the
port's host library (``ssd_tpu_torch/native/edit_distance.cpp`` through
:mod:`ssd_tpu_torch.utils.native`, tokens hashed to int32 ids here);
:func:`_edit_counts_py` is the same program in Python, the reference the
tests hold it to. Rates pool the counts over the corpus (jiwer's
convention).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ssd_tpu_torch.utils import native

_COUNTS = ("cost", "insertions", "deletions", "substitutions", "hits")
_I32P = ctypes.POINTER(ctypes.c_int32)


def _edit_counts(ref: List[str], hyp: List[str]) -> Dict[str, int]:
    """(cost, ins, del, sub, hits) of ``ref`` → ``hyp``, in the host library."""
    table: Dict[str, int] = {}
    r, h = (np.asarray([table.setdefault(t, len(table)) for t in tokens], dtype=np.int32)
            for tokens in (ref, hyp))
    out = np.zeros(5, dtype=np.int32)
    native.load().edit_distance_counts(r.ctypes.data_as(_I32P), len(r), h.ctypes.data_as(_I32P),
                                       len(h), out.ctypes.data_as(_I32P))
    return dict(zip(_COUNTS, (int(v) for v in out)))


def _edit_counts_py(ref: List[str], hyp: List[str]) -> Dict[str, int]:
    """(cost, ins, del, sub, hits) DP over token lists; two-row rolling."""
    n, m = len(ref), len(hyp)
    # rows of (cost, ins, del, sub, hits); a cell keeps the least cost, then the most hits
    prev: List[Tuple[int, int, int, int, int]] = [(j, j, 0, 0, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0, 0)] + [None] * m  # type: ignore[list-item]
        ri = ref[i - 1]
        for j in range(1, m + 1):
            ins_c, ins_i, ins_d, ins_s, ins_h = cur[j - 1]
            ins_state = (ins_c + 1, ins_i + 1, ins_d, ins_s, ins_h)
            del_c, del_i, del_d, del_s, del_h = prev[j]
            del_state = (del_c + 1, del_i, del_d + 1, del_s, del_h)
            dia_c, dia_i, dia_d, dia_s, dia_h = prev[j - 1]
            if ri == hyp[j - 1]:
                diag_state = (dia_c, dia_i, dia_d, dia_s, dia_h + 1)
            else:
                diag_state = (dia_c + 1, dia_i, dia_d, dia_s + 1, dia_h)
            cur[j] = min((ins_state, del_state, diag_state), key=lambda t: (t[0], -t[4]))
        prev = cur
    return dict(zip(_COUNTS, prev[m]))


def _pooled(pairs) -> Dict[str, int]:
    """The counts summed over (ref tokens, hyp tokens) pairs."""
    totals = dict.fromkeys(_COUNTS, 0)
    for r, h in pairs:
        for k, v in _edit_counts(r, h).items():
            totals[k] += v
    return totals


def _rate(totals: Dict[str, int]) -> float:
    denom = totals["substitutions"] + totals["deletions"] + totals["hits"]
    return totals["cost"] / max(denom, 1)


def wer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus word error rate (pooled counts)."""
    return _rate(_pooled((r.split(), h.split()) for r, h in zip(refs, hyps)))


def cer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus character error rate (pooled counts)."""
    return _rate(_pooled((list(r), list(h)) for r, h in zip(refs, hyps)))


def compute_metrics(refs: Sequence[str], hyps: Sequence[str]) -> Dict[str, float]:
    return {"wer": float(wer(refs, hyps)), "cer": float(cer(refs, hyps))}


def compute_error_breakdown(refs: Sequence[str], hyps: Sequence[str]) -> Dict[str, float]:
    """Word-level insertion / deletion / substitution counts and rates."""
    totals = _pooled((r.split(), h.split()) for r, h in zip(refs, hyps))
    total_words = max(1.0, float(totals["substitutions"] + totals["deletions"] + totals["hits"]))
    return {
        "substitutions": float(totals["substitutions"]),
        "deletions": float(totals["deletions"]),
        "insertions": float(totals["insertions"]),
        "hits": float(totals["hits"]),
        "substitution_rate": totals["substitutions"] / total_words,
        "deletion_rate": totals["deletions"] / total_words,
        "insertion_rate": totals["insertions"] / total_words,
    }
