"""Backoff n-gram language model: ARPA IO, scoring, and training.

The reference shells out to KenLM's ``lmplz`` and scores through pyctcdecode
(``src/decoding/build_char_lm.py:35-41``). Neither exists in this stack, so
this module provides all three pieces natively:

* :func:`train_ngram` — interpolated Kneser–Ney n-gram estimation over
  whitespace tokens (lmplz's tokenization: the "char LM" corpus is plain
  sentences, so the model is a word n-gram, matching the reference's actual
  artifact).
* :class:`NGramLM` — ARPA text parser + standard backoff scorer (log10,
  KenLM convention), with ``<s>``/``</s>`` sentence framing and ``<unk>``.
* :meth:`NGramLM.to_arpa` — ARPA writer.

This is the port's own copy of ``ssd_tpu/decoding/lm.py`` (the two packages
share no code); ``tests/test_torch_lm.py`` holds its ARPA text and scores to
the JAX package's.
"""

from __future__ import annotations

import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"
_LOG10_NEG_INF = -99.0


class NGramLM:
    """Backoff n-gram LM over whitespace tokens (log10 scores)."""

    def __init__(
        self,
        order: int,
        logprob: Dict[Tuple[str, ...], float],
        backoff: Dict[Tuple[str, ...], float],
    ) -> None:
        self.order = order
        self.logprob = logprob
        self.backoff = backoff

    # ------------------------------------------------------------- scoring
    def score_word(self, context: Sequence[str], word: str) -> float:
        """log10 P(word | context) with standard backoff recursion."""
        if (word,) not in self.logprob:
            word = UNK
        ctx = tuple(context)[-(self.order - 1) :] if self.order > 1 else ()
        while True:
            ngram = ctx + (word,)
            if ngram in self.logprob:
                return self.logprob[ngram]
            if not ctx:
                return self.logprob.get((word,), _LOG10_NEG_INF)
            penalty = self.backoff.get(ctx, 0.0)
            ctx = ctx[1:]
            if penalty:
                return penalty + self.score_word(ctx, word)

    def score_log10(self, text: str, bos: bool = True, eos: bool = True) -> float:
        """Sentence log10 probability (KenLM ``score`` convention)."""
        words = text.split()
        context: List[str] = [BOS] if bos else []
        total = 0.0
        for w in words:
            total += self.score_word(context, w)
            context.append(w)
        if eos:
            total += self.score_word(context, EOS)
        return total

    # ----------------------------------------------------------------- io
    @classmethod
    def from_arpa(cls, path: Path) -> "NGramLM":
        logprob: Dict[Tuple[str, ...], float] = {}
        backoff: Dict[Tuple[str, ...], float] = {}
        order = 1
        section = 0
        with Path(path).open("r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("\\data\\"):
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    order = max(order, section)
                    continue
                if line.startswith("\\end\\"):
                    break
                if section == 0 or line.startswith("ngram "):
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    parts = [parts[0], " ".join(parts[1 : 1 + section])] + (
                        [parts[1 + section]] if len(parts) > 1 + section else []
                    )
                lp = float(parts[0])
                ngram = tuple(parts[1].split())
                logprob[ngram] = lp
                if len(parts) > 2 and parts[2]:
                    backoff[ngram] = float(parts[2])
        return cls(order, logprob, backoff)

    def to_arpa(self, path: Path) -> None:
        by_order: Dict[int, List[Tuple[Tuple[str, ...], float]]] = defaultdict(list)
        for ngram, lp in self.logprob.items():
            by_order[len(ngram)].append((ngram, lp))
        with Path(path).open("w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for n in range(1, self.order + 1):
                f.write(f"ngram {n}={len(by_order.get(n, []))}\n")
            for n in range(1, self.order + 1):
                f.write(f"\n\\{n}-grams:\n")
                for ngram, lp in sorted(by_order.get(n, [])):
                    bo = self.backoff.get(ngram)
                    tail = f"\t{bo:.7f}" if bo is not None else ""
                    f.write(f"{lp:.7f}\t{' '.join(ngram)}{tail}\n")
            f.write("\n\\end\\\n")


def train_ngram(
    sentences: Iterable[str],
    order: int = 5,
    discount: float = 0.75,
) -> NGramLM:
    """Interpolated Kneser–Ney estimation (fixed discount).

    Replaces ``lmplz`` for the in-domain LM: tiny corpora (~10³ sentences)
    train in milliseconds. Unigram distribution uses continuation counts with
    ``<unk>`` receiving the leftover interpolation mass.
    """
    counts: List[Dict[Tuple[str, ...], int]] = [defaultdict(int) for _ in range(order + 1)]
    for sent in sentences:
        words = [BOS] + sent.split() + [EOS]
        for n in range(1, order + 1):
            for i in range(len(words) - n + 1):
                if n == 1 and words[i] == BOS:
                    continue  # <s> is context-only (KenLM convention)
                counts[n][tuple(words[i : i + n])] += 1

    # continuation counts for the unigram base distribution
    continuation: Dict[str, set] = defaultdict(set)
    for bigram in counts[2]:
        continuation[bigram[1]].add(bigram[0])
    total_continuations = sum(len(v) for v in continuation.values()) or 1

    logprob: Dict[Tuple[str, ...], float] = {}
    backoff: Dict[Tuple[str, ...], float] = {}

    def p_cont(word: str) -> float:
        return len(continuation.get(word, ())) / total_continuations

    vocab = {k[0] for k in counts[1]} | {EOS, UNK}

    # context → distinct-successor type counts (for discounting weights)
    succ_types: List[Dict[Tuple[str, ...], int]] = [defaultdict(int) for _ in range(order + 1)]
    for n in range(2, order + 1):
        for ngram in counts[n]:
            succ_types[n][ngram[:-1]] += 1

    def prob(ngram: Tuple[str, ...]) -> float:
        """Interpolated KN probability P(w | ngram[:-1])."""
        n = len(ngram)
        if n == 1:
            base = p_cont(ngram[0])
            # reserve a small mass for unseen events / <unk>
            return 0.9 * base + 0.1 / max(len(vocab), 1)
        ctx = ngram[:-1]
        ctx_count = counts[n - 1][ctx] if n - 1 >= 1 else 0
        if ctx_count == 0:
            return prob(ngram[1:])
        c = counts[n][ngram]
        lam = discount * succ_types[n].get(ctx, 0) / ctx_count
        return max(c - discount, 0.0) / ctx_count + lam * prob(ngram[1:])

    for n in range(1, order + 1):
        for ngram in counts[n]:
            p = prob(ngram)
            logprob[ngram] = math.log10(max(p, 1e-99))
            if n < order and succ_types[n + 1].get(ngram):
                ctx_total = counts[n][ngram]
                lam = discount * succ_types[n + 1][ngram] / max(ctx_total, 1)
                backoff[ngram] = math.log10(max(lam, 1e-99))

    logprob[(UNK,)] = math.log10(0.1 / max(len(vocab), 1))
    if (BOS,) not in logprob:
        logprob[(BOS,)] = _LOG10_NEG_INF
    return NGramLM(order, logprob, backoff)
