"""Host prefix beam search with in-search LM fusion.

pyctcdecode-equivalent decoder for LM-fused decoding (reference
``src/decoding/ctc.py:47-99``): character prefix beam search where a
word-level n-gram LM scores each completed word the moment a space is
emitted, with ``alpha`` (LM weight, natural-log domain like pyctcdecode's
``alpha * log10(p) * ln10``) and ``beta`` (per-word bonus). The no-LM path
uses the batched search on the tensors' device
(:mod:`ssd_tpu_torch.ops.ctc_decode`), and LM fusion has its own device
search (:mod:`ssd_tpu_torch.decoding.device_lm`); this host search is the
oracle both are tested against, and the decoder the factory builds for
``host_lm=True`` (the eval CLI's ``--lm-backend host``).

Semantics shared with the device search: pad mass merged into blank,
``blank_bias``, ``token_min_logp`` admission (argmax always admitted),
per-step ``beam_prune_logp`` relative pruning, duplicate-prefix
log-sum-exp merging.

This is the port's own copy of ``ssd_tpu/decoding/host_beam.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.decoding.lm import NGramLM

LN10 = math.log(10.0)
NEG_INF = -np.inf


@dataclass
class _Beam:
    prefix: Tuple[int, ...]
    p_b: float  # log prob of paths ending in blank
    p_nb: float  # log prob of paths ending in non-blank
    lm_score: float  # accumulated fused LM contribution (natural log)
    words: Tuple[str, ...]  # completed words (LM context)
    partial: str  # current partial word

    @property
    def score(self) -> float:
        return np.logaddexp(self.p_b, self.p_nb) + self.lm_score


def _lm_word_score(lm: NGramLM, context: Sequence[str], word: str, alpha: float, beta: float) -> float:
    return alpha * lm.score_word(list(context), word) * LN10 + beta


def beam_search_lm(
    log_probs: np.ndarray,
    length: int,
    vocab: Vocab,
    lm: Optional[NGramLM],
    beam_width: int = 50,
    alpha: float = 0.5,
    beta: float = 0.0,
    beam_prune_logp: float = -10.0,
    token_min_logp: float = -5.0,
    blank_bias: float = 0.0,
) -> str:
    """Decode one utterance ``(T, V)`` with fused LM scoring; returns text."""
    blank, pad = vocab.blank_id, vocab.pad_id
    space = vocab.token_to_id.get(" ")
    lp = np.array(log_probs[:length], dtype=np.float64)
    lp[:, blank] += blank_bias
    if pad != blank:
        lp[:, blank] = np.logaddexp(lp[:, blank], lp[:, pad])

    beams: Dict[Tuple[int, ...], _Beam] = {
        (): _Beam((), 0.0, NEG_INF, 0.0, (), "")
    }

    for t in range(lp.shape[0]):
        col = lp[t]
        argmax_v = int(col.argmax())
        cand: Dict[Tuple[int, ...], _Beam] = {}

        def merge(prefix, p_b, p_nb, lm_score, words, partial):
            old = cand.get(prefix)
            if old is None:
                cand[prefix] = _Beam(prefix, p_b, p_nb, lm_score, words, partial)
            else:
                # identical prefixes always share identical LM state
                old.p_b = np.logaddexp(old.p_b, p_b)
                old.p_nb = np.logaddexp(old.p_nb, p_nb)

        for beam in beams.values():
            p_tot = np.logaddexp(beam.p_b, beam.p_nb)
            for v in range(lp.shape[1]):
                l = col[v]
                if l < token_min_logp and v != argmax_v:
                    continue
                if v == pad and v != blank:
                    continue
                if v == blank:
                    merge(
                        beam.prefix, p_tot + l, NEG_INF,
                        beam.lm_score, beam.words, beam.partial,
                    )
                    continue
                last = beam.prefix[-1] if beam.prefix else None
                if v == last:
                    # repeat collapses into the same prefix…
                    merge(
                        beam.prefix, NEG_INF, beam.p_nb + l,
                        beam.lm_score, beam.words, beam.partial,
                    )
                    # …and a blank-separated repeat extends it
                    base = beam.p_b
                else:
                    base = p_tot
                new_prefix = beam.prefix + (v,)
                lm_score, words, partial = beam.lm_score, beam.words, beam.partial
                if lm is not None and space is not None and v == space:
                    if partial:
                        lm_score = lm_score + _lm_word_score(lm, words, partial, alpha, beta)
                        words = words + (partial,)
                    partial = ""
                elif lm is not None:
                    partial = partial + vocab.tokens[v]
                merge(new_prefix, NEG_INF, base + l, lm_score, words, partial)

        scored = sorted(cand.values(), key=lambda b: -b.score)[:beam_width]
        if not scored:
            break
        best = scored[0].score
        beams = {
            b.prefix: b for b in scored if b.score >= best + beam_prune_logp
        }

    # close the final partial word (pyctcdecode scores it at finalization)
    def final_score(b: _Beam) -> float:
        s = b.score
        if lm is not None and b.partial:
            s += _lm_word_score(lm, b.words, b.partial, alpha, beta)
        return s

    best_beam = max(beams.values(), key=final_score)
    return vocab.decode(best_beam.prefix)


def beam_search_lm_batch(
    log_probs: np.ndarray,
    lengths: np.ndarray,
    vocab: Vocab,
    lm: Optional[NGramLM],
    **kwargs,
) -> List[str]:
    return [
        beam_search_lm(log_probs[i], int(lengths[i]), vocab, lm, **kwargs)
        for i in range(log_probs.shape[0])
    ]
