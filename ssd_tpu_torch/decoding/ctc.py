"""Decoder factory: greedy and beam CTC decoding (PyTorch port of
``ssd_tpu/decoding/ctc.py``).

The factory returns a ``DecoderFn(log_probs, lengths) -> List[str]``
closure with the JAX factory's knobs and defaults: ``beam_width``, ``alpha``
(LM weight), ``beta`` (word bonus), ``beam_prune_logp``, ``blank_bias``,
``token_min_logp`` and ``token_top_k``. The search runs on the log-probs'
own device (:mod:`ssd_tpu_torch.ops.ctc_decode`); only the tokens or the
backpointers come to the host, where the strings are built.

With an ARPA ``lm_path`` the beam search fuses a word n-gram LM: by
default on the log-probs' device (:mod:`ssd_tpu_torch.decoding.device_lm`,
the LM packed into a hash table, cached beside the ARPA as
``<name>.packed.npz``), or with ``host_lm=True`` through the host prefix
search (:mod:`ssd_tpu_torch.decoding.host_beam`), the oracle. A CUDA tensor
is searched on the card unless the caller asks for the host search. An
``lm_path`` that does not exist is skipped with a warning and the beam
decodes without an LM, as the JAX factory does (orchestrated grids run
before their LM stage exists). Without an LM, ``alpha``, ``beta`` and
``host_lm`` change nothing. The beam decoder's ``has_lm`` says whether it
fuses one.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.decoding.device_lm import beam_decode_lm_device, load_packed_lm
from ssd_tpu_torch.decoding.host_beam import beam_search_lm_batch
from ssd_tpu_torch.decoding.lm import NGramLM
from ssd_tpu_torch.ops.ctc_decode import beam_search, greedy_decode, traceback

logger = logging.getLogger(__name__)

# (log_probs (B, T, V), lengths (B,)) — torch tensors or numpy arrays — → texts
DecoderFn = Callable[[torch.Tensor, torch.Tensor], List[str]]


def _tensors(log_probs, lengths):
    """Both as tensors on the log-probs' device (numpy goes to the CPU)."""
    log_probs = torch.as_tensor(log_probs)
    return log_probs, torch.as_tensor(lengths, device=log_probs.device)


def build_greedy_decoder(vocab: Vocab, blank_bias: float = 0.0) -> DecoderFn:
    @torch.inference_mode()
    def decode(log_probs, lengths) -> List[str]:
        log_probs, lengths = _tensors(log_probs, lengths)
        toks, counts = greedy_decode(
            log_probs, lengths, blank_id=vocab.blank_id, pad_id=vocab.pad_id,
            blank_bias=blank_bias,
        )
        toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
        return [vocab.decode(toks[i, : counts[i]]) for i in range(toks.shape[0])]

    return decode


def build_beam_decoder(
    vocab: Vocab,
    lm_path: Optional[Path] = None,
    beam_width: int = 50,
    alpha: float = 0.6,
    beta: float = 0.0,
    beam_prune_logp: float = -10.0,
    blank_bias: float = 0.0,
    token_min_logp: float = -5.0,
    token_top_k: Optional[int] = None,
    host_lm: bool = False,
) -> DecoderFn:
    lm = None
    lm_table = None
    if lm_path is not None:
        if Path(lm_path).exists():
            if host_lm:
                lm = NGramLM.from_arpa(Path(lm_path))
            else:
                # the sidecar-cached packed table: parse, hash and pack once
                # per (file, vocab, format), np.load afterwards
                lm_table = load_packed_lm(Path(lm_path), vocab)
        else:
            logger.warning("LM path %s does not exist — beam decoding WITHOUT LM", lm_path)

    @torch.inference_mode()
    def decode(log_probs, lengths) -> List[str]:
        log_probs, lengths = _tensors(log_probs, lengths)
        if lm_table is not None:
            return beam_decode_lm_device(
                log_probs,
                lengths,
                vocab,
                lm_table,
                beam_width=beam_width,
                alpha=alpha,
                beta=beta,
                beam_prune_logp=beam_prune_logp,
                token_min_logp=token_min_logp,
                blank_bias=blank_bias,
                token_top_k=token_top_k,
            )
        if lm is not None:
            return beam_search_lm_batch(
                log_probs.cpu().numpy(),
                lengths.cpu().numpy(),
                vocab,
                lm,
                beam_width=beam_width,
                alpha=alpha,
                beta=beta,
                beam_prune_logp=beam_prune_logp,
                token_min_logp=token_min_logp,
                blank_bias=blank_bias,
            )
        chars, parents, _ = beam_search(
            log_probs,
            lengths,
            blank_id=vocab.blank_id,
            pad_id=vocab.pad_id,
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            blank_bias=blank_bias,
            token_top_k=token_top_k,
        )
        prefixes = traceback(np.asarray(chars.cpu()), np.asarray(parents.cpu()), 0)
        return [vocab.decode(p) for p in prefixes]

    decode.has_lm = lm is not None or lm_table is not None
    return decode


def build_decoder(
    method: str,
    vocab: Vocab,
    lm_path: Optional[Path] = None,
    beam_width: int = 50,
    alpha: float = 0.6,
    beta: float = 0.0,
    beam_prune_logp: float = -10.0,
    blank_bias: float = 0.0,
    token_top_k: Optional[int] = None,
    host_lm: bool = False,
) -> DecoderFn:
    """``method`` "beam" → :func:`build_beam_decoder`, anything else →
    :func:`build_greedy_decoder`, as the JAX factory.

    ``token_top_k`` restricts each frame's extension candidates to its top-k
    tokens — exact whenever ≤ k tokens pass the ``token_min_logp``
    admission; None keeps the exact all-token sort. ``host_lm`` decodes
    with the host LM search (the oracle) instead of the device one.
    """
    if method.lower() == "beam":
        return build_beam_decoder(
            vocab=vocab,
            lm_path=lm_path,
            beam_width=beam_width,
            alpha=alpha,
            beta=beta,
            beam_prune_logp=beam_prune_logp,
            blank_bias=blank_bias,
            token_top_k=token_top_k,
            host_lm=host_lm,
        )
    return build_greedy_decoder(vocab, blank_bias=blank_bias)
