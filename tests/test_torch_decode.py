"""Port parity: ``ssd_tpu_torch.ops.ctc_decode`` against
``ssd_tpu.ops.ctc_decode`` on the same log-probs. Decoded text must be
equal; backpointers may differ where ``top_k`` breaks ties differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.ops import ctc_decode as jdec
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.ops import ctc_decode as tdec

torch.set_num_threads(1)

VOCAB = default_vocab()


def _log_probs(B=4, T=40, V=48, seed=0, peak=5.0):
    """Peaked random log-probs with ragged lengths."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    for b in range(B):
        for t in range(T):
            logits[b, t, rng.integers(0, V)] += peak
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    lengths = np.asarray([T, T - 7, T // 2, 3][:B], np.int32)
    return lp, lengths


@pytest.mark.parametrize("blank_bias", [0.0, -1.5])
def test_greedy_matches_jax(blank_bias):
    lp, lengths = _log_probs(seed=1)
    j_toks, j_counts = jdec.greedy_decode(
        jnp.asarray(lp), jnp.asarray(lengths), blank_id=1, pad_id=0, blank_bias=blank_bias
    )
    t_toks, t_counts = tdec.greedy_decode(
        torch.from_numpy(lp), torch.from_numpy(lengths), blank_id=1, pad_id=0, blank_bias=blank_bias
    )
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))


def _beam_texts(mod, lp, lengths, **kw):
    if mod is jdec:
        chars, parents, scores = jdec.beam_search(jnp.asarray(lp), jnp.asarray(lengths), **kw)
    else:
        chars, parents, scores = tdec.beam_search(
            torch.from_numpy(lp), torch.from_numpy(lengths), **kw
        )
    prefixes = mod.traceback(np.asarray(chars), np.asarray(parents), 0)
    return [VOCAB.decode(p) for p in prefixes], np.asarray(scores)


@pytest.mark.parametrize("beam_width", [4, 16])
@pytest.mark.parametrize("token_top_k", [None, 8])
@pytest.mark.parametrize(
    "blank_bias,pad_id", [(0.0, 0), (0.7, 0), (0.0, 1)], ids=["plain", "bias", "pad_is_blank"]
)
def test_beam_text_matches_jax(beam_width, token_top_k, blank_bias, pad_id):
    lp, lengths = _log_probs(seed=beam_width + (token_top_k or 0))
    kw = dict(
        blank_id=1, pad_id=pad_id, beam_width=beam_width,
        blank_bias=blank_bias, token_top_k=token_top_k,
    )
    j_text, j_scores = _beam_texts(jdec, lp, lengths, **kw)
    t_text, t_scores = _beam_texts(tdec, lp, lengths, **kw)
    assert t_text == j_text
    assert any(t_text)  # the peaked inputs decode to real text
    # best-beam scores agree to fp32 rounding of the log-sum-exps
    np.testing.assert_allclose(t_scores[:, 0], j_scores[:, 0], atol=1e-3, rtol=1e-5)


def test_beam_frozen_past_length():
    """Frames past a row's length change nothing: padding the log-probs with
    garbage frames leaves the text as it was."""
    lp, lengths = _log_probs(B=2, T=30, seed=5)
    rng = np.random.default_rng(9)
    wide = np.concatenate([lp, np.log(rng.dirichlet(np.ones(48), size=(2, 10))).astype(np.float32)], 1)
    kw = dict(blank_id=1, pad_id=0, beam_width=8)
    assert _beam_texts(tdec, lp, lengths, **kw)[0] == _beam_texts(tdec, wide, lengths, **kw)[0]
