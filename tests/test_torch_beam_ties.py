"""Beam ties: the port's plain and LM-fused beam-50 give the JAX package's
text on flat log-probs, where scores tie exactly at the last beam slot.

On flat log-probs (a barely trained model's) two prefixes often reach the
beam cut with equal fp32 scores (at |score| ≈ 780 the fp32 spacing is
6e-5), so the order of ties decides the text. The JAX search sorts the
candidates by the unsigned hash pair and cuts with ``jax.lax.top_k`` (equal
scores: lower index first); the port must do the same. Inputs are
``scripts/beam_card_vs_cpu.py``'s: seeded normal logits × 0.7 / 1.0 / 1.5,
blank + 1, B = 2, T′ 640 / 560, V = 48. The seeds listed are those where
the two used to part (plain 1, 6, 8; LM 3, 4, 6, 8) and one where they
agreed. The LM is a 5-gram of ``tests/test_device_lm.py``'s CORPUS at
α 0.6, β 0.1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.decoding import device_lm as jdl
from ssd_tpu.decoding.lm import train_ngram as jax_train_ngram
from ssd_tpu.ops import ctc_decode as jdec
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.decoding import device_lm as tdl
from ssd_tpu_torch.decoding.lm import train_ngram
from ssd_tpu_torch.ops import ctc_decode as tdec

from .test_device_lm import CORPUS

torch.set_num_threads(1)

VOCAB = default_vocab()
JVOCAB = jax_default_vocab()
T = 640


def _flat(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, T, VOCAB.size)).astype(np.float32) * (0.7, 1.0, 1.5)[seed % 3]
    logits[:, :, VOCAB.blank_id] += 1.0
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    return lp, np.array([T, T * 7 // 8], np.int32)


@pytest.mark.parametrize("seed", [0, 1, 6, 8])
def test_plain_beam50_text_matches_jax_on_flat_inputs(seed):
    lp, lengths = _flat(seed)
    kw = dict(blank_id=VOCAB.blank_id, pad_id=VOCAB.pad_id, beam_width=50)
    jc, jp, _ = jdec.beam_search(jnp.asarray(lp), jnp.asarray(lengths), **kw)
    tc, tp, _ = tdec.beam_search(torch.from_numpy(lp), torch.from_numpy(lengths), **kw)
    want = [VOCAB.decode(p) for p in jdec.traceback(np.asarray(jc), np.asarray(jp), 0)]
    got = [VOCAB.decode(p) for p in tdec.traceback(tc.numpy(), tp.numpy(), 0)]
    assert got == want


@pytest.fixture(scope="module")
def lm_tables():
    return (jdl.pack_lm(jax_train_ngram(CORPUS, order=5), JVOCAB),
            tdl.pack_lm(train_ngram(CORPUS, order=5), VOCAB))


@pytest.mark.parametrize("seed", [2, 3, 4, 6, 8])
def test_lm_beam50_text_matches_jax_on_flat_inputs(lm_tables, seed):
    lp, lengths = _flat(seed)
    kw = dict(beam_width=50, alpha=0.6, beta=0.1)
    jt, tt = lm_tables
    assert (tdl.beam_decode_lm_device(lp, lengths, VOCAB, tt, **kw)
            == jdl.beam_decode_lm_device(lp, lengths, JVOCAB, jt, **kw))


def test_merge_key_sorts_as_the_unsigned_pair():
    """A hash with h1 ≥ 2³¹ sorts after those below it, as uint32 does."""
    h = torch.tensor([[0, 5], [2**31, 0], [2**31 - 1, 2**32 - 1], [2**32 - 1, 0], [0, 2**32 - 1],
                      [2**31, 2**32 - 1]], dtype=torch.int64)
    order = torch.argsort(tdec.merge_key(h[:, 0], h[:, 1]), stable=True)
    want = np.lexsort((h[:, 1].numpy().astype(np.uint32), h[:, 0].numpy().astype(np.uint32)))
    assert order.tolist() == want.tolist()


def test_top_k_keeps_the_lower_index_first_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0, 2.0, -1e30], [0.0] * 7])
    vals, idx = tdec.top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 5, 0], [0, 1, 2, 3, 4]]
    jv, ji = (np.asarray(a) for a in jdec.jax.lax.top_k(jnp.asarray(x.numpy()), 5))
    assert idx.tolist() == ji.tolist() and np.array_equal(vals.numpy(), jv)


def test_run_logsumexp_is_the_left_to_right_run_sum():
    """The run sum equals, bit for bit, the log of each run's
    exponentials summed left to right (the CPU's scatter-add order) where a
    run holds at most two finite terms — what a prefix search's runs hold —
    and a run of NEG_INF terms stays NEG_INF."""
    rng = np.random.default_rng(3)
    K, B = 50, 3
    lens = [rng.integers(1, K + 1, size=40) for _ in range(B)]
    N = min(sum(map(len, lens)), min(int(x.sum()) for x in lens))
    run_id = torch.stack([torch.repeat_interleave(torch.arange(len(x)), torch.from_numpy(x))[:N]
                          for x in lens])
    vals = torch.full((2, B, N), tdec.NEG_INF)
    for b in range(B):
        for r in range(int(run_id[b, -1]) + 1):
            pos = torch.nonzero(run_id[b] == r)[:, 0]
            finite = pos[torch.from_numpy(rng.permutation(len(pos))[:2])]
            if r % 7:  # every seventh run all NEG_INF
                vals[:, b, finite] = torch.from_numpy(rng.normal(size=(2, len(finite))).astype(
                    np.float32) * 30 - 700)
    got = tdec._run_logsumexp(vals, run_id, K)
    last = torch.cat([run_id[:, 1:] != run_id[:, :-1], torch.ones((B, 1), dtype=torch.bool)], 1)
    for c in range(2):
        for b in range(B):
            for i in torch.nonzero(last[b])[:, 0].tolist():
                run = vals[c, b, run_id[b] == run_id[b, i]]
                m = run.max()
                total = torch.zeros(())
                for e in torch.exp(run - m):
                    total = total + e
                assert torch.equal(got[c, b, i], m + torch.log(total)), (c, b, i)
