"""Port parity: ``ssd_tpu_torch.decoding.device_lm`` (the packed LM table,
its lookups and backoff walk, the LM-fused beam search, the sidecar cache)
and the decoder factory's and eval CLI's LM branches against the JAX
package, on the CPU, with the same LMs and log-probs. Bit-equal where the
arithmetic is the same (hashes, packed arrays, lookups, word scores); the
searches' texts equal, their final scores within 1e-4 (the log-sum-exp of a
merged prefix sums in another order)."""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.decoding import ctc as jctc
from ssd_tpu.decoding import device_lm as jdl
from ssd_tpu.decoding.lm import NGramLM as JaxNGramLM
from ssd_tpu.decoding.lm import train_ngram as jax_train_ngram
from ssd_tpu.evaluation import evaluate as jeval
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.decoding import ctc as tctc
from ssd_tpu_torch.decoding import device_lm as tdl
from ssd_tpu_torch.decoding.host_beam import beam_search_lm_batch
from ssd_tpu_torch.decoding.lm import NGramLM, train_ngram
from ssd_tpu_torch.evaluation import evaluate as teval

from .test_device_lm import CORPUS
from .test_torch_evaluation import TEXTS, corpus, quiet  # noqa: F401  (fixtures)

torch.set_num_threads(1)

VOCAB = default_vocab()
JVOCAB = jax_default_vocab()
SPACE = VOCAB.token_to_id[" "]

SCORE_ATOL = 1e-4

# hand-built LMs of tests/test_device_lm.py: one with <unk>-tailed bigrams
# (the generic walk) and one without the <unk> unigram (OOV → −99)
UNK_TAILED = (
    2,
    {("<unk>",): -1.2, ("the",): -0.4, ("cat",): -0.9, ("sat",): -1.0, ("a",): -0.8,
     ("the", "cat"): -0.3, ("the", "<unk>"): -0.6, ("cat", "sat"): -0.5, ("a", "<unk>"): -0.9},
    {("the",): -0.25, ("cat",): -0.1, ("a",): -0.15},
)
NO_UNK = (2, {("the",): -0.4, ("cat",): -0.9, ("the", "cat"): -0.3}, {("the",): -0.2})


def _lms(name):
    """(JAX LM, port LM) of one kind: trained on CORPUS at order 3 or 5, or
    one of the hand-built ones."""
    if name in ("kn3", "kn5"):
        order = int(name[-1])
        return jax_train_ngram(CORPUS, order=order), train_ngram(CORPUS, order=order)
    order, lp, bo = {"unk_tailed": UNK_TAILED, "no_unk": NO_UNK}[name]
    return JaxNGramLM(order, dict(lp), dict(bo)), NGramLM(order, dict(lp), dict(bo))


@pytest.fixture(scope="module")
def tables():
    """name → (JAX LM, port LM, JAX table, port table)."""
    out = {}
    for name in ("kn3", "kn5", "unk_tailed", "no_unk"):
        jlm, tlm = _lms(name)
        out[name] = (jlm, tlm, jdl.pack_lm(jlm, JVOCAB), tdl.pack_lm(tlm, VOCAB))
    return out


def _log_probs(rng, B, T, peaked=None, scale=1.5):
    """tests/test_device_lm.py's ``_softmax_logits``: seeded normal logits,
    blank +1, optionally ``peaked`` sentences (one a row) emitted as char,
    blank, char, … at +6."""
    logits = rng.normal(size=(B, T, VOCAB.size)).astype(np.float32) * scale
    logits[:, :, VOCAB.blank_id] += 1.0
    for b, text in enumerate(peaked or []):
        for t, cid in enumerate(VOCAB.encode(text)):
            if 2 * t + 1 < T:
                logits[b, 2 * t, cid] += 6.0
                logits[b, 2 * t + 1, VOCAB.blank_id] += 6.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


# ------------------------------------------------------------------ hashes


@pytest.mark.parametrize("mult", [tdl._W1, tdl._W2, tdl._S1, tdl._S2, tdl._PHI])
def test_mul32_equals_numpy_uint32(mult):
    """Every multiplier of the scheme, on keys across [0, 2³²) (half of them
    ≥ 2³¹, the top ones included), wraps as numpy's uint32 does."""
    rng = np.random.default_rng(int(mult) % 1000)
    keys = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32),
                           np.asarray([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint32)])
    with np.errstate(over="ignore"):
        want = keys * mult
    got = tdl._mul32(torch.from_numpy(keys.astype(np.int64)), mult)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(tdl._as_i32(got).numpy(), want.view(np.int32))


@pytest.mark.parametrize("name", ["kn3", "kn5", "unk_tailed", "no_unk"])
def test_pack_lm_is_bit_equal(tables, name):
    jlm, tlm, jt, tt = tables[name]
    for word in ["the", "cat", "<unk>", "<s>", "</s>", "zebra", "it's"]:
        assert tdl._word_hash(word, VOCAB) == jdl._word_hash(word, JVOCAB), word
    for field in ("keys1", "keys2", "used", "logprob", "backoff"):
        a, b = getattr(tt, field), getattr(jt, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("order", "size", "unk_tailed", "unk_uni_lp"):
        assert getattr(tt, field) == getattr(jt, field), field
    assert tt.unk_tailed == (name == "unk_tailed")
    assert int(tt.keys1.max()) >= 1 << 31  # the table holds keys ≥ 2³¹


def _packed(tables, name):
    _, _, jt, tt = tables[name]
    return jdl._packed_device_table(jt), tdl._packed_device_table(tt, "cpu")


@pytest.mark.parametrize("name", ["kn5", "unk_tailed"])
def test_lookup_is_bit_equal_on_every_key_and_misses(tables, name):
    _, _, jt, tt = tables[name]
    jpacked, tpacked = _packed(tables, name)
    assert tpacked[0].dtype == torch.int32 and tpacked[1] == jpacked[1]
    np.testing.assert_array_equal(tpacked[0].numpy().view(np.uint32), np.asarray(jpacked[0]))
    rng = np.random.default_rng(1)
    miss = rng.integers(0, 1 << 32, (2, 4096), dtype=np.uint64).astype(np.uint32)
    k1 = np.concatenate([tt.keys1[tt.used], miss[0], [0xFFFFFFFF]]).astype(np.uint32)[None]
    k2 = np.concatenate([tt.keys2[tt.used], miss[1], [0xFFFFFFFF]]).astype(np.uint32)[None]
    want = jdl._lookup(jpacked, jnp.asarray(k1), jnp.asarray(k2))
    got = tdl._lookup(tpacked, torch.from_numpy(k1.astype(np.int64)),
                      torch.from_numpy(k2.astype(np.int64)))
    n_keys = int(tt.used.sum())
    assert int(got[0].sum()) >= n_keys  # every packed key found
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("name", ["kn3", "kn5", "unk_tailed", "no_unk"])
def test_score_word_is_bit_equal(tables, name):
    """Word scores from contexts of 0..order words (and more than order−1),
    over in-LM words, OOV words and the table's own words, in both walks."""
    jlm, tlm, jt, tt = tables[name]
    O = tt.order - 1
    words = sorted({w for ng in tlm.logprob for w in ng if not w.startswith("<")})
    words += ["zebra", "qq", "c"]
    rng = np.random.default_rng(2)
    n = 512
    ctx = [list(rng.choice(words, size=O)) for _ in range(n)]
    word = list(rng.choice(words, size=n))
    nw = rng.integers(0, O + 3, size=n).astype(np.int32)
    cx = np.zeros((2, n, max(O, 1)), np.uint32)
    for i in range(n):
        for j in range(O):  # slot j: the last j + 1 words
            cx[:, i, j] = tdl._seq_hash([tdl._word_hash(w, VOCAB) for w in ctx[i][O - 1 - j:]])
    cx = cx[:, :, :O]
    w = np.asarray([tdl._word_hash(x, VOCAB) for x in word], np.uint32).T
    for unk_tailed in ([True, False] if not tt.unk_tailed else [True]):
        unk_uni = tt.unk_uni_lp if not unk_tailed else None
        want = jdl._score_word(
            _packed(tables, name)[0], tt.order, jnp.asarray(cx[0]), jnp.asarray(cx[1]),
            jnp.asarray(nw), jnp.asarray(w[0]), jnp.asarray(w[1]), unk_tailed=unk_tailed,
            unk_uni=None if unk_uni is None else jnp.float32(unk_uni))
        t = [torch.from_numpy(a.astype(np.int64)) for a in (cx[0], cx[1], nw, w[0], w[1])]
        got = tdl._score_word(_packed(tables, name)[1], tt.order, *t, unk_tailed=unk_tailed,
                              unk_uni=unk_uni)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))
        if name == "kn3" and not unk_tailed:  # a few against the host scorer
            for i in range(20):
                k = min(int(nw[i]), O)
                host = tlm.score_word(ctx[i][O - k:] if k else [], word[i])
                assert abs(float(got[i]) - host) < 1e-5, (ctx[i], word[i], k)


# ------------------------------------------------------------------ search


SEARCH_CASES = {
    # name: (lm, B, T, lengths, peaked, kwargs)
    "kn3_w16": ("kn3", 3, 24, [24, 17, 20], None, dict(beam_width=16, alpha=0.5, beta=0.0)),
    "kn3_w16_a9_b3": ("kn3", 3, 24, [24, 17, 20], None, dict(beam_width=16, alpha=0.9, beta=0.3)),
    "kn5_w4_bias": ("kn5", 4, 40, [40, 33, 12, 1], None,
                    dict(beam_width=4, alpha=0.6, beta=0.1, blank_bias=0.2)),
    "kn5_w16_peaked_top8": ("kn5", 2, 60, [58, 38], CORPUS[4:6],
                            dict(beam_width=16, alpha=0.6, beta=0.1, token_top_k=8)),
    # spaces that complete no word (leading, doubled, trailing)
    "kn3_w8_spaces": ("kn3", 2, 28, [26, 14], [" the  cat sat", "a  dog "],
                      dict(beam_width=8, alpha=1.5, beta=0.3)),
    "unk_tailed_w16": ("unk_tailed", 2, 18, [18, 18], None, dict(beam_width=16, alpha=0.8, beta=0.1)),
    "no_unk_w4": ("no_unk", 2, 16, [16, 11], None, dict(beam_width=4, alpha=0.9, beta=0.0)),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_matches_jax_and_the_host_search(tables, case):
    name, B, T, lengths, peaked, kw = SEARCH_CASES[case]
    jlm, tlm, jt, tt = tables[name]
    rng = np.random.default_rng(sum(map(ord, case)))
    lp = _log_probs(rng, B, T, peaked, scale=0.5 if peaked else 1.5)
    lengths = np.asarray(lengths, np.int32)

    chars, parents, final, best = tdl.beam_search_lm_device(
        torch.from_numpy(lp), torch.from_numpy(lengths), tt, VOCAB.blank_id, VOCAB.pad_id,
        SPACE, **kw)
    K = kw["beam_width"]
    assert chars.shape == parents.shape == (T, B, K) and chars.dtype == torch.int32
    assert final.shape == (B, K) and best.shape == (B,) and best.dtype == torch.int32
    _, _, jfinal, _ = jdl.beam_search_lm_device(
        jnp.asarray(lp), jnp.asarray(lengths), jt, JVOCAB.blank_id, JVOCAB.pad_id, SPACE, **kw)
    np.testing.assert_allclose(np.sort(final.numpy(), axis=1), np.sort(np.asarray(jfinal), axis=1),
                               atol=SCORE_ATOL, rtol=0)

    got = tdl.beam_decode_lm_device(lp, lengths, VOCAB, tt, **kw)
    assert got == jdl.beam_decode_lm_device(lp, lengths, JVOCAB, jt, **kw)
    host_kw = {k: v for k, v in kw.items() if k != "token_top_k"}
    assert got == beam_search_lm_batch(lp, lengths, VOCAB, tlm, **host_kw)
    if peaked:  # exact under top-k when ≤ k tokens pass admission
        assert got == peaked


def test_lm_fusion_steers_toward_the_lm(tables):
    """Acoustically 'the cax' ('x' just ahead of 't'): a strong LM says 'cat'."""
    rng = np.random.default_rng(7)
    lp = _log_probs(rng, 1, 16, ["the cat"], scale=0.3)
    t_pos = 2 * (len("the cat") - 1)
    lp[0, t_pos, VOCAB.token_to_id["x"]] = lp[0, t_pos, VOCAB.token_to_id["t"]] + 0.1
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    lengths = np.asarray([16], np.int32)
    tt = tables["kn3"][3]
    plain = tdl.beam_decode_lm_device(lp, lengths, VOCAB, tt, beam_width=16, alpha=0.0)
    fused = tdl.beam_decode_lm_device(lp, lengths, VOCAB, tt, beam_width=16, alpha=2.5)
    assert fused[0].endswith("cat") and plain[0] != fused[0]
    assert fused == beam_search_lm_batch(lp, lengths, VOCAB, tables["kn3"][1], beam_width=16,
                                         alpha=2.5)


def test_device_table_is_cached_per_device(tables):
    tt = dataclasses.replace(tables["kn3"][3])
    a = tdl._packed_device_table(tt, "cpu")
    assert tdl._packed_device_table(tt, torch.device("cpu")) is a
    assert tdl._packed_device_table(dataclasses.replace(tt), "cpu") is not a


# ----------------------------------------------------------- sidecar cache


def _assert_same_table(a, b):
    for field in ("keys1", "keys2", "used", "logprob", "backoff"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    for field in ("order", "size", "unk_tailed", "unk_uni_lp"):
        assert getattr(a, field) == getattr(b, field), field


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sidecar_is_shared_with_the_jax_package(tables, tmp_path, writer):
    """Either package writes ``<arpa>.packed.npz`` and the other loads it
    without repacking; a rewritten ARPA (new mtime) repacks in both."""
    arpa = tmp_path / "lm.arpa"
    tables["kn5"][1].to_arpa(arpa)
    sidecar = tmp_path / "lm.arpa.packed.npz"
    loaders = {"jax": (jdl.load_packed_lm, JVOCAB), "torch": (tdl.load_packed_lm, VOCAB)}
    reader = "torch" if writer == "jax" else "jax"

    def load(side):
        fn, vocab = loaders[side]
        return fn(arpa, vocab)

    first = load(writer)
    assert sidecar.exists()
    stamp = sidecar.stat().st_mtime_ns
    second = load(reader)
    assert sidecar.stat().st_mtime_ns == stamp  # read, not rewritten
    _assert_same_table(first, second)
    _assert_same_table(second, tdl.pack_lm(NGramLM.from_arpa(arpa), VOCAB))

    train_ngram(CORPUS[:4], order=2).to_arpa(arpa)
    os.utime(arpa, ns=(1, 1))  # a distinct mtime even on coarse clocks
    stale = load(reader)
    assert stale.order == 2
    _assert_same_table(load(writer), stale)


def test_sidecar_corrupt_and_read_only(tables, tmp_path, monkeypatch, caplog):
    """A corrupt sidecar repacks; an unwritable directory packs every time,
    with a warning and no file left behind (root ignores chmod, so the write
    failure is injected)."""
    arpa = tmp_path / "lm.arpa"
    tables["kn3"][1].to_arpa(arpa)
    sidecar = tmp_path / "lm.arpa.packed.npz"
    sidecar.write_bytes(b"not an npz")
    fresh = tdl.pack_lm(NGramLM.from_arpa(arpa), VOCAB)  # the ARPA's n-gram order
    _assert_same_table(tdl.load_packed_lm(arpa, VOCAB), fresh)
    sidecar.unlink()

    def boom(*a, **k):
        raise OSError("read-only file system")

    monkeypatch.setattr(tdl.np, "savez", boom)
    with caplog.at_level("WARNING", logger=tdl.logger.name):
        table = tdl.load_packed_lm(arpa, VOCAB)
    _assert_same_table(table, fresh)
    assert not sidecar.exists() and not list(tmp_path.glob("*.tmp"))
    assert any("cannot write packed-LM cache" in r.getMessage() for r in caplog.records)


# ------------------------------------------------------- decoder factory


@pytest.mark.parametrize("host_lm", [False, True], ids=["device", "host"])
def test_factory_lm_text_matches_jax(tables, tmp_path, host_lm):
    arpa = tmp_path / "lm.arpa"
    tables["kn3"][1].to_arpa(arpa)
    rng = np.random.default_rng(9)
    lp = _log_probs(rng, 3, 30, CORPUS[:3], scale=0.8)
    lengths = np.asarray([30, 26, 20], np.int32)
    kw = dict(lm_path=arpa, beam_width=8, alpha=0.7, beta=0.2, host_lm=host_lm)
    want = jctc.build_decoder("beam", JVOCAB, **kw)(jnp.asarray(lp), jnp.asarray(lengths))
    got = tctc.build_decoder("beam", VOCAB, **kw)(torch.from_numpy(lp), torch.from_numpy(lengths))
    assert got == want and any(got)
    assert (tmp_path / "lm.arpa.packed.npz").exists() != host_lm


# ------------------------------------------------------------------ the CLI


@pytest.mark.parametrize("backend", ["device", "host"])
def test_eval_cli_with_lm_matches_jax(corpus, tmp_path, monkeypatch, quiet, backend):  # noqa: F811
    """``--lm-path`` with either backend: the same records, WER / CER and
    decoder block (``lm_path``, ``alpha``, ``beta``) as the JAX CLI on the
    same weights and LM."""
    _, root = corpus
    arpa = tmp_path / "lm.arpa"
    train_ngram(TEXTS, order=3).to_arpa(arpa)
    common = ["--decoder", "beam", "--beam-width", "6", "--lm-path", str(arpa), "--alpha", "0.8",
              "--beta", "0.1", "--lm-backend", backend, "--subsets", "train", "val",
              "--batch-size", "2", "--run-name", "lm_eval"]
    monkeypatch.setattr(sys, "argv", ["evaluate", "--checkpoint", str(root / "jax_run" / "last"),
                                      "--output", str(tmp_path / "jax")] + common)
    jeval.main()
    teval.main(["--checkpoint", str(root / "torch_run" / "last"), "--output",
                str(tmp_path / "torch"), "--device", "cpu"] + common)
    out = {}
    for side in ("jax", "torch"):
        out[side] = (json.loads((tmp_path / side / "metrics.json").read_text()),
                     (tmp_path / side / "predictions.jsonl").read_text().splitlines())
    (jm, jp), (tm, tp) = out["jax"], out["torch"]
    assert tp == jp and len(tp) == 3
    for key in ("wer", "cer", "error_breakdown", "decoder", "data"):
        assert tm[key] == jm[key], key
    assert (tm["decoder"]["lm_path"], tm["decoder"]["alpha"], tm["decoder"]["beta"]) == (
        str(arpa), 0.8, 0.1)
