"""Port parity: ``ssd_tpu_torch.decoding.lm`` (the Kneser–Ney trainer, ARPA
IO and the backoff scorer), ``decoding.host_beam`` (the host LM search) and
the ``decoding.build_char_lm`` CLI against the JAX package, on the CPU. An
LM either package builds is the same file, and scores the same."""

import sys

import numpy as np
import pytest

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.decoding import build_char_lm as jbuild
from ssd_tpu.decoding import host_beam as jhost
from ssd_tpu.decoding import lm as jlm
from ssd_tpu_torch.data.index_dataset import save_index
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.decoding import build_char_lm as tbuild
from ssd_tpu_torch.decoding import host_beam as thost
from ssd_tpu_torch.decoding import lm as tlm

from .test_arpa_interchange import LMPLZ_STYLE_ARPA
from .test_device_lm import CORPUS
from .test_torch_logging import restored_logging

SENTENCES = CORPUS + ["zebra cat", "the the the", "", "dogs", "she ran to a fox"]


@pytest.mark.parametrize("order", [2, 3, 5])
def test_train_ngram_writes_the_same_arpa_and_scores(tmp_path, order):
    """The ARPA text is byte-identical; every sentence's log10 score (on
    the trained LM and on its ARPA round trip) within 1e-6, OOV words
    included."""
    want_lm = jlm.train_ngram(CORPUS, order=order)
    got_lm = tlm.train_ngram(CORPUS, order=order)
    want_lm.to_arpa(tmp_path / "jax.arpa")
    got_lm.to_arpa(tmp_path / "torch.arpa")
    text = (tmp_path / "torch.arpa").read_text()
    assert text == (tmp_path / "jax.arpa").read_text()
    assert f"ngram {order}=" in text
    reread = tlm.NGramLM.from_arpa(tmp_path / "jax.arpa")
    assert reread.order == order
    for s in SENTENCES:
        want = want_lm.score_log10(s)
        assert abs(got_lm.score_log10(s) - want) <= 1e-6, s
        assert abs(reread.score_log10(s) - want) <= 1e-6, s
        assert got_lm.score_log10(s, bos=False, eos=False) == want_lm.score_log10(s, bos=False, eos=False)


def test_from_arpa_reads_lmplz_output_as_the_jax_package_does(tmp_path):
    """lmplz's dialect (tab columns, −99 / −inf, missing and explicit-0
    backoffs): the same tables and scores, and the same rewritten file."""
    path = tmp_path / "lmplz.arpa"
    path.write_text(LMPLZ_STYLE_ARPA, encoding="utf-8")
    want, got = jlm.NGramLM.from_arpa(path), tlm.NGramLM.from_arpa(path)
    assert (got.order, got.logprob, got.backoff) == (want.order, want.logprob, want.backoff)
    for s in ("cat dog", "dog cat", "zebra", "cat", "dog dog dog", "xx"):
        assert got.score_log10(s) == want.score_log10(s)
    want.to_arpa(tmp_path / "jax.arpa")
    got.to_arpa(tmp_path / "torch.arpa")
    assert (tmp_path / "torch.arpa").read_text() == (tmp_path / "jax.arpa").read_text()


def _peaked_log_probs(rng, text, T, noise):
    """(T, V) log-probs: ``text`` emitted as char, blank, … at +5 over
    seeded noise, the remaining frames noise."""
    V = default_vocab().size
    logits = rng.normal(size=(T, V)) * noise
    logits[:, 1] += 1.0
    for t, cid in enumerate(default_vocab().encode(text)):
        if 2 * t + 1 < T:
            logits[2 * t, cid] += 5.0
            logits[2 * t + 1, 1] += 5.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [dict(beam_width=4, alpha=0.5), dict(beam_width=16, alpha=0.9, beta=0.3),
     dict(beam_width=16, alpha=0.6, beta=-0.1, blank_bias=0.3, beam_prune_logp=-6.0,
          token_min_logp=-8.0)],
)
def test_host_beam_matches_jax(kw):
    """The host search on the same LM and log-probs (random rows, peaked
    sentences, a length-masked batch, and no LM)."""
    rng = np.random.default_rng(kw["beam_width"])
    lms = (jlm.train_ngram(CORPUS, order=3), tlm.train_ngram(CORPUS, order=3))
    texts = ["the cat sat on the mat", "a dog and a cat", "", "the quick brown fox"]
    lp = np.stack([_peaked_log_probs(rng, t, 48, noise=1.5 if not t else 0.6) for t in texts])
    lengths = np.asarray([44, 30, 48, 21], np.int32)
    for want_lm, got_lm in (lms, (None, None)):
        want = jhost.beam_search_lm_batch(lp, lengths, jax_default_vocab(), want_lm, **kw)
        got = thost.beam_search_lm_batch(lp, lengths, default_vocab(), got_lm, **kw)
        assert got == want
        assert got[0] == "the cat sat on the mat"


@pytest.fixture
def index(tmp_path):
    """A JSONL index of both splits and three subsets, with transcripts that
    need normalizing and one that normalizes to nothing."""
    rows = []
    texts = ["The Cat, sat!", "a DOG ran", "  hello   world ", "...", "the mat", "silent one",
             "val line two", "test only"]
    where = [("voiced_parallel_data", "train"), ("voiced_parallel_data", "train"),
             ("voiced_parallel_data", "val"), ("voiced_parallel_data", "train"),
             ("voiced_parallel_data", "val"), ("silent_parallel_data", "train"),
             ("voiced_parallel_data", "val"), ("voiced_parallel_data", "test")]
    for i, (text, (split, subset)) in enumerate(zip(texts, where)):
        rows.append(dict(utterance_id=f"{split}/s/{i}", split=split, subset=subset, speaker="s",
                         stem=str(i), emg_path=f"{i}.npy", audio_path=None, transcript=text,
                         sentence_index=i, book="", has_audio=False, metadata_json="{}"))
    path = tmp_path / "index.jsonl"
    save_index(rows, path)
    return path


@pytest.mark.parametrize(
    "extra,n_lines",
    [([], 6), (["--order", "3", "--subsets", "train"], 3),
     (["--splits", "silent_parallel_data"], 1), (["--skip-kenlm"], 6)],
    ids=["defaults", "order3_train", "silent", "skip_kenlm"],
)
def test_build_char_lm_cli_matches_jax(index, tmp_path, monkeypatch, extra, n_lines):
    """The same corpus file (the selected rows' normalized transcripts) and
    the same ARPA as the JAX CLI."""
    monkeypatch.setattr("ssd_tpu.utils.config.setup_cli_logging", lambda: None)
    monkeypatch.setattr("ssd_tpu_torch.utils.config.setup_cli_logging", lambda: None)
    outs = {side: tmp_path / side / "char_lm.arpa" for side in ("jax", "torch")}
    monkeypatch.setattr(sys, "argv", ["build_char_lm", "--index", str(index), "--output",
                                      str(outs["jax"])] + extra)
    jbuild.main()
    with restored_logging():
        tbuild.main(["--index", str(index), "--output", str(outs["torch"])] + extra)
    corpus = outs["torch"].with_suffix(".txt").read_text()
    assert corpus == outs["jax"].with_suffix(".txt").read_text()
    assert len(corpus.splitlines()) == n_lines
    if "--skip-kenlm" in extra:
        assert not outs["torch"].exists() and not outs["jax"].exists()
    else:
        assert outs["torch"].read_text() == outs["jax"].read_text()
        assert tlm.NGramLM.from_arpa(outs["torch"]).order == (3 if "3" in extra else 5)


def test_build_char_lm_cli_refuses_an_empty_selection(index, monkeypatch):
    monkeypatch.setattr("ssd_tpu_torch.utils.config.setup_cli_logging", lambda: None)
    with pytest.raises(ValueError, match="No transcripts"), restored_logging():
        tbuild.main(["--index", str(index), "--splits", "nonexistent"])
