"""Port parity: ``ssd_tpu_torch.evaluation`` (metrics, ``evaluate_checkpoint``,
the CLI) and ``ssd_tpu_torch.decoding`` (the decoder factory) against the
JAX package, on the CPU, with the same corpus, weights and log-probs."""

import argparse
import copy
import json
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ssd_tpu.data.index_dataset import save_index
from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.decoding import ctc as jctc
from ssd_tpu.evaluation import evaluate as jeval
from ssd_tpu.evaluation import metrics as jmetrics
from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.decoding import ctc as tctc
from ssd_tpu_torch.evaluation import evaluate as teval
from ssd_tpu_torch.evaluation import metrics as tmetrics
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.training.checkpoint import save_checkpoint

from .helpers import make_tiny_setup

torch.set_num_threads(1)

CHANNELS, N_MELS = 2, 8  # make_tiny_setup's cached features are (T, 2, 8)
RAW_FEATURES = {"sample_rate": 1000, "n_fft": 64, "hop_length": 16, "n_mels": N_MELS,
                "normalize": "per_file"}
TEXTS = ("the cat sat on a mat", "hello world", "a dog ran far away")
RAW_SAMPLES = (700, 1000, 820)
FUSED = {"attention_impl": "fused", "depthwise_impl": "pallas"}


# ---------------------------------------------------------------- metrics


def _pairs(n=50, seed=0):
    """Seeded ref / hyp pairs over a small word list (so hits, substitutions,
    insertions and deletions all occur), with the empty ref, the empty hyp
    and both empty."""
    rng = np.random.default_rng(seed)
    words = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran"]

    def sentence(lo):
        return " ".join(rng.choice(words, size=int(rng.integers(lo, 8))))

    pairs = [(sentence(1), sentence(0)) for _ in range(n - 3)]
    return pairs + [("", "the cat"), ("a dog ran", ""), ("", "")]


def test_metrics_equal_the_jax_metrics():
    pairs = _pairs()
    for r, h in pairs:
        assert tmetrics.compute_metrics([r], [h]) == jmetrics.compute_metrics([r], [h]), (r, h)
        assert tmetrics.compute_error_breakdown([r], [h]) == jmetrics.compute_error_breakdown([r], [h])
    refs, hyps = zip(*pairs)
    assert tmetrics.compute_metrics(refs, hyps) == jmetrics.compute_metrics(refs, hyps)
    assert tmetrics.compute_error_breakdown(refs, hyps) == jmetrics.compute_error_breakdown(refs, hyps)
    assert tmetrics._edit_counts("a b c".split(), "a x c d".split()) == {
        "cost": 2, "insertions": 1, "deletions": 0, "substitutions": 1, "hits": 2}


# ------------------------------------------------------- decoder factory


def _log_probs(seed=0, B=3, T=40):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, 48)).astype(np.float32) * 3
    logits[:, :, 1] += 2.0  # blank-heavy, as a CTC head is
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return lp.astype(np.float32), np.asarray([T, 27, 13], np.int32)


@pytest.mark.parametrize(
    "method,kw",
    [("greedy", {}), ("greedy", {"blank_bias": 0.5}),
     ("beam", {"beam_width": 8}), ("beam", {"beam_width": 8, "token_top_k": 16})],
)
def test_decoder_factory_text_matches_jax(method, kw):
    lp, lengths = _log_probs()
    want = jctc.build_decoder(method, jax_default_vocab(), **kw)(jnp.asarray(lp), jnp.asarray(lengths))
    got = tctc.build_decoder(method, default_vocab(), **kw)(torch.from_numpy(lp), torch.from_numpy(lengths))
    assert got == want
    assert any(got)


def test_missing_lm_path_warns_and_decodes(tmp_path, caplog):
    lp, lengths = _log_probs(seed=1)
    plain = tctc.build_decoder("beam", default_vocab(), beam_width=8)(lp, lengths)
    with caplog.at_level(logging.WARNING, logger=tctc.logger.name):
        decode = tctc.build_decoder("beam", default_vocab(), lm_path=tmp_path / "none.arpa",
                                    beam_width=8)
    assert any("WITHOUT LM" in r.getMessage() for r in caplog.records)
    assert decode(lp, lengths) == plain


def test_empty_arpa_decodes_as_jax(tmp_path):
    """An ARPA with no n-grams (every word scores −99): the LM-fused
    decoder, device and host, decodes as the JAX factory's."""
    arpa = tmp_path / "lm.arpa"
    arpa.write_text("\\data\\\n")
    lp, lengths = _log_probs(seed=2)
    for host_lm in (False, True):
        kw = dict(lm_path=arpa, beam_width=8, host_lm=host_lm)
        want = jctc.build_decoder("beam", jax_default_vocab(), **kw)(jnp.asarray(lp), jnp.asarray(lengths))
        assert tctc.build_decoder("beam", default_vocab(), **kw)(lp, lengths) == want


# ------------------------------------------------------- evaluate_checkpoint


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """make_tiny_setup's corpus with varied transcripts and a raw signal per
    utterance (its index's ``emg_path``), and the same weights saved by both
    packages: JAX-initialized, non-trivial BN statistics, the CTC head ×10
    so argmax margins dwarf the fp32 tolerance."""
    cfg, _, root = make_tiny_setup(tmp_path_factory.mktemp("eval"))
    rng = np.random.default_rng(1)
    index = pd.read_parquet(cfg["data"]["index"])
    for i, n in enumerate(RAW_SAMPLES):
        path = root / "raw" / f"{i}.npy"
        path.parent.mkdir(exist_ok=True)
        np.save(path, rng.normal(size=(n, CHANNELS)).astype(np.float32))
        index.loc[i, ["emg_path", "transcript"]] = [str(path), TEXTS[i]]
    save_index(index, cfg["data"]["index"])
    cfg["features"]["emg"] = dict(RAW_FEATURES)

    jmodel = jax_build_model(cfg, input_dim=CHANNELS * N_MELS, vocab_size=48)
    v = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 16)), jnp.array([40])))
    params, stats = v["params"], v["batch_stats"]
    stats = jax.tree_util.tree_map(lambda x: rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32), stats)
    params["ctc_head"]["fc"]["kernel"] = np.asarray(params["ctc_head"]["fc"]["kernel"]) * 10.0
    jax_save_checkpoint(root / "jax_run", {"params": params, "batch_stats": stats}, cfg)
    sd = state_dict_from_flax(params, stats, build_model(cfg, CHANNELS * N_MELS, 48).encoder_cfg)
    save_checkpoint(root / "torch_run", sd, cfg)
    return cfg, root


def _variant(cfg, fused, raw):
    cfg = copy.deepcopy(cfg)
    if fused:
        cfg["model"]["encoder"].update(FUSED)
    cfg["data"]["train_from_raw"] = raw
    return cfg


SPLITS, SUBSETS = ["voiced_parallel_data"], ["train", "val"]


@pytest.mark.parametrize("raw", [False, True], ids=["cached", "raw"])
@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused_pallas"])
def test_evaluate_checkpoint_matches_jax(corpus, fused, raw):
    """Greedy and beam-8, two batches (the second ragged): the same records
    and the same WER, CER and error breakdown as the JAX evaluation, whose
    Pallas kernels run in interpret mode."""
    cfg, root = corpus
    for method in ("greedy", "beam"):
        want = jeval.evaluate_checkpoint(
            root / "jax_run" / "last", _variant(cfg, fused, raw), jax_default_vocab(), SPLITS,
            SUBSETS, jctc.build_decoder(method, jax_default_vocab(), beam_width=8), batch_size=2)
        got = teval.evaluate_checkpoint(
            root / "torch_run" / "last", _variant(cfg, fused, raw), default_vocab(), SPLITS,
            SUBSETS, tctc.build_decoder(method, default_vocab(), beam_width=8), batch_size=2,
            device="cpu")
        assert got["records"] == want["records"], method
        assert sorted(r["ref"] for r in got["records"]) == sorted(TEXTS)
        assert any(r["hyp"] for r in got["records"]), method
        for key in ("wer", "cer", "error_breakdown"):
            assert got["metrics"][key] == want["metrics"][key], (method, key)
        assert set(got["metrics"]["decode_latency_sec"]) == {"p50", "p90", "mean"}


# ------------------------------------------------------------------ the CLI


@pytest.fixture
def quiet(monkeypatch):
    """Both CLIs' logging set-up left alone (it replaces pytest's handlers)."""
    monkeypatch.setattr("ssd_tpu.utils.config.setup_cli_logging", lambda: None)
    monkeypatch.setattr("ssd_tpu_torch.utils.config.setup_cli_logging", lambda: None)


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in tree.items()}


def test_cli_writes_the_jax_clis_files(corpus, tmp_path, monkeypatch, quiet):
    """``main`` writes metrics.json with the JAX CLI's keys and values (the
    latencies aside), the same predictions.jsonl and the same
    config_used.json."""
    _, root = corpus
    common = ["--decoder", "beam", "--beam-width", "6", "--subsets", "train", "val",
              "--batch-size", "2", "--run-name", "tiny_eval"]
    monkeypatch.setattr(sys, "argv", ["evaluate", "--checkpoint", str(root / "jax_run" / "last"),
                                      "--output", str(tmp_path / "jax")] + common)
    jeval.main()
    teval.main(["--checkpoint", str(root / "torch_run" / "last"), "--output",
                str(tmp_path / "torch"), "--device", "cpu"] + common)
    files = {}
    for side in ("jax", "torch"):
        out = tmp_path / side
        files[side] = (json.loads((out / "metrics.json").read_text()),
                       (out / "predictions.jsonl").read_text().splitlines(),
                       json.loads((out / "config_used.json").read_text()))
    (jm, jp, jc), (tm, tp, tc) = files["jax"], files["torch"]
    assert _keys(tm) == _keys(jm)
    for key in ("wer", "cer", "error_breakdown", "decoder", "data", "run_name"):
        assert tm[key] == jm[key], key
    assert tm["decoder"]["beam_width"] == 6 and tm["data"]["num_samples"] == 3
    assert tp == jp and len(tp) == 3
    assert tc == jc


def _decoder_block(root, tmp_path, name, *argv, decoding=None):
    """metrics.json's ``decoder`` block of a CLI run on a copy of the
    checkpoint whose config's ``decoding`` block is ``decoding`` (None:
    as saved)."""
    run = root / "torch_run"
    if decoding is not None:
        cfg = json.loads((run / "config.json").read_text())
        cfg["decoding"] = decoding
        run = tmp_path / name
        save_checkpoint(run, torch.load(root / "torch_run" / "last" / "model.pt")["state_dict"], cfg)
    teval.main(["--checkpoint", str(run / "last"), "--output", str(tmp_path / f"out_{name}"),
                "--device", "cpu", "--subsets", "val", *argv])
    return json.loads((tmp_path / f"out_{name}" / "metrics.json").read_text())["decoder"]


def test_cli_knob_precedence(corpus, tmp_path, quiet):
    """CLI > the checkpoint config's decoding block > the defaults."""
    _, root = corpus
    # make_tiny_setup's block: beam, width 8, α 0.4, prune −10
    saved = _decoder_block(root, tmp_path, "saved")
    assert (saved["type"], saved["beam_width"], saved["alpha"], saved["beta"]) == ("beam", 8, 0.4, 0.0)
    cli = _decoder_block(root, tmp_path, "cli", "--beam-width", "4", "--alpha", "0.7")
    assert (cli["beam_width"], cli["alpha"]) == (4, 0.7)
    default = _decoder_block(root, tmp_path, "default", "--decoder", "beam", decoding={})
    assert (default["beam_width"], default["alpha"], default["beta"], default["beam_prune_logp"]) == (
        50, 0.6, 0.0, -10.0)
    greedy = _decoder_block(root, tmp_path, "greedy", "--decoder", "greedy", decoding={})
    assert greedy["type"] == "greedy" and greedy["beam_width"] is None


def _jax_eval_parser(monkeypatch) -> argparse.ArgumentParser:
    """The JAX CLI's parser, caught as its ``main`` calls ``parse_args``."""
    caught = []

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        caught.append(self)
        raise Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught):
            jeval.main()
    return caught[0]


def _argv_for(action: argparse.Action, option: str) -> list:
    if action.nargs == 0:
        return [option]
    if action.choices:
        return [option, str(list(action.choices)[-1])]
    value = {int: "3", float: "0.7"}.get(action.type, "some/path")
    return [option, value]


def test_cli_accepts_every_jax_eval_flag(monkeypatch, quiet):
    jparser = _jax_eval_parser(monkeypatch)
    parser = teval.build_parser()
    options = [(a, o) for a in jparser._actions if a.dest != "help" for o in a.option_strings]
    assert {"--device", "--compile-cache", "--quantize", "--lm-backend", "--data-parallel"} <= {
        o for _, o in options}
    for action, option in options:
        argv = _argv_for(action, option)
        if option != "--checkpoint":
            argv = ["--checkpoint", "ck"] + argv
        assert vars(parser.parse_args(argv))[action.dest] is not None, option


@pytest.mark.parametrize(
    "argv,error,match",
    [(["--quantize", "int8"], NotImplementedError, "queue 1 item 9"),
     (["--quantize", "int8_prequant"], NotImplementedError, "queue 1 item 9"),
     (["--data-parallel"], NotImplementedError, "queue 1 item 10")],
)
def test_cli_unported_options_raise(corpus, tmp_path, quiet, argv, error, match):
    _, root = corpus
    with pytest.raises(error, match=match):
        teval.main(["--checkpoint", str(root / "torch_run" / "last"), "--device", "cpu",
                    "--output", str(tmp_path / "out")] + argv)
    assert not (tmp_path / "out" / "metrics.json").exists()


def test_quantized_checkpoint_raises(corpus, tmp_path, quiet):
    _, root = corpus
    cfg = json.loads((root / "torch_run" / "config.json").read_text())
    cfg["model"]["encoder"]["quantize"] = "int8"
    save_checkpoint(tmp_path / "q", torch.load(root / "torch_run" / "last" / "model.pt")["state_dict"], cfg)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        teval.main(["--checkpoint", str(tmp_path / "q" / "last"), "--device", "cpu"])


@pytest.mark.parametrize("device", ["cuda", "tpu"])
def test_cli_needs_the_card_unless_asked_for_the_cpu(corpus, tmp_path, monkeypatch, quiet, device):
    """``--device cuda`` (the default) and the JAX CLI's ``tpu`` mean the card;
    without one they raise, before any data is read."""
    _, root = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--device", device], []):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teval.main(["--checkpoint", str(root / "torch_run" / "last"), "--output",
                        str(tmp_path / "out")] + argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.evaluate_checkpoint(root / "torch_run" / "last", {}, default_vocab(), SPLITS,
                                  SUBSETS, None)
