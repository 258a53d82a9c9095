"""Port parity: ``ssd_tpu_torch.serving`` against the JAX ``InferenceEngine``
on the same raw EMG and weights, the port's checkpoint round trip, its HTTP
front end, and its refusal to fall back to the CPU."""

import argparse
import json
import logging
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu.serving import engine as jeng
from ssd_tpu.serving import server as jserver
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.decoding import ctc as tctc
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.serving import engine as teng
from ssd_tpu_torch.serving import server as tserver
from ssd_tpu_torch.serving.server import encode_npy, serve
from ssd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

CHANNELS, N_MELS = 2, 8


def _cfg(vocab_path="unused"):
    return {
        "data": {"vocab": str(vocab_path)},
        "features": {
            "emg": {"sample_rate": 1000, "n_fft": 64, "hop_length": 16,
                    "n_mels": N_MELS, "normalize": "per_file"}
        },
        "model": {
            "encoder": {
                "d_model": 48, "num_layers": 2, "num_heads": 4, "ffn_dim": 96,
                "depthwise_conv_kernel_size": 5, "subsample_factor": 2,
                "dropout": 0.0, "input_dim": CHANNELS * N_MELS,
            },
            "projection_dim": 32,
        },
        "decoding": {"token_top_k": 8},
    }


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    """Small sample bucket for the tiny featurizer config, in both engines."""
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "SAMPLE_BUCKET", 256)
        monkeypatch.setattr(mod, "BATCH_BUCKETS", (1, 2, 4))


@pytest.fixture(scope="module")
def weights():
    """JAX-initialized weights with non-trivial BN statistics; the CTC head
    is scaled ×10 so argmax margins dwarf the fp32 tolerance."""
    cfg = _cfg()
    model = jax_build_model(cfg, input_dim=CHANNELS * N_MELS, vocab_size=48)
    v = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 16)), jnp.array([40])))
    params, stats = v["params"], v["batch_stats"]
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32), stats
    )
    params["ctc_head"]["fc"]["kernel"] = np.asarray(params["ctc_head"]["fc"]["kernel"]) * 10.0
    sd = state_dict_from_flax(params, stats, teng.build_model(cfg, 16, 48).encoder_cfg)
    return params, stats, sd


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, CHANNELS)).astype(np.float32) for n in (700, 450, 300)]


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_engine_text_matches_jax(weights, decoder):
    params, stats, sd = weights
    kw = dict(decoder=decoder, beam_width=8)
    j = jeng.InferenceEngine(_cfg(), params, stats, jax_default_vocab(), **kw)
    t = teng.InferenceEngine(_cfg(), sd, default_vocab(), device="cpu", **kw)
    reqs = _requests()
    want = j.transcribe(reqs)
    got = t.transcribe(reqs)
    assert got == want
    assert any(got)
    assert t.stats.summary()["count"] == len(reqs)
    # the same log-probs, batch padding included (padded rows have length n_fft)
    j_lp, j_ol = j._pipeline(*map(jnp.asarray, j_pad(reqs)))
    t_lp, t_ol = t.forward(reqs)
    np.testing.assert_array_equal(t_ol.numpy(), np.asarray(j_ol))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), atol=2e-3, rtol=2e-4)


def j_pad(reqs):
    """The JAX engine's batch padding, written out (it has no helper)."""
    lengths = np.asarray([len(a) for a in reqs], np.int32)
    L = jeng._round_up(int(lengths.max()), jeng.SAMPLE_BUCKET)
    B = next(b for b in jeng.BATCH_BUCKETS if b >= len(reqs))
    batch = np.zeros((B, L, CHANNELS), np.float32)
    for i, a in enumerate(reqs):
        batch[i, : len(a)] = a
    return batch, np.concatenate([lengths, np.full((B - len(reqs),), 64, np.int32)])


def test_checkpoint_round_trip(weights, tmp_path):
    _, _, sd = weights
    vocab_path = tmp_path / "vocab.json"
    default_vocab().to_json(vocab_path)
    cfg = _cfg(vocab_path)
    save_checkpoint(tmp_path / "run", sd, cfg, is_best=True)
    payload = load_checkpoint(tmp_path / "run" / "best")
    assert payload["state_dict"].keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(payload["state_dict"][k], v)
    direct = teng.InferenceEngine(cfg, sd, default_vocab(), device="cpu")
    loaded = teng.InferenceEngine.from_checkpoint(tmp_path / "run" / "last", device="cpu")
    reqs = _requests(seed=1)
    assert loaded.transcribe(reqs) == direct.transcribe(reqs)


def test_http_round_trip(weights, tmp_path):
    _, _, sd = weights
    vocab_path = tmp_path / "vocab.json"
    default_vocab().to_json(vocab_path)
    save_checkpoint(tmp_path / "run", sd, _cfg(vocab_path))
    server = serve(
        tmp_path / "run" / "last", port=0, host="127.0.0.1", warmup=False,
        max_wait_ms=5.0, device="cpu",
    )
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.load(r)

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        reqs = _requests(seed=2)
        engine = teng.InferenceEngine.from_checkpoint(tmp_path / "run" / "last", device="cpu")
        out = post("/transcribe", {"emg": encode_npy(reqs[0])})
        assert out["hypotheses"] == engine.transcribe(reqs[:1])
        assert out["latency_ms"] > 0
        out = post("/transcribe", {"emg_list": [encode_npy(a) for a in reqs]})
        assert out["hypotheses"] == engine.transcribe(reqs)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["latency"]["count"] == 4 and stats["micro_batch"]["items"] == 1
        for path, payload, code in [
            ("/stream/start", {}, 501),
            ("/transcribe", {"wrong_field": 1}, 400),
            ("/transcribe", {"emg": "not-base64!!"}, 400),
        ]:
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(path, payload)
            assert ei.value.code == code
    finally:
        server.shutdown()
        server.batcher.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_engine_unported_options_raise(weights):
    _, _, sd = weights
    for kw in ({"data_parallel": True}, {"quantize": "int8"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            teng.InferenceEngine(_cfg(), sd, default_vocab(), device="cpu", **kw)


@pytest.mark.parametrize("where", ["argument", "config"])
def test_missing_lm_path_warns_and_serves_without_the_lm(weights, tmp_path, caplog, where):
    """A ``lm_path`` (constructor or the config's decoding block) that does
    not exist is logged and served LM-free, as the JAX engine does."""
    _, _, sd = weights
    missing = tmp_path / "no_such.arpa"
    cfg = _cfg()
    kw = dict(decoder="beam", beam_width=8, device="cpu")
    if where == "config":
        cfg["decoding"]["lm_path"] = str(missing)
    else:
        kw["lm_path"] = missing
    with caplog.at_level(logging.WARNING, logger=tctc.logger.name):
        engine = teng.InferenceEngine(cfg, sd, default_vocab(), **kw)
    assert any("WITHOUT LM" in r.getMessage() and str(missing) in r.getMessage()
               for r in caplog.records)
    assert not engine.has_lm
    plain = teng.InferenceEngine(_cfg(), sd, default_vocab(), decoder="beam", beam_width=8,
                                 device="cpu")
    reqs = _requests(seed=4)
    assert engine.transcribe(reqs) == plain.transcribe(reqs)


def test_engine_lm_text_matches_jax(weights, tmp_path, monkeypatch):
    """Beam with an ARPA LM (the config's ``alpha`` / ``beta``): the JAX
    engine's text, on the same weights, LM and requests, through the LM
    search once a transcribe; greedy engines load no table."""
    from ssd_tpu_torch.decoding.lm import train_ngram

    params, stats, sd = weights
    arpa = tmp_path / "lm.arpa"
    train_ngram(["the cat sat on a mat", "a dog ran far away", "hello world"], order=3).to_arpa(arpa)
    cfg = _cfg()
    cfg["decoding"].update(lm_path=str(arpa), alpha=1.2, beta=0.5)
    j = jeng.InferenceEngine(cfg, params, stats, jax_default_vocab(), decoder="beam", beam_width=8)
    t = teng.InferenceEngine(cfg, sd, default_vocab(), decoder="beam", beam_width=8, device="cpu")
    assert t.has_lm and (t.alpha, t.beta) == (1.2, 0.5)
    searched = []
    search = tctc.beam_decode_lm_device
    monkeypatch.setattr(tctc, "beam_decode_lm_device",
                        lambda *a, **k: searched.append(k) or search(*a, **k))
    reqs = _requests(seed=5)
    assert t.transcribe(reqs) == j.transcribe(reqs)
    assert [(k["alpha"], k["beta"], k["beam_width"]) for k in searched] == [(1.2, 0.5, 8)]
    assert not teng.InferenceEngine(cfg, sd, default_vocab(), device="cpu").has_lm


def test_cuda_engine_raises_without_a_card(weights):
    """The default device is the card; without one the engine raises instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, sd = weights
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.InferenceEngine(_cfg(), sd, default_vocab())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.InferenceEngine(_cfg(), sd, default_vocab(), device="cuda")


def test_streaming_transcriber_refreshes_and_finishes(weights):
    """Feeding chunks refreshes the hypothesis every ``update_every_sec`` of
    signal; ``finish`` transcribes the whole stream, as one request would."""
    _, _, sd = weights
    engine = teng.InferenceEngine(_cfg(), sd, default_vocab(), device="cpu")
    stream = teng.StreamingTranscriber(engine, update_every_sec=0.25)
    emg = _requests(seed=3)[0]  # 700 samples
    updates = [stream.feed(emg[i : i + 100]) for i in range(0, 700, 100)]
    assert [u is not None for u in updates] == [False, False, True, False, False, True, False]
    assert updates[5] == engine.transcribe([emg[:600]])[0]
    assert stream.finish() == engine.transcribe([emg])[0]
    stream.reset()
    assert stream.hypothesis == "" and stream.finish() == ""


def _jax_server_parser(monkeypatch) -> argparse.ArgumentParser:
    """The JAX server's parser, caught as its ``main`` calls ``parse_args``."""
    caught = []

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        caught.append(self)
        raise Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        m.setattr("ssd_tpu.utils.config.setup_cli_logging", lambda: None)
        with pytest.raises(Caught):
            jserver.main()
    return caught[0]


def _argv_for(action: argparse.Action, option: str) -> list:
    if action.nargs == 0:
        return [option]
    if action.choices:
        return [option, str(list(action.choices)[-1])]
    value = {int: "3", float: "0.7"}.get(action.type, "some/path")
    return [option, value]


def test_server_accepts_every_jax_server_flag(weights, tmp_path, monkeypatch, caplog):
    """Each option string of the JAX server's parser parses in the port's,
    and ``--alpha`` / ``--beta`` reach the engine through ``main``;
    ``--compile-cache`` is logged once as unused."""
    jparser = _jax_server_parser(monkeypatch)
    parser = tserver.build_parser()
    options = [(a, o) for a in jparser._actions if a.dest != "help" for o in a.option_strings]
    assert {"--alpha", "--beta", "--compile-cache", "--lm-path", "--quantize"} <= {o for _, o in options}
    for action, option in options:
        argv = _argv_for(action, option)
        if option != "--checkpoint":
            argv = ["--checkpoint", "ck"] + argv
        assert vars(parser.parse_args(argv))[action.dest] is not None, option

    _, _, sd = weights
    vocab_path = tmp_path / "vocab.json"
    default_vocab().to_json(vocab_path)
    save_checkpoint(tmp_path / "run", sd, _cfg(vocab_path))
    started = []
    monkeypatch.setattr(tserver.ThreadingHTTPServer, "serve_forever", lambda self: started.append(self))
    monkeypatch.setattr("ssd_tpu_torch.utils.config.setup_cli_logging", lambda: None)
    monkeypatch.setattr(sys, "argv", [
        "server", "--checkpoint", str(tmp_path / "run" / "last"), "--port", "0",
        "--device", "cpu", "--no-warmup", "--alpha", "0.7", "--beta", "0.2",
        "--compile-cache", str(tmp_path / "cache")])
    with caplog.at_level(logging.INFO, logger=tserver.logger.name):
        tserver.main()
    (server,) = started
    assert (server.batcher.engine.alpha, server.batcher.engine.beta) == (0.7, 0.2)
    assert sum("--compile-cache" in r.getMessage() for r in caplog.records) == 1


def test_engine_lm_weights_precedence(weights):
    """CLI / constructor > the checkpoint's decoding block > 0.5 / 0.0, as
    the JAX engine; they change no text without an LM."""
    _, _, sd = weights
    cfg = _cfg()
    plain = teng.InferenceEngine(cfg, sd, default_vocab(), device="cpu")
    assert (plain.alpha, plain.beta) == (0.5, 0.0)
    cfg["decoding"].update(alpha=0.4, beta=0.1)
    from_cfg = teng.InferenceEngine(cfg, sd, default_vocab(), device="cpu")
    assert (from_cfg.alpha, from_cfg.beta) == (0.4, 0.1)
    given = teng.InferenceEngine(cfg, sd, default_vocab(), device="cpu", alpha=0.9, beta=0.3)
    assert (given.alpha, given.beta) == (0.9, 0.3)
    reqs = _requests(seed=4)
    assert given.transcribe(reqs) == plain.transcribe(reqs)
