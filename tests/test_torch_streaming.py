"""Port parity: ``ssd_tpu_torch.serving.streaming`` against the JAX
``ChunkedStreamingTranscriber`` on the same seeded streams and weights (the
JAX window on its CPU path: the XLA featurizer, and the Pallas kernels in
interpret mode under the fused/pallas keys), plus the port's own offline
equality, bookkeeping, concurrency and input checks."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.models.conformer import EncoderConfig as JEncoderConfig
from ssd_tpu.models.conformer import subsampled_lengths as j_subsampled_lengths
from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu.serving import engine as jeng
from ssd_tpu.serving import streaming as jstream
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.serving import engine as teng
from ssd_tpu_torch.serving import server as tserver
from ssd_tpu_torch.serving import streaming as tstream

torch.set_num_threads(1)

CHANNELS, N_MELS, N_FFT, HOP = 2, 8, 64, 16
FUSED = {"attention_impl": "fused", "depthwise_impl": "pallas"}
CONFIGS = {"default": {}, "fused": FUSED}
# a geometry the tiny featurizer fills in a few hundred samples:
# S 16, W 32, R 16 → a 64-frame window of 1 072 samples
GEOMETRY = dict(chunk_frames=16, left_context_frames=32, right_context_frames=16)
LP_ATOL = 2e-4  # emitted log-probs, JAX vs port (fp32, summation order only)
STATS_RTOL = 1e-5  # running feature sums, JAX's fp32 order vs torch's


def tiny_cfg(vocab_path="unused", **enc):
    """The tiny serving config of ``tests/test_torch_serving.py`` with
    encoder keys overridden."""
    encoder = {
        "d_model": 48, "num_layers": 2, "num_heads": 4, "ffn_dim": 96,
        "depthwise_conv_kernel_size": 5, "subsample_factor": 2,
        "dropout": 0.0, "input_dim": CHANNELS * N_MELS, **enc,
    }
    return {
        "data": {"vocab": str(vocab_path)},
        "features": {"emg": {"sample_rate": 1000, "n_fft": N_FFT, "hop_length": HOP,
                             "n_mels": N_MELS, "normalize": "per_file"}},
        "model": {"encoder": encoder, "projection_dim": 32},
        "decoding": {"token_top_k": 8},
    }


def shared_weights():
    """JAX-initialized weights with non-trivial BN statistics and a ×10 CTC
    head (argmax margins dwarf the fp32 error), and their port state dict."""
    cfg = tiny_cfg()
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


@pytest.fixture(scope="module")
def weights():
    return shared_weights()


@pytest.fixture(scope="module")
def engines(weights):
    """(JAX, port) engine pairs, beam width 8, per configuration: module
    scoped, so the JAX windows compile once per geometry."""
    params, stats, sd = weights
    kw = dict(beam_width=8)
    return {
        name: (jeng.InferenceEngine(tiny_cfg(**enc), params, stats, jax_default_vocab(), **kw),
               teng.InferenceEngine(tiny_cfg(**enc), sd, default_vocab(), device="cpu", **kw))
        for name, enc in CONFIGS.items()
    }


@pytest.fixture
def small_buckets(monkeypatch):
    monkeypatch.setattr(teng, "SAMPLE_BUCKET", 256)
    monkeypatch.setattr(teng, "BATCH_BUCKETS", (1, 2, 4))


def _stream(seed, n):
    return np.random.default_rng(seed).normal(size=(n, CHANNELS)).astype(np.float32)


def _pieces(seed, emg):
    """Split a stream into seeded pieces of 30–170 samples."""
    rng = np.random.default_rng(seed + 100)
    cuts, pos = [], 0
    while pos < len(emg):
        step = int(rng.integers(30, 171))
        cuts.append(emg[pos : pos + step])
        pos += step
    return cuts


def test_collapse_ids_matches_jax():
    rng = np.random.default_rng(0)
    blank, pad = 1, 0
    carry_j = carry_t = blank
    for _ in range(50):
        ids = rng.integers(0, 6, size=int(rng.integers(0, 12)))
        ids = np.repeat(ids, rng.integers(1, 4, size=ids.size))  # runs of repeats
        out_j, carry_j = jstream.collapse_ids(ids, carry_j, blank, pad)
        out_t, carry_t = tstream.collapse_ids(ids, carry_t, blank, pad)
        assert (out_t, carry_t) == (out_j, carry_j)
    # the carry merges a chunk's leading repeat with its predecessor's tail
    assert tstream.collapse_ids([3, 3, 7], 3, blank, pad) == ([7], 7)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_windows_match_jax(engines, config):
    """The same stream, fed in the same pieces: the hypothesis after every
    feed, the emitted log-probs, the emitted frame count and the running
    statistics agree with the JAX transcriber."""
    j_eng, t_eng = engines[config]
    js = jstream.ChunkedStreamingTranscriber(j_eng, **GEOMETRY)
    ts = tstream.ChunkedStreamingTranscriber(t_eng, **GEOMETRY)
    assert (ts.S, ts.W, ts.R, ts.Tw, ts.Lw) == (js.S, js.W, js.R, js.Tw, js.Lw)
    emg = _stream(1, 2400)
    updates = 0
    for piece in _pieces(1, emg):
        got, want = ts.feed(piece), js.feed(piece)
        assert got == want
        assert ts.hypothesis == js.hypothesis
        assert ts._emitted == js._emitted
        updates += got is not None
    assert updates >= 3  # windows ran during the stream
    assert ts.finish() == js.finish()
    assert ts._emitted == js._emitted
    got_lp, want_lp = np.concatenate(ts._log_probs), np.concatenate(js._log_probs)
    assert got_lp.shape == want_lp.shape
    np.testing.assert_allclose(got_lp, want_lp, atol=LP_ATOL, rtol=0)
    assert ts._stats[2] == js._stats[2]
    np.testing.assert_allclose(ts._stats[:2], js._stats[:2], rtol=STATS_RTOL)
    assert ts.windows >= 5 and any(ts.hypothesis)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_one_window_stream_equals_offline(engines, config, small_buckets):
    """A stream that fits one window: the running z-norm equals the
    per-file one, so the text equals the port's offline transcribe."""
    _, t_eng = engines[config]
    emg = _stream(3, 300)
    ts = tstream.ChunkedStreamingTranscriber(t_eng, **GEOMETRY)
    for i in range(0, 300, 100):  # 15 frames < S + R: nothing emits while feeding
        assert ts.feed(emg[i : i + 100]) is None
    text = ts.finish()
    assert ts.windows == 1
    assert text == t_eng.transcribe([emg])[0]
    assert any(text)


def test_emitted_frames_sum_to_subsampled_length(engines):
    _, t_eng = engines["default"]
    ts = tstream.ChunkedStreamingTranscriber(
        t_eng, chunk_frames=8, left_context_frames=16, right_context_frames=8
    )
    total = 0
    for piece in _pieces(4, _stream(4, 1440)):
        ts.feed(piece)
        total += len(piece)
    ts.finish()
    F = 1 + (total - N_FFT) // HOP
    assert ts._emitted == F
    enc = JEncoderConfig(input_dim=16, subsample_factor=2)
    want = int(j_subsampled_lengths(np.asarray([F]), enc)[0])
    assert sum(len(lp) for lp in ts._log_probs) == want


@pytest.mark.parametrize("config", list(CONFIGS))
def test_finish_beam_matches_jax_and_keeps_the_decoder(engines, config):
    j_eng, t_eng = engines[config]
    emg = _stream(5, 1500)
    js = jstream.ChunkedStreamingTranscriber(j_eng, **GEOMETRY)
    ts = tstream.ChunkedStreamingTranscriber(t_eng, **GEOMETRY)
    for piece in _pieces(5, emg):
        js.feed(piece)
        ts.feed(piece)
    want = js.finish(beam=True)
    assert ts.finish(beam=True) == want
    assert any(want)
    assert t_eng.decoder == "greedy"


def test_concurrent_sessions_match_sequential(engines):
    """Four sessions fed from four threads, interleaved on one engine, give
    what each gives alone."""
    _, t_eng = engines["fused"]
    streams = [_stream(10 + i, 1200) for i in range(4)]
    sequential = []
    for i, emg in enumerate(streams):
        ts = tstream.ChunkedStreamingTranscriber(t_eng, **GEOMETRY)
        for piece in _pieces(10 + i, emg):
            ts.feed(piece)
        sequential.append((ts.finish(), np.concatenate(ts._log_probs)))
    results = [None] * 4
    errors = []

    def run(i):
        try:
            ts = tstream.ChunkedStreamingTranscriber(t_eng, **GEOMETRY)
            for piece in _pieces(10 + i, streams[i]):
                ts.feed(piece)
            results[i] = (ts.finish(), np.concatenate(ts._log_probs))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    for (text, lp), (want_text, want_lp) in zip(results, sequential):
        assert text == want_text
        assert np.array_equal(lp, want_lp)


def test_reset_and_bad_input(engines):
    _, t_eng = engines["default"]
    ts = tstream.ChunkedStreamingTranscriber(t_eng, **GEOMETRY)
    for piece in _pieces(6, _stream(6, 1400)):
        ts.feed(piece)
    first = ts.finish()
    assert ts._emitted > 0
    ts.reset()
    assert (ts.hypothesis, ts._emitted, ts._stats, ts.windows) == ("", 0, (0.0, 0.0, 0), 0)
    for piece in _pieces(6, _stream(6, 1400)):
        ts.feed(piece)
    assert ts.finish() == first
    ts.reset()
    ts.feed(_stream(7, 10))  # shorter than one frame: nothing to emit
    assert ts.finish() == ""
    with pytest.raises(ValueError, match=r"expected \(n, 2\) samples"):
        ts.feed(np.zeros((10, 3), np.float32))
    with pytest.raises(ValueError, match=r"expected \(n, 2\) samples"):
        ts.feed(np.zeros((10,), np.float32))


def test_sessions_evict_idle_but_never_a_busy_one(engines):
    """A session idle past the TTL is evicted when the registry is next
    used; one whose lock is held (a feed or finish in flight) is not."""
    _, t_eng = engines["default"]
    sessions = tserver.StreamSessions(t_eng, idle_ttl_sec=0.05)
    busy, idle = sessions.start(**GEOMETRY), sessions.start(**GEOMETRY)
    with sessions._sessions[busy][1]:
        time.sleep(0.1)
        fresh = sessions.start(**GEOMETRY)
        assert set(sessions._sessions) == {busy, fresh}
        with pytest.raises(tserver.UnknownSession):
            sessions.feed(idle, _stream(8, 100))
    direct = tstream.ChunkedStreamingTranscriber(t_eng, **GEOMETRY)
    direct.feed(_stream(8, 100))
    assert sessions.feed(fresh, _stream(8, 100)) == direct.hypothesis == ""  # no window yet
    assert sessions.finish(fresh) == direct.finish()
    assert fresh not in sessions._sessions
