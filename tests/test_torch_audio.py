"""The port's host library, FLAC decoder and audio loader against the JAX
package's: FLAC decodes bit-equal to ``ssd_tpu.data.flac.decode_flac`` on
files from ``tests/torch_jax_native.py``'s encoder (mono verbatim, constant
and fixed-order-2 subframes, and stereo), ``load_audio`` equal with and
without resampling, and the native edit distance equal to the Python
program. Every test that decodes FLAC through the JAX package first makes
its native library whole in this process (``jax_native``)."""

import wave

import numpy as np
import pytest

from ssd_tpu.data import audio as jaudio
from ssd_tpu.data import flac as jflac
from ssd_tpu_torch.data import audio as taudio
from ssd_tpu_torch.data import flac as tflac
from ssd_tpu_torch.evaluation import metrics as tmetrics
from ssd_tpu_torch.utils import native

from .torch_jax_native import encode_flac, jax_native


def _mono(mode, n=1000, seed=0):
    if mode == "constant":
        return np.full(n, 1234, np.int32)
    return np.random.default_rng(seed).integers(-20000, 20000, size=n).astype(np.int32)


@pytest.mark.parametrize("mode", ["verbatim", "constant", "fixed2"])
def test_flac_mono_bit_equal_to_jax(tmp_path, mode):
    jax_native()
    data = _mono(mode)
    path = tmp_path / "m.flac"
    path.write_bytes(encode_flac([data], mode=mode))
    got, sr = tflac.decode_flac(path)
    want, want_sr = jflac.decode_flac(path)
    assert (sr, got.dtype, got.shape) == (want_sr, np.float32, (1000,))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (data / 32768.0).astype(np.float32))


def test_flac_stereo_bit_equal_to_jax(tmp_path):
    jax_native()
    rng = np.random.default_rng(1)
    left, right = (rng.integers(-30000, 30000, size=500).astype(np.int32) for _ in range(2))
    path = tmp_path / "s.flac"
    path.write_bytes(encode_flac([left, right], sample_rate=22050))
    got, sr = tflac.decode_flac(path)
    want, _ = jflac.decode_flac(path)
    assert got.shape == (500, 2) and sr == 22050
    np.testing.assert_array_equal(got, want)


def test_flac_rejects_what_is_not_flac(tmp_path):
    path = tmp_path / "x.flac"
    path.write_bytes(b"RIFF0000WAVEfmt ")
    with pytest.raises(ValueError, match="FLAC"):
        tflac.decode_flac(path)


def _write_wav(path, samples, sr, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.mark.parametrize("sr", [16000, 22050, 8000])
@pytest.mark.parametrize("fmt", ["wav", "wav_stereo", "flac"])
def test_load_audio_equals_jax(tmp_path, fmt, sr):
    rng = np.random.default_rng(2)
    if fmt == "flac":
        jax_native()
        path = tmp_path / "a.flac"
        path.write_bytes(encode_flac([_mono("verbatim", 1500, 3), _mono("verbatim", 1500, 4)],
                                      sample_rate=sr))
    else:
        channels = 2 if fmt == "wav_stereo" else 1
        path = tmp_path / "a.wav"
        _write_wav(path, rng.normal(size=1500 * channels) * 0.2, sr, channels)
    got = taudio.load_audio(path, target_sr=16000)
    want = jaudio.load_audio(path, target_sr=16000)
    assert got.dtype == np.float32 and got.ndim == 1
    assert len(got) == (1500 * 16000 + sr - 1) // sr
    np.testing.assert_array_equal(got, want)


def test_load_audio_refuses_other_formats(tmp_path):
    (tmp_path / "a.mp3").write_bytes(b"")
    with pytest.raises(ValueError, match="Unsupported audio format"):
        taudio.load_audio(tmp_path / "a.mp3", 16000)


def test_native_edit_distance_matches_python():
    rng = np.random.default_rng(2)
    vocab = list("abcdef")
    for _ in range(200):
        ref = [vocab[i] for i in rng.integers(0, 6, size=rng.integers(0, 15))]
        hyp = [vocab[i] for i in rng.integers(0, 6, size=rng.integers(0, 15))]
        assert tmetrics._edit_counts(ref, hyp) == tmetrics._edit_counts_py(ref, hyp), (ref, hyp)
    words = "the cat sat on a mat".split()
    assert tmetrics._edit_counts(words, words[::-1]) == tmetrics._edit_counts_py(words, words[::-1])


def test_host_library_is_keyed_by_its_sources():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libssd_native-")
    native.load()
    assert path.exists()
    assert native.load() is native.load()
