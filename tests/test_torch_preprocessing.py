"""The port's preprocessing CLI (``ssd_tpu_torch/data/preprocessing.py``)
against the JAX package's on one raw tree: ``--mode emg`` caches (values
within atol = rtol = 2e-4, the same ``.json`` fields), the idempotent skip,
double buffering bit-identical, the bf16 fetch stored as float32, and
``--mode teacher`` against ``process_teacher_rows`` with one set of small
WavLM weights (WAV at 16 and 22.05 kHz, FLAC)."""

import json
import wave

import numpy as np
import pytest
import torch

from ssd_tpu.data import preprocessing as jpre
from ssd_tpu.data.index_dataset import load_index as jax_load_index
from ssd_tpu.models import wavlm as jwavlm
from ssd_tpu.ops.featurizer import FeaturizerConfig as JFeaturizerConfig
from ssd_tpu_torch.data import index_dataset as tidx
from ssd_tpu_torch.data import preprocessing as tpre
from ssd_tpu_torch.models import wavlm as twavlm
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig

from .test_native import _encode_flac
from .test_torch_logging import restored_logging
from .test_wavlm import SMALL, torch_wavlm  # noqa: F401  (fixture)

torch.set_num_threads(1)

EMG_TOL = dict(atol=2e-4, rtol=2e-4)
TEACHER_TOL = dict(atol=2e-4, rtol=2e-3)
EMG_LENGTHS = (1500, 2750, 640, 3300, 2000)
FEATURES = dict(sample_rate=1000, n_fft=320, hop_length=10, n_mels=80)
CLI_FEATURES = ["--emg-n-fft", "320", "--emg-hop-length", "10"]


def _write_wav(path, samples, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())


def _row(i, audio):
    return dict(utterance_id=f"voiced_parallel_data/s1/{i}_0", split="voiced_parallel_data",
                subset="train", speaker="s1", stem=f"{i}_0",
                emg_path=f"voiced_parallel_data/s1/{i}_0_emg.npy", audio_path=audio,
                transcript="x", sentence_index=i, book="", has_audio=audio is not None,
                metadata_json="{}")


@pytest.fixture
def raw_tree(tmp_path):
    """Five utterances: EMG of several lengths; audio as WAV at 16 kHz, WAV
    at 22.05 kHz, FLAC, and none (two rows)."""
    rng = np.random.default_rng(0)
    root = tmp_path / "emg_data"
    d = root / "voiced_parallel_data" / "s1"
    d.mkdir(parents=True)
    audio = {0: "wav16", 1: "wav22", 2: "flac"}
    rows = []
    for i, n in enumerate(EMG_LENGTHS):
        np.save(d / f"{i}_0_emg.npy", (rng.normal(size=(n, 8)) * 50).astype(np.float32))
        kind = audio.get(i)
        rel = None
        if kind == "flac":
            rel = f"voiced_parallel_data/s1/{i}_0_audio.flac"
            pcm = rng.integers(-8000, 8000, size=5000).astype(np.int32)
            (root / rel).write_bytes(_encode_flac([pcm], sample_rate=16000))
        elif kind:
            sr = 16000 if kind == "wav16" else 22050
            rel = f"voiced_parallel_data/s1/{i}_0_audio.wav"
            _write_wav(root / rel, rng.normal(size=int(0.4 * sr) + 37 * i) * 0.2, sr)
        rows.append(_row(i, rel))
    index = tmp_path / "index.jsonl"
    tidx.save_index(rows, index)
    return root, index


def _jax_rows(index):
    return list(jax_load_index(index).itertuples(index=False))


def _cache(out, i):
    uid = f"voiced_parallel_data/s1/{i}_0"
    return np.load(out / f"{uid}.npy"), json.loads((out / f"{uid}.json").read_text())


def test_emg_cli_matches_jax(raw_tree, tmp_path):
    root, index = raw_tree
    cfg = JFeaturizerConfig(**FEATURES)
    assert jpre.process_emg_rows(_jax_rows(index), root, tmp_path / "jax", cfg, overwrite=False,
                                 fused=False, batch_size=2) == len(EMG_LENGTHS)
    argv = ["--mode", "emg", "--index", str(index), "--root", str(root), "--out",
            str(tmp_path / "torch"), "--device", "cpu", "--batch-size", "2", "--no-fused",
            *CLI_FEATURES]
    with restored_logging():
        tpre.main(argv)
    for i in range(len(EMG_LENGTHS)):
        (got, gmeta), (want, wmeta) = _cache(tmp_path / "torch", i), _cache(tmp_path / "jax", i)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **EMG_TOL)
        assert gmeta.keys() == wmeta.keys()
        for k in gmeta:
            if k in ("mean", "std"):
                assert gmeta[k] == pytest.approx(wmeta[k], rel=1e-5, abs=1e-4), k
            else:
                assert gmeta[k] == wmeta[k], k


@pytest.mark.parametrize("normalize", ["none", "per_file"])
def test_emg_rows_match_jax_with_reference_defaults(raw_tree, tmp_path, normalize):
    """The reference CLI's defaults (n_fft 400, hop 160) and ``--emg-normalize``."""
    root, index = raw_tree
    kw = dict(sample_rate=1000, n_fft=400, hop_length=160, n_mels=80, normalize=normalize)
    jpre.process_emg_rows(_jax_rows(index), root, tmp_path / "jax", JFeaturizerConfig(**kw),
                          overwrite=False, fused=False)
    tpre.process_emg_rows(tidx.load_index(index), root, tmp_path / "torch",
                          FeaturizerConfig(**kw), overwrite=False, device="cpu")
    for i in range(len(EMG_LENGTHS)):
        (got, gmeta), (want, wmeta) = _cache(tmp_path / "torch", i), _cache(tmp_path / "jax", i)
        np.testing.assert_allclose(got, want, **EMG_TOL)
        assert ("mean" in gmeta) == ("mean" in wmeta) == (normalize == "per_file")


def test_emg_idempotent_skip_and_limit(raw_tree, tmp_path):
    root, index = raw_tree
    rows, cfg, out = tidx.load_index(index), FeaturizerConfig(**FEATURES), tmp_path / "out"
    assert tpre.process_emg_rows(rows, root, out, cfg, overwrite=False, limit=2,
                                 device="cpu") == 2
    assert tpre.process_emg_rows(rows, root, out, cfg, overwrite=False, device="cpu") == 3
    assert tpre.process_emg_rows(rows, root, out, cfg, overwrite=False, device="cpu") == 0
    assert tpre.process_emg_rows(rows, root, out, cfg, overwrite=True, device="cpu") == 5


def test_double_buffer_bit_identical(raw_tree, tmp_path):
    root, index = raw_tree
    rows, cfg = tidx.load_index(index), FeaturizerConfig(**FEATURES)
    for name, db in (("seq", False), ("db", True)):
        # batch 2 over 5 rows: three flushes, the k / k+1 overlap and the drain
        n = tpre.process_emg_rows(rows, root, tmp_path / name, cfg, overwrite=False,
                                  batch_size=2, double_buffer=db, device="cpu")
        assert n == len(EMG_LENGTHS)
    for i in range(len(EMG_LENGTHS)):
        (a, ma), (b, mb) = _cache(tmp_path / "seq", i), _cache(tmp_path / "db", i)
        np.testing.assert_array_equal(a, b)
        assert ma == mb


def test_bf16_fetch_stored_as_fp32(raw_tree, tmp_path):
    """The bf16 fetch is the fp32 features rounded to bf16 (on the device)
    and stored as float32; within one bf16 step of JAX's bf16 fetch."""
    root, index = raw_tree
    rows, cfg = tidx.load_index(index), FeaturizerConfig(**FEATURES)
    tpre.process_emg_rows(rows, root, tmp_path / "f32", cfg, overwrite=False, device="cpu")
    tpre.process_emg_rows(rows, root, tmp_path / "bf16", cfg, overwrite=False,
                          fetch_dtype="bfloat16", device="cpu")
    jpre.process_emg_rows(_jax_rows(index), root, tmp_path / "jax", JFeaturizerConfig(**FEATURES),
                          overwrite=False, fused=False, fetch_dtype="bfloat16")
    for i in range(len(EMG_LENGTHS)):
        (a, ma), (b, mb) = _cache(tmp_path / "f32", i), _cache(tmp_path / "bf16", i)
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(b, torch.from_numpy(a).to(torch.bfloat16).float().numpy())
        assert ma == mb  # the statistics are the fp32 path's
        want, _ = _cache(tmp_path / "jax", i)
        np.testing.assert_allclose(b, want, rtol=2.0 ** -7, atol=1e-3)  # one bf16 step
    with pytest.raises(ValueError, match="fetch_dtype"):
        tpre.process_emg_rows(rows, root, tmp_path / "x", cfg, overwrite=False,
                              fetch_dtype="float16", device="cpu")


def test_teacher_cli_matches_jax(raw_tree, tmp_path, torch_wavlm, monkeypatch):  # noqa: F811
    """``--mode teacher`` on small random weights written by the port's
    safetensors writer: the rows with audio (WAV at 16 and 22.05 kHz, FLAC)
    against ``process_teacher_rows`` with the same weights in flax."""
    root, index = raw_tree
    small = SMALL
    jteacher = jwavlm.WavLMTeacher.from_torch_model(torch_wavlm, layer=2,
                                                    cfg=jwavlm.WavLMConfig(**small))
    assert jpre.process_teacher_rows(_jax_rows(index), root, tmp_path / "jax", model_name="m",
                                     layer=2, sample_rate=16000, overwrite=False,
                                     teacher=jteacher) == 3
    weights = tmp_path / "wavlm.safetensors"
    twavlm.save_safetensors({k: v.detach().numpy() for k, v in torch_wavlm.state_dict().items()},
                            weights)
    load = twavlm.WavLMTeacher.from_pretrained.__func__
    monkeypatch.setattr(twavlm.WavLMTeacher, "from_pretrained", classmethod(
        lambda cls, name, layer=9, cfg=None, device="cuda":
        load(cls, name, layer, twavlm.WavLMConfig(**small), device)))
    argv = ["--mode", "teacher", "--index", str(index), "--root", str(root), "--out",
            str(tmp_path / "torch"), "--device", "cpu", "--teacher-model", str(weights),
            "--teacher-layer", "2", "--batch-size", "2"]
    with restored_logging():
        tpre.main(argv)
    for i in range(3):
        (got, gmeta), (want, wmeta) = _cache(tmp_path / "torch", i), _cache(tmp_path / "jax", i)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TEACHER_TOL)
        assert {k: v for k, v in gmeta.items() if k != "model_name"} == \
            {k: v for k, v in wmeta.items() if k != "model_name"}
    assert not (tmp_path / "torch" / "voiced_parallel_data/s1/3_0.npy").exists()  # no audio
    with restored_logging():  # the idempotent skip
        tpre.main(argv)
    assert len(list((tmp_path / "torch").rglob("*.npy"))) == 3


def test_cli_needs_the_card_unless_asked_for_the_cpu(raw_tree, tmp_path, monkeypatch):
    root, index = raw_tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"), restored_logging():
        tpre.main(["--mode", "emg", "--index", str(index), "--root", str(root),
                   "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
