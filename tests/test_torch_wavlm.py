"""The port's WavLM (``ssd_tpu_torch/models/wavlm.py``) against the JAX
package's flax WavLM with one state dict (a small random HF ``WavLMModel``,
as ``tests/test_wavlm.py`` builds it): the relative-position buckets, every
``hidden_states[i]`` (atol 2e-4 / rtol 2e-3), the padded batch path against
per-utterance extraction, the port's safetensors reader and writer, and a
hub name with nothing local raising."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.models import wavlm as jwavlm
from ssd_tpu_torch.models import teacher as tteacher
from ssd_tpu_torch.models import wavlm as twavlm

from .test_wavlm import SMALL, torch_wavlm  # noqa: F401  (fixture)

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-3)


def _port(hf, layer=2):
    cfg = twavlm.WavLMConfig(**SMALL)
    sd = twavlm.convert_state_dict(hf.state_dict(), twavlm.WavLMModel(cfg))
    return twavlm.WavLMTeacher(cfg, sd, layer=layer, device="cpu")


@pytest.mark.parametrize("q,k,nb,md", [(50, 50, 40, 100), (300, 300, 320, 800),
                                       (7, 900, 320, 800)])
def test_buckets_equal_jax(q, k, nb, md):
    np.testing.assert_array_equal(twavlm.relative_position_buckets(q, k, nb, md),
                                  jwavlm.relative_position_buckets(q, k, nb, md))


@pytest.mark.parametrize("padded", [False, True], ids=["single", "padded_batch"])
def test_every_hidden_state_matches_flax(torch_wavlm, padded):  # noqa: F811
    """Each ``hidden_states[i]`` of the port against ``FlaxWavLM`` on the same
    converted weights; the padded case on a two-row batch with valid counts."""
    cfg = jwavlm.WavLMConfig(**SMALL)
    params = jwavlm.WavLMTeacher.from_torch_model(torch_wavlm, layer=2, cfg=cfg).params
    port = _port(torch_wavlm).model
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1600)).astype(np.float32)
    n = np.asarray([1600, 1111], np.int32)
    if padded:
        x[1, n[1]:] = 0.0
        want = jwavlm.FlaxWavLM(cfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(n))
        with torch.inference_mode():
            got = port(torch.from_numpy(x), torch.from_numpy(n.astype(np.int64)))
    else:
        want = jwavlm.FlaxWavLM(cfg).apply({"params": params}, jnp.asarray(x))
        with torch.inference_mode():
            got = port(torch.from_numpy(x))
    assert len(got) == len(want) == SMALL["num_hidden_layers"] + 1
    frames = jwavlm.conv_output_lengths(cfg, n) if padded else None
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        if padded:  # valid frames only: beyond them the two paths differ freely
            for b in range(2):
                np.testing.assert_allclose(g[b, : frames[b]], w[b, : frames[b]], **TOL,
                                           err_msg=f"hidden_states[{i}] row {b}")
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"hidden_states[{i}]")


def test_extract_matches_flax_teacher(torch_wavlm):  # noqa: F811
    jt = jwavlm.WavLMTeacher.from_torch_model(torch_wavlm, layer=2,
                                              cfg=jwavlm.WavLMConfig(**SMALL))
    wave = (np.random.default_rng(4).normal(size=2400) * 0.3 + 0.1).astype(np.float32)
    np.testing.assert_allclose(_port(torch_wavlm).extract(wave), jt.extract(wave), **TOL)


def test_extract_batch_matches_per_utterance(torch_wavlm):  # noqa: F811
    teacher = _port(torch_wavlm)
    rng = np.random.default_rng(7)
    waves = [rng.normal(size=(L,)).astype(np.float32) for L in (400, 873, 1290, 640)]
    singles = [teacher.extract(w) for w in waves]
    batched = teacher.extract_batch(waves, sample_bucket=256)
    assert len(batched) == len(singles)
    for got, want in zip(batched, singles):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_extract_batch_bucket_shapes_and_empty(torch_wavlm):  # noqa: F811
    teacher = _port(torch_wavlm, layer=1)
    cfg = teacher.cfg
    assert teacher.extract_batch([]) == []
    out = teacher.extract_batch([np.random.default_rng(0).normal(size=300).astype(np.float32)],
                                sample_bucket=256)
    assert out[0].shape == (int(twavlm.conv_output_lengths(cfg, 300)), cfg.hidden_size)
    assert out[0].dtype == np.float32


def test_safetensors_reader_matches_the_library(tmp_path, torch_wavlm):  # noqa: F811
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(5)
    tensors = {"a": rng.normal(size=(3, 4)).astype(np.float32),
               "b": rng.integers(-9, 9, size=(5,)).astype(np.int64),
               "c": rng.normal(size=(2, 2, 2)).astype(np.float16),
               "d": np.zeros((0, 3), np.float32)}
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    twavlm.save_safetensors(tensors, tmp_path / "port.safetensors")
    for name in ("lib", "port"):
        want = load_file(str(tmp_path / f"{name}.safetensors"))
        got = twavlm.load_safetensors(tmp_path / f"{name}.safetensors")
        assert got.keys() == want.keys() == tensors.keys()
        for k in tensors:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
    # bf16 comes back as float32, exactly
    bf = torch.tensor([1.5, -2.0, 3.140625], dtype=torch.bfloat16)
    from safetensors.torch import save_file as save_torch

    save_torch({"w": bf}, str(tmp_path / "bf.safetensors"))
    np.testing.assert_array_equal(twavlm.load_safetensors(tmp_path / "bf.safetensors")["w"],
                                  bf.float().numpy())


def test_from_pretrained_reads_an_hf_checkpoint(tmp_path, torch_wavlm):  # noqa: F811
    """``save_pretrained``'s directory (weight-normed positional conv, HF
    names) and the file inside it, and a ``wavlm.``-prefixed file written by
    the port's own writer, all load into one teacher's weights."""
    torch_wavlm.save_pretrained(tmp_path / "hf", safe_serialization=True)
    cfg = twavlm.WavLMConfig(**SMALL)
    want = _port(torch_wavlm)
    wave = np.random.default_rng(6).normal(size=1800).astype(np.float32)
    ref = want.extract(wave)
    prefixed = {f"wavlm.{k}": v.detach().numpy() for k, v in torch_wavlm.state_dict().items()}
    twavlm.save_safetensors(prefixed, tmp_path / "prefixed.safetensors")
    st_file = sorted((tmp_path / "hf").glob("*.safetensors"))[0]
    for src in (tmp_path / "hf", st_file, tmp_path / "prefixed.safetensors"):
        t = twavlm.WavLMTeacher.from_pretrained(str(src), layer=2, cfg=cfg, device="cpu")
        np.testing.assert_allclose(t.extract(wave), ref, atol=1e-6, rtol=1e-6)


def test_from_pretrained_missing_weights_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="local .safetensors"):
        twavlm.WavLMTeacher.from_pretrained("definitely/not-a-model-anywhere", device="cpu")
    with pytest.raises(FileNotFoundError, match="local .safetensors"):
        twavlm.WavLMTeacher.from_pretrained(str(tmp_path), device="cpu")  # a dir without one
    with pytest.raises(FileNotFoundError):
        tteacher.FrozenWavLM(tteacher.TeacherConfig(), device="cpu")


def test_convert_state_dict_refuses_missing_and_misshapen_weights(torch_wavlm):  # noqa: F811
    cfg = twavlm.WavLMConfig(**SMALL)
    state = {k: v.detach().numpy() for k, v in torch_wavlm.state_dict().items()}
    del state["encoder.layers.0.attention.q_proj.weight"]
    with pytest.raises(KeyError, match="q_proj"):
        twavlm.convert_state_dict(state, twavlm.WavLMModel(cfg))
    bigger = twavlm.WavLMModel(twavlm.WavLMConfig(**{**SMALL, "hidden_size": 64}))
    with pytest.raises(ValueError, match="shape"):
        twavlm.convert_state_dict(torch_wavlm.state_dict(), bigger)


def test_frozen_wavlm_resamples(tmp_path, torch_wavlm, monkeypatch):  # noqa: F811
    port = _port(torch_wavlm)
    monkeypatch.setattr(twavlm.WavLMTeacher, "from_pretrained",
                        classmethod(lambda cls, *a, **k: port))
    frozen = tteacher.FrozenWavLM(tteacher.TeacherConfig(model_name="local", layer=2),
                                  device="cpu")
    wave = np.random.default_rng(8).normal(size=800).astype(np.float32)
    from scipy.signal import resample_poly

    want = port.extract(resample_poly(wave, 2, 1).astype(np.float32))
    np.testing.assert_array_equal(frozen(wave, sampling_rate=8000), want)
