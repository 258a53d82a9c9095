"""Port parity: ``ssd_tpu_torch.ops.featurizer`` (plain CPU path, the same
arithmetic as the CUDA kernel) against the JAX featurizer, both its XLA
path and its Pallas kernel in interpret mode, and against the pinned golden.
The CUDA kernel itself is held to this plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.ops import featurizer as jfeat
from ssd_tpu_torch.ops import featurizer as tfeat

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_featurizer.py::test_fused_matches_xla


def _emg(n=1711, c=8, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 1000.0
    sig = rng.normal(size=(n, c)).astype(np.float32)
    sig += np.sin(2 * np.pi * 70.0 * t)[:, None].astype(np.float32)
    return sig


def _batch(seed=1):
    """(2, 1711+577, 8) padded batch with ragged lengths."""
    emg = _emg(seed=seed)
    n = emg.shape[0]
    padded = np.zeros((2, n + 577, 8), np.float32)
    padded[0, :n] = emg
    padded[1, : n - 500] = emg[: n - 500]
    return padded, np.asarray([n, n - 500], np.int32)


def _torch(padded, lengths, cfg_kw):
    out = tfeat.logmel_batch(
        torch.from_numpy(padded), torch.from_numpy(lengths), tfeat.FeaturizerConfig(**cfg_kw)
    )
    return [o.numpy() for o in out]


def _jax(padded, lengths, cfg_kw, fused):
    out = jfeat.logmel_batch(
        jnp.asarray(padded), jnp.asarray(lengths), jfeat.FeaturizerConfig(**cfg_kw), fused=fused
    )
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("normalize", ["per_file", "none"])
def test_logmel_batch_matches_jax(fused, normalize):
    padded, lengths = _batch()
    kw = dict(normalize=normalize)
    got = _torch(padded, lengths, kw)
    want = _jax(padded, lengths, kw, fused)
    np.testing.assert_array_equal(got[1], want[1])  # frame lengths
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[2], want[2], **TOL)  # means
    np.testing.assert_allclose(got[3], want[3], **TOL)  # stds


def test_logmel_core_hop_not_dividing_n_fft():
    """The JAX fused path gives up to XLA when n_fft % hop != 0; the port's
    core indexes samples directly and takes any hop."""
    padded, lengths = _batch(seed=3)
    kw = dict(n_fft=64, hop_length=24, n_mels=8)
    got = _torch(padded, lengths, kw)
    want = _jax(padded, lengths, kw, fused=False)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], **TOL)


def test_logmel_pinned_golden():
    """Same slice as tests/test_featurizer.py::test_logmel_pinned_regression_golden."""
    emg = _emg()
    feats, lengths, _, _ = tfeat.logmel_batch(
        torch.from_numpy(emg[None]), torch.tensor([len(emg)]), tfeat.FeaturizerConfig()
    )
    sub = feats[0, : int(lengths[0])][:6, :3, :10].numpy()
    want = np.load(Path(__file__).parent / "goldens" / "logmel_r2.npz")["sub"]
    np.testing.assert_allclose(sub, want, atol=1e-5, rtol=1e-5)


def test_batch_padding_invariance():
    padded, lengths = _batch()
    feats, flen, _, _ = _torch(padded, lengths, {})
    for i in range(2):
        n = int(lengths[i])
        single, slen, _, _ = _torch(padded[i : i + 1, :n], lengths[i : i + 1], {})
        T = int(flen[i])
        assert T == int(slen[0]) == tfeat.FeaturizerConfig().frame_count(n)
        np.testing.assert_allclose(feats[i, :T], single[0, :T], **TOL)
        assert np.all(feats[i, T:] == 0)


def test_frame_lengths_floor_and_clamp():
    """Lengths below n_fft floor negative and clamp at 0 (featurizer.py:127-130)."""
    cfg = tfeat.FeaturizerConfig(n_fft=64, hop_length=16, n_mels=8)
    emg = torch.zeros((4, 256, 2))
    lens = torch.tensor([0, 63, 64, 1000])
    _, flen, _, _ = tfeat.logmel_batch(emg, lens, cfg)
    assert flen.dtype == torch.int32
    assert flen.tolist() == [0, 0, 1, cfg.frame_count(256)]


def test_logmel_kernel_rejects_bad_input():
    """The wrapper checks before it builds or launches anything."""
    cfg = tfeat.FeaturizerConfig()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfeat.LOGMEL(torch.zeros((1, 400, 8)), cfg)
    assert tfeat.LOGMEL.launches == 0
