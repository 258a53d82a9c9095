"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions. They skip without a card. This file imports neither JAX nor
``ssd_tpu``, so it also runs on a card machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ssd_tpu_torch.ops import featurizer as feat

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's contract
    return torch.device("cuda")


@pytest.mark.parametrize(
    "B,L,cfg_kw",
    [
        (1, 12800, {}),
        (8, 12800, {}),
        (3, 2000, {}),  # ragged last frame block
        (2, 3000, {"n_fft": 64, "hop_length": 24, "n_mels": 8}),  # hop ∤ n_fft
    ],
)
def test_logmel_kernel_matches_plain(cuda, B, L, cfg_kw):
    cfg = feat.FeaturizerConfig(**cfg_kw)
    rng = np.random.default_rng(B)
    emg = torch.from_numpy(rng.normal(size=(B, L, 8)).astype(np.float32)).to(cuda)
    lens = torch.from_numpy(rng.integers(cfg.n_fft, L + 1, size=B)).to(cuda)
    before = feat.LOGMEL.launches
    got = feat.logmel_core(emg, cfg)
    assert feat.LOGMEL.launches == before + 1
    want = feat.logmel_core_plain(emg, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, 8, cfg.frame_count(L), cfg.n_mels)
    a = feat.normalize_logmels(got, lens, cfg)[0]
    b = feat.normalize_logmels(want, lens, cfg)[0]
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_logmel_kernel_rejects_bad_cuda_input(cuda):
    cfg = feat.FeaturizerConfig()
    x = torch.zeros((2, 12800, 8), device=cuda)
    with pytest.raises(TypeError):
        feat.LOGMEL(x.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        feat.LOGMEL(x.transpose(0, 1), cfg)
    with pytest.raises(ValueError, match="n_bins"):
        feat.LOGMEL(x, feat.FeaturizerConfig(n_fft=512))
