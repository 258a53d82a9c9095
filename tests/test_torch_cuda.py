"""Card-only tests of the port's CUDA kernels (log-mel, CTC α and β) against
their plain PyTorch versions. They skip without a card. This file imports neither JAX nor
``ssd_tpu``, so it also runs on a card machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ssd_tpu_torch.ops import ctc_loss as ctc
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


def _ctc_case(B, T, S, seed):
    """Emissions and masks at (B, T, S) with random lengths, plus a row with
    an empty target, an impossible row and a row of repeated labels."""
    rng = np.random.default_rng(seed)
    V = 48
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(B, T, V)).astype(np.float32)) * 3, -1)
    ll = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    tl = rng.integers(S // 2, S + 1, size=B).astype(np.int32)
    tg = rng.integers(2, V, size=(B, S)).astype(np.int32)
    tl[1] = 0
    ll[2], tl[2] = 3, S
    tg[3, :] = 7
    ext, skip = ctc._topology(torch.from_numpy(tg), 1)
    lp_ext = ctc._emissions(lp, ext)
    bfinal = ctc._final_states(torch.from_numpy(tl), ext.shape[1])
    skip_from = torch.nn.functional.pad(skip[:, 2:], (0, 2), value=False)
    return lp_ext, skip, torch.from_numpy(ll), bfinal, skip_from


def _assert_recursion_close(got, want):
    finite = want > -1e29
    assert torch.equal(got > -1e29, finite)
    torch.testing.assert_close(got[finite], want[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,T,S", [(5, 640, 160), (32, 384, 128), (4, 1, 3), (4, 9, 1)])
def test_ctc_kernels_match_plain(cuda, B, T, S):
    lp_ext, skip, ll, bfinal, skip_from = _ctc_case(B, T, S, seed=T)
    want_a = ctc.forward_alphas_plain(lp_ext, skip)
    want_b = ctc.betas_plain(lp_ext, ll, bfinal, skip_from)
    before = (ctc.CTC_ALPHA.launches, ctc.CTC_BETA.launches)
    got_a = ctc.forward_alphas(lp_ext.to(cuda), skip.to(cuda))
    got_b = ctc.betas(lp_ext.to(cuda), ll.to(cuda), bfinal.to(cuda), skip_from.to(cuda))
    torch.cuda.synchronize()
    assert (ctc.CTC_ALPHA.launches, ctc.CTC_BETA.launches) == (before[0] + 1, before[1] + 1)
    _assert_recursion_close(got_a.cpu(), want_a)
    _assert_recursion_close(got_b.cpu(), want_b)


def test_ctc_wrappers_reject_bad_cuda_input(cuda):
    lp = torch.zeros((4, 2, 7), device=cuda)
    skip = torch.zeros((2, 7), device=cuda)
    lens = torch.full((2,), 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ctc.CTC_ALPHA(lp.double(), skip)
    with pytest.raises(ValueError, match="contiguous"):
        ctc.CTC_ALPHA(lp.transpose(0, 1).contiguous().transpose(0, 1), skip)
    with pytest.raises(ValueError, match="shape"):
        ctc.CTC_ALPHA(lp, skip[:, :5])
    with pytest.raises(ValueError, match="non-empty"):
        ctc.CTC_ALPHA(lp[:0], skip)
    with pytest.raises(TypeError):
        ctc.CTC_BETA(lp, skip, skip, lens.long())
    with pytest.raises(ValueError, match="CUDA"):
        ctc.CTC_BETA(lp, skip, skip.cpu(), lens)
