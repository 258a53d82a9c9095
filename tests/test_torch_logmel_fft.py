"""The log-mel kernel's algorithm on the CPU: a float32 torch emulation of
``csrc/logmel.cu`` — the host's plan (``fft_radices``, ``fft_twiddles``,
``mel_bands``), the windowed two-frames-a-transform load, the Stockham
passes with the kernel's butterflies, the two-for-one split and the banded
mel — held to the plain version (the Pallas kernel's dense DFT) and to the
JAX featurizer. The CUDA kernel itself is held to the plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.ops import featurizer as jfeat
from ssd_tpu_torch.ops import featurizer as tfeat
from ssd_tpu_torch.ops import mel as melmod

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_featurizer.py::test_fused_matches_xla
CONFIGS = {
    "n64_hop24": dict(n_fft=64, hop_length=24, n_mels=8),  # hop ∤ n_fft
    "n320_hop10": dict(),  # tpu_fast_plus: 4·4·4·5
    "n322_hop10": dict(n_fft=322),  # 2·7·23: the generic passes
}

# the kernel's butterflies, forward sign, on (re, im) pairs
_C5A, _C5B = np.float32(np.cos(2 * np.pi / 5)), np.float32(np.cos(4 * np.pi / 5))
_S5A, _S5B = np.float32(np.sin(2 * np.pi / 5)), np.float32(np.sin(4 * np.pi / 5))
_S3 = np.float32(np.sin(np.pi / 3))


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _neg_i(a):
    return (a[1], -a[0])


def _dft(v):
    R = len(v)
    if R == 2:
        return [_add(v[0], v[1]), _sub(v[0], v[1])]
    if R == 3:
        t, d = _add(v[1], v[2]), _neg_i(_sub(v[1], v[2]))
        m = (v[0][0] - 0.5 * t[0], v[0][1] - 0.5 * t[1])
        return [_add(v[0], t), (m[0] + _S3 * d[0], m[1] + _S3 * d[1]),
                (m[0] - _S3 * d[0], m[1] - _S3 * d[1])]
    if R == 4:
        t0, t1 = _add(v[0], v[2]), _sub(v[0], v[2])
        t2, t3 = _add(v[1], v[3]), _neg_i(_sub(v[1], v[3]))
        return [_add(t0, t2), _add(t1, t3), _sub(t0, t2), _sub(t1, t3)]
    a1, b1, a2, b2 = _add(v[1], v[4]), _sub(v[1], v[4]), _add(v[2], v[3]), _sub(v[2], v[3])
    x0 = v[0]
    m1 = tuple(x0[c] + _C5A * a1[c] + _C5B * a2[c] for c in range(2))
    m2 = tuple(x0[c] + _C5B * a1[c] + _C5A * a2[c] for c in range(2))
    n1 = _neg_i(tuple(_S5A * b1[c] + _S5B * b2[c] for c in range(2)))
    n2 = _neg_i(tuple(_S5B * b1[c] - _S5A * b2[c] for c in range(2)))
    return [tuple(x0[c] + a1[c] + a2[c] for c in range(2)), _add(m1, n1), _add(m2, n2),
            _sub(m2, n2), _sub(m1, n1)]


def fft_emulated(z, radices, tw):
    """Stockham passes of the kernel on ``z`` = (re, im), each (P, N) float32;
    ``tw`` the (N, 2) twiddle table."""
    N = z[0].shape[1]
    twr, twi = torch.from_numpy(tw[:, 0]), torch.from_numpy(tw[:, 1])
    Ns = 1
    for R in radices:
        m, stride = N // R, N // (Ns * R)
        j = torch.arange(m)
        k = j % Ns
        out = (torch.empty_like(z[0]), torch.empty_like(z[1]))
        dst = (j - k) * R + k
        if R in (2, 3, 4, 5):
            v = [(z[0][:, j], z[1][:, j])]
            for r in range(1, R):
                idx = r * k * stride
                v.append(_cmul((z[0][:, j + r * m], z[1][:, j + r * m]), (twr[idx], twi[idx])))
            for r, y in enumerate(_dft(v)):
                out[0][:, dst + r * Ns], out[1][:, dst + r * Ns] = y
        else:  # the generic pass: a direct R-point sum, fp32 multiply-adds
            for ro in range(R):
                step = ((k + ro * Ns) * stride) % N
                acc = (torch.zeros_like(z[0][:, j]), torch.zeros_like(z[0][:, j]))
                for r in range(R):
                    a = (z[0][:, j + r * m], z[1][:, j + r * m])
                    w = (twr[(r * step) % N], twi[(r * step) % N])
                    acc = (acc[0] + (a[0] * w[0] - a[1] * w[1]), acc[1] + (a[0] * w[1] + a[1] * w[0]))
                out[0][:, dst + ro * Ns], out[1][:, dst + ro * Ns] = acc
        z = out
        Ns *= R
    return z


def logmel_core_emulated(emg: torch.Tensor, cfg: tfeat.FeaturizerConfig) -> torch.Tensor:
    """(B, L, C) → (B, C, T, M) the way ``csrc/logmel.cu`` computes it."""
    B, L, C = emg.shape
    N, T = cfg.n_fft, cfg.frame_count(L)
    T2 = T + T % 2  # frames go in pairs; a last odd frame pairs with one past T
    sig = emg.permute(0, 2, 1).reshape(B * C, L)
    need = (T2 - 1) * cfg.hop_length + N
    sig = torch.nn.functional.pad(sig, (0, max(0, need - L)))
    frames = sig.unfold(1, N, cfg.hop_length)[:, :T2] * torch.from_numpy(melmod.hann_window(N))
    z = (frames[:, 0::2].reshape(-1, N), frames[:, 1::2].reshape(-1, N))
    Z = fft_emulated(z, tfeat.fft_radices(N), tfeat.fft_twiddles(N))
    k = torch.arange(cfg.n_bins)
    km = (N - k) % N
    sr, si = Z[0][:, k] + Z[0][:, km], Z[1][:, k] - Z[1][:, km]
    dr, di = Z[0][:, k] - Z[0][:, km], Z[1][:, k] + Z[1][:, km]
    power = torch.stack([0.25 * (sr * sr + si * si), 0.25 * (dr * dr + di * di)], dim=1)
    power = power.reshape(B * C, T2, cfg.n_bins)[:, :T]
    lo, w = tfeat.mel_bands(
        melmod.mel_filterbank(cfg.sample_rate, N, cfg.n_mels, cfg.fmin, cfg.fmax))
    acc = torch.zeros((B * C, T, cfg.n_mels))
    for j in range(w.shape[1]):  # ascending bin order, as the kernel sums
        acc = acc + torch.from_numpy(w[:, j]) * power[:, :, torch.from_numpy(lo + j).long()]
    return (10.0 * torch.log10(torch.clamp(acc, min=1e-10))).reshape(B, C, T, cfg.n_mels)


def _batch(n_fft, seed):
    """(2, L, 8) zero-padded batch with ragged lengths and a 70 Hz tone."""
    rng = np.random.default_rng(seed)
    L = 4 * n_fft + 37
    t = np.arange(L) / 1000.0
    emg = rng.normal(size=(2, L, 8)).astype(np.float32) + np.sin(2 * np.pi * 70 * t)[None, :, None]
    lengths = np.asarray([L, L - n_fft - 41], np.int32)
    emg[1, lengths[1]:] = 0.0
    return emg.astype(np.float32), lengths


@pytest.mark.parametrize("n,want", [(320, (4, 4, 4, 5)), (64, (4, 4, 4)), (322, (2, 7, 23)),
                                    (350, (2, 5, 5, 7)), (331, (331,)), (1, ())])
def test_fft_radices(n, want):
    assert tfeat.fft_radices(n) == want
    assert int(np.prod(want)) == n


@pytest.mark.parametrize("n", [320, 64, 322, 75, 37])
def test_fft_flops_count_only_nontrivial_twiddles(n):
    """The bound's flop count, recounted butterfly by butterfly: a twiddle
    product (6 flops) only where the twiddle W^{r·k·stride} is not 1."""
    own = {2: 4, 3: 18, 4: 16, 5: 48}
    total, ns = 0, 1
    for r in tfeat.fft_radices(n):
        m, stride = n // r, n // (ns * r)
        for j in range(m):
            k = j % ns
            if r in own:
                total += own[r] + sum(6 for q in range(1, r) if (q * k * stride) % n)
            else:  # r outputs, each r terms; the roots W^{q·step} that are not 1
                for ro in range(r):
                    step = ((k + ro * ns) * stride) % n
                    total += sum(8 if (q * step) % n else 2 for q in range(1, r))
        ns *= r
    assert tfeat.fft_flops(n) == total
    if n == 320:  # 4·4·4·5: no twiddle in the first pass
        assert total == 3 * 80 * 16 + (60 + 75) * 3 * 6 + 63 * 4 * 6 + 64 * 48 == 10854


@pytest.mark.parametrize("n", [64, 320, 322, 351, 37, 2])  # 37: one generic pass alone
def test_fft_emulation_matches_numpy(n):
    rng = np.random.default_rng(n)
    z = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    re, im = fft_emulated((torch.from_numpy(z.real.astype(np.float32)),
                           torch.from_numpy(z.imag.astype(np.float32))),
                          tfeat.fft_radices(n), tfeat.fft_twiddles(n))
    want = np.fft.fft(z, axis=1)
    got = re.numpy().astype(np.float64) + 1j * im.numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_fft_twiddles_are_the_roots_of_unity():
    n = 322
    tw = tfeat.fft_twiddles(n)
    assert tw.dtype == np.float32 and tw.shape == (n, 2)
    want = np.exp(-2j * np.pi * np.arange(n) / n)  # float64, rounded once to float32
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], want, rtol=0, atol=6e-8)


@pytest.mark.parametrize("kw,width", [({}, 4), ({"n_fft": 64, "n_mels": 8}, 7), ({"n_fft": 322}, 4),
                                      ({"n_fft": 350}, 5), ({"n_fft": 16}, 1),
                                      ({"n_fft": 4, "n_mels": 2}, 1)])
def test_mel_bands_scatter_back_exactly(kw, width):
    cfg = tfeat.FeaturizerConfig(**kw)
    fb = melmod.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    lo, w = tfeat.mel_bands(fb)
    assert lo.dtype == np.int32 and w.dtype == np.float32 and w.shape == (cfg.n_mels, width)
    assert int(lo.min()) >= 0 and int((lo + width).max()) <= cfg.n_bins
    back = np.zeros_like(fb)
    for m in range(cfg.n_mels):
        back[m, lo[m] : lo[m] + width] = w[m]
    np.testing.assert_array_equal(back, fb)


def test_mel_filterbank_is_sparse():
    """At tpu_fast_plus width 316 of the 80 × 161 weights are non-zero, at
    most 4 a filter: what the banded projection exploits."""
    fb = melmod.mel_filterbank(1000, 320, 80)
    assert np.count_nonzero(fb) == 316 and int((fb != 0).sum(axis=1).max()) == 4


@pytest.mark.parametrize("name", list(CONFIGS))
def test_emulation_matches_plain_and_jax(name):
    kw = CONFIGS[name]
    cfg = tfeat.FeaturizerConfig(**kw)
    emg, lengths = _batch(cfg.n_fft, seed=len(name))
    x, lens = torch.from_numpy(emg), torch.from_numpy(lengths)
    emulated = tfeat.normalize_logmels(logmel_core_emulated(x, cfg), lens, cfg)
    plain = tfeat.normalize_logmels(tfeat.logmel_core_plain(x, cfg), lens, cfg)
    # the JAX fused route in interpret mode where hop divides n_fft, else its XLA route
    jx = jfeat.logmel_batch(jnp.asarray(emg), jnp.asarray(lengths), jfeat.FeaturizerConfig(**kw),
                            fused=cfg.n_fft % cfg.hop_length == 0)
    np.testing.assert_array_equal(emulated[1].numpy(), np.asarray(jx[1]))
    for want in (plain[0].numpy(), np.asarray(jx[0])):
        np.testing.assert_allclose(emulated[0].numpy(), want, **TOL)


def test_emulation_gives_the_floor_on_silent_frames():
    """Frames wholly in the zero padding: power 0, exactly the −100 dB floor."""
    cfg = tfeat.FeaturizerConfig(n_fft=64, hop_length=16, n_mels=8)
    emg = torch.zeros((1, 400, 2))
    emg[0, :100] = 1.0
    out = logmel_core_emulated(emg, cfg)
    silent = out[0, :, (100 + 64) // 16 + 1:]
    assert silent.numel() > 0
    assert bool((silent == tfeat.logmel_core_plain(emg, cfg)[0, :, (100 + 64) // 16 + 1:]).all())
    assert bool((silent == 10.0 * torch.log10(torch.tensor(1e-10))).all())


@pytest.mark.parametrize(
    "kw,shape,match",
    [({"n_fft": 512}, (1, 4000, 8), "n_bins"),
     ({"n_mels": 96}, (1, 4000, 8), "n_mels"),
     ({}, (8192, 400, 8), "signal rows"),
     ({"hop_length": 60000}, (1, 130000, 8), "shared memory"),
     ({}, (1, 100, 8), "shorter than n_fft")],
)
def test_kernel_limits_raise_before_any_build(kw, shape, match):
    kernel = tfeat.LogmelKernel()
    with pytest.raises(ValueError, match=match):
        kernel.geometry(tfeat.FeaturizerConfig(**kw), *shape)
    assert kernel.library._lib is None and kernel.launches == 0


def test_kernel_geometry_sizes_frames_to_shared_memory(monkeypatch):
    monkeypatch.setattr(tfeat, "FRAMES_PER_CTA", 64)
    kernel = tfeat.LogmelKernel()
    assert kernel.geometry(tfeat.FeaturizerConfig(n_fft=350), 8, 12800, 8)[1] == 64
    wide = tfeat.FeaturizerConfig(n_fft=350, hop_length=2000)
    T, frames = kernel.geometry(wide, 1, 40000, 8)
    assert frames < 64 and tfeat.logmel_smem_bytes(frames, 2000, 350) <= tfeat.SMEM_LIMIT
    assert tfeat.logmel_smem_bytes(2 * frames, 2000, 350) > tfeat.SMEM_LIMIT
    assert T == wide.frame_count(40000)
