"""Port parity: ``ssd_tpu_torch.ops.ctc_loss`` against ``ssd_tpu.ops.ctc_loss``
on the CPU — the XLA scans (``impl="scan"``) and the Pallas kernels in
interpret mode (``impl="pallas"``) — and against ``torch.nn.functional.ctc_loss``.

On the CPU the port runs its plain recursions, the references of the CUDA
kernels (those are held to them on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssd_tpu.ops import ctc_loss as jctc
from ssd_tpu_torch.ops import ctc_loss as tctc

torch.set_num_threads(1)

BLANK = 1
V = 12
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, same op order; log1p/exp of two libms
GRAD_ATOL = 1e-5  # the one-hot product sums blank states in float64, the einsum in fp32


def _batch(seed=0, B=5, T=24, S=7):
    """Ragged lengths, a repeated-label row, an empty target and an
    impossible row (more labels than frames)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32) * 2
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    ll = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    ll[0] = T
    tg = rng.integers(2, V, size=(B, S)).astype(np.int32)
    tl = rng.integers(1, S + 1, size=B).astype(np.int32)
    if B >= 4 and S >= 4:
        tg[1, :4] = [5, 5, 6, 6]  # repeats forbid the skip
        tl[1] = max(tl[1], 4)
        tl[2] = 0  # empty target: the all-blank path
        ll[3], tl[3] = 3, S  # impossible: zero_infinity
    return lp, ll, tg, tl


def _jax(lp, ll, tg, tl, impl, g):
    args = tuple(jnp.asarray(a) for a in (ll, tg, tl))

    def f(x):
        return jnp.sum(jctc.ctc_loss(x, *args, BLANK, impl) * jnp.asarray(g))

    loss = jctc.ctc_loss(jnp.asarray(lp), *args, BLANK, impl)
    grad = jax.grad(f)(jnp.asarray(lp))
    return np.asarray(loss), np.asarray(grad)


def _port(lp, ll, tg, tl, g):
    x = torch.from_numpy(lp).requires_grad_(True)
    loss = tctc.ctc_loss(x, torch.from_numpy(ll), torch.from_numpy(tg), torch.from_numpy(tl), BLANK)
    (loss * torch.from_numpy(g)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("shape", [(5, 24, 7), (3, 1, 2)], ids=["ragged", "T1"])
def test_loss_and_grad_match_jax(impl, shape):
    B, T, S = shape
    lp, ll, tg, tl = _batch(seed=T, B=B, T=T, S=S)
    if T == 1:
        ll[:] = 1
        tl[:] = [0, 1, 2]  # blank only, one label, impossible
    g = np.random.default_rng(9).uniform(0.5, 2.0, size=B).astype(np.float32)
    want_loss, want_grad = _jax(lp, ll, tg, tl, impl, g)
    got_loss, got_grad = _port(lp, ll, tg, tl, g)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=GRAD_ATOL)
    impossible = want_loss == 0.0
    assert impossible.any() and np.all(got_grad[impossible] == 0.0)
    assert np.all(np.isfinite(got_grad))


def test_plain_recursions_match_pallas_kernels():
    """The kernels' plain versions against the Pallas α / β kernels
    (interpret mode) on the same emissions: every α, every β."""
    lp, ll, tg, tl = _batch(seed=4)
    ext, allow_skip = tctc._topology(torch.from_numpy(tg), BLANK)
    lp_ext = tctc._emissions(torch.from_numpy(lp), ext)
    S2 = ext.shape[1]
    bfinal = tctc._final_states(torch.from_numpy(tl), S2)
    skip_from = F.pad(allow_skip[:, 2:], (0, 2), value=False)
    want_a = np.asarray(jctc._forward_alphas_pallas(jnp.asarray(lp_ext.numpy()), jnp.asarray(allow_skip.numpy())))
    want_b = np.asarray(jctc._betas_pallas(
        jnp.asarray(lp_ext.numpy()), jnp.asarray(ll), jnp.asarray(bfinal.numpy()),
        jnp.asarray(skip_from.numpy()),
    ))
    got_a = tctc.forward_alphas_plain(lp_ext, allow_skip).numpy()
    got_b = tctc.betas_plain(lp_ext, torch.from_numpy(ll), bfinal, skip_from).numpy()
    for got, want in ((got_a, want_a), (got_b, want_b)):
        np.testing.assert_array_equal(got > -1e29, want > -1e29)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_reductions_match_jax(reduction):
    lp, ll, tg, tl = _batch(seed=5)
    want = jctc.ctc_loss_reduced(
        jnp.asarray(lp), jnp.asarray(ll), jnp.asarray(tg), jnp.asarray(tl), BLANK, reduction, "scan"
    )
    got = tctc.ctc_loss_reduced(
        torch.from_numpy(lp), torch.from_numpy(ll), torch.from_numpy(tg), torch.from_numpy(tl),
        BLANK, reduction,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
    with pytest.raises(ValueError, match="reduction"):
        tctc.ctc_loss_reduced(torch.from_numpy(lp), torch.from_numpy(ll), torch.from_numpy(tg),
                              torch.from_numpy(tl), BLANK, "max")


def test_values_and_logits_gradients_match_torch_ctc():
    """Torch's CTC returns exp(lp) − γ, the port −γ: through a real
    log-softmax both give the same logits gradients."""
    rng = np.random.default_rng(6)
    B, T, S = 4, 25, 6
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    _, ll, tg, tl = _batch(seed=6, B=B, T=T, S=S)

    lt = torch.from_numpy(logits).requires_grad_(True)
    want = F.ctc_loss(torch.log_softmax(lt, -1).transpose(0, 1), torch.from_numpy(tg).long(),
                      torch.from_numpy(ll).long(), torch.from_numpy(tl).long(), blank=BLANK,
                      reduction="none", zero_infinity=True)
    want.sum().backward()
    want_grad = lt.grad.clone()

    lg = torch.from_numpy(logits).requires_grad_(True)
    got = tctc.ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(ll), torch.from_numpy(tg),
                        torch.from_numpy(tl), BLANK)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lg.grad.numpy(), want_grad.numpy(), rtol=1e-3, atol=1e-4)


def test_padding_invariance():
    """Extra frames and label slots past the lengths change nothing."""
    lp, ll, tg, tl = _batch(seed=7)
    rng = np.random.default_rng(8)
    lp_pad = np.concatenate([lp, rng.normal(size=(lp.shape[0], 9, V)).astype(np.float32)], axis=1)
    tg_pad = np.concatenate([tg, rng.integers(0, V, size=(tg.shape[0], 5)).astype(np.int32)], axis=1)
    g = np.ones(lp.shape[0], np.float32)
    base_loss, base_grad = _port(lp, ll, tg, tl, g)
    pad_loss, pad_grad = _port(lp_pad, ll, tg_pad, tl, g)
    np.testing.assert_allclose(pad_loss, base_loss, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pad_grad[:, : lp.shape[1]], base_grad, rtol=0, atol=1e-6)
    assert np.all(pad_grad[:, lp.shape[1]:] == 0.0)


def test_neg_inf_arithmetic_stays_finite():
    x = torch.full((3,), tctc.NEG_INF)
    out = tctc._logaddexp(x, x)
    assert torch.isfinite(out).all() and bool((out <= tctc.NEG_INF / 2).all())


def test_cpu_tensors_never_reach_the_kernels():
    lp, ll, tg, tl = _batch(seed=1)
    before = (tctc.CTC_ALPHA.launches, tctc.CTC_BETA.launches)
    _port(lp, ll, tg, tl, np.ones(lp.shape[0], np.float32))
    assert (tctc.CTC_ALPHA.launches, tctc.CTC_BETA.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tctc.CTC_ALPHA(torch.zeros(2, 1, 3), torch.zeros(1, 3))
