"""Port parity: ``ssd_tpu_torch.ops.attention`` against
``ssd_tpu.ops.attention`` on the CPU, fp32.

The JAX side runs as its own tests run it here: the Pallas kernels in
interpret mode through ``fused_attention_fn`` and ``_fused_attn``, with
``jax.grad`` through their custom VJP. The port's CPU path is its plain
forward and its explicit plain backward. Tolerances are the JAX package's
own (``tests/test_fused_attention.py``): forward atol = rtol = 1e-5,
gradients atol 2e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.ops.attention import _fused_attn, fits_in_vmem, fused_attention_fn
from ssd_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

B, T, H, HD = 3, 64, 2, 16
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(seed, t=T, b=B, lengths=None):
    """q, k, v (b, t, H, HD) and per-row key lengths, from numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, H, HD)).astype(np.float32) for _ in range(3))
    if lengths is None:
        lengths = rng.integers(t // 2, t + 1, size=b)
    return q, k, v, np.asarray(lengths, np.int32)


def _key_mask(lengths, t):
    return np.arange(t)[None, :] < lengths[:, None]  # (B, T) bool


def _port(q, k, v, key_mask, mult=None, grad_out=None):
    """The port on (B, T, H, hd) numpy inputs → out (B, T, H, hd) and, when
    ``grad_out`` is given, dq, dk, dv of Σ out·grad_out."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    heads = [a.transpose(1, 2) for a in (qt, kt, vt)]  # (B, H, T, hd) views
    m = None if mult is None else torch.from_numpy(mult)
    out = tattn.fused_attention(*heads, torch.from_numpy(key_mask), m).transpose(1, 2)
    if grad_out is None:
        return out.detach().numpy()
    (out * torch.from_numpy(grad_out)).sum().backward()
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def _jax_fn(q, k, v, key_mask, grad_out):
    mask = jnp.asarray(key_mask)[:, None, None, :]

    def f(q, k, v):
        return fused_attention_fn(q, k, v, mask=mask, deterministic=True)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(grad_out))))


@pytest.mark.parametrize("case", ["key_mask", "no_mask", "fully_masked_row"])
def test_forward_and_gradients_match_jax(case):
    lengths = {"key_mask": None, "no_mask": [T] * B, "fully_masked_row": [T, 0, 17]}[case]
    q, k, v, lengths = _inputs(seed=len(case), lengths=lengths)
    km = _key_mask(lengths, T)
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    want = _jax_fn(q, k, v, km, g)
    got = _port(q, k, v, km, grad_out=g)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)


def test_padded_keys_get_exactly_zero_gradient():
    q, k, v, lengths = _inputs(seed=3)
    g = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    _, _, dk, dv = _port(q, k, v, _key_mask(lengths, T), grad_out=g)
    for b in range(B):
        assert np.all(dk[b, lengths[b]:] == 0.0) and np.all(dv[b, lengths[b]:] == 0.0)
        assert np.abs(dk[b, : lengths[b]]).max() > 0


def test_dropout_multiplier_matches_jax():
    """The same numpy (T, T) multiplier fed to ``_fused_attn(True, …)`` and
    to the port: forward and every gradient."""
    q, k, v, lengths = _inputs(seed=5)
    rng = np.random.default_rng(6)
    keep = 0.7
    mult = ((rng.random((T, T)) < keep) / keep).astype(np.float32)
    km = _key_mask(lengths, T)
    g = rng.normal(size=q.shape).astype(np.float32)

    # the Pallas call's own layout: (B, H, T, hd), kᵀ (B, H, hd, T), mask (B, 1, T)
    qh, kh, vh, gh = (jnp.asarray(np.transpose(a, (0, 2, 1, 3))) for a in (q, k, v, g))
    kmask = jnp.asarray(km[:, None, :].astype(np.int32))

    def f(qh, kth, vh):
        return _fused_attn(True, qh, kth, vh, kmask, jnp.asarray(mult))

    out, vjp = jax.vjp(f, qh, jnp.swapaxes(kh, -1, -2), vh)
    dq, dkt, dv = vjp(gh)
    want = [np.transpose(np.asarray(a), (0, 2, 1, 3))
            for a in (out, dq, jnp.swapaxes(dkt, -1, -2), dv)]
    got = _port(q, k, v, km, mult=mult, grad_out=g)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)
    # and the multiplier really changed the output
    assert not np.allclose(got[0], _port(q, k, v, km))


def test_long_sequence_past_the_jax_vmem_guard():
    """At T = 800 (H 2, hd 16, fp32: 14.2 MB > 12 MiB) the JAX function takes
    flax's route; the port runs the same fused function at every T. The two
    routes differ in rounding only."""
    t = 800
    assert not fits_in_vmem(t, HD, 4, heads=H)
    q, k, v, lengths = _inputs(seed=7, t=t, b=2)
    km = _key_mask(lengths, t)
    g = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    want = _jax_fn(q, k, v, km, g)
    got = _port(q, k, v, km, grad_out=g)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """The card's reference for the backward kernel, against autograd
    through the plain forward, with a multiplier and a padded row."""
    q, k, v, lengths = _inputs(seed=10)
    heads = [torch.from_numpy(np.transpose(a, (0, 2, 1, 3)).copy()).requires_grad_(True)
             for a in (q, k, v)]
    km = torch.from_numpy(_key_mask(lengths, T))
    mult = torch.from_numpy((np.random.default_rng(11).random((T, T)) < 0.8) / 0.8).float()
    g = torch.randn(heads[0].shape, generator=torch.Generator().manual_seed(0))
    (tattn.fused_attention_plain(*heads, km, mult) * g).sum().backward()
    got = tattn.fused_attention_bwd_plain(*(h.detach() for h in heads), km, mult, g)
    for name, a, h in zip(("dq", "dk", "dv"), got, heads):
        torch.testing.assert_close(a, h.grad, **GRAD_TOL, msg=name)


def test_cpu_tensors_take_the_plain_path_and_the_wrappers_refuse_them():
    q, k, v, lengths = _inputs(seed=12)
    before = (tattn.ATTN_FWD.launches, tattn.ATTN_BWD.launches)
    _port(q, k, v, _key_mask(lengths, T), grad_out=q)
    assert (tattn.ATTN_FWD.launches, tattn.ATTN_BWD.launches) == before
    x = torch.zeros((B, H, T, HD))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.ATTN_FWD(x, x, x, torch.ones((B, T), dtype=torch.int32))
