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


# --------------------------------------------------------------------------
# The card kernels' arithmetic, emulated on the CPU
# --------------------------------------------------------------------------
#
# csrc/attention.cu runs every product on the tensor cores as 3×TF32: each
# fp32 operand x splits into big = tf32(x) (cvt.rna: round to nearest, ties
# away from zero, on the 13 low mantissa bits) and small = tf32(x − big),
# and small·big + big·small + big·big is summed in fp32 (small·small is
# dropped). These tests hold that arithmetic to the fp32 tolerances against
# float64, and show that a single TF32 product (1×TF32) would not meet them.


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the fp32 mantissa to 10 bits, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _attention_with_products(q, k, v, key_mask, mult, g, mm):
    """The forward and the three gradients with every T × T × hd product
    through ``mm``, the rest in fp32 as the kernels do it: out, dq, dk, dv."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    s = s.masked_fill(key_mask[:, None, None, :] == 0, tattn.MASKED)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    out = mm(w * mult, v)
    dp = mm(g, v.transpose(-1, -2))
    D = (w * mult * dp).sum(dim=-1, keepdim=True)
    ds = w * (dp * mult - D) * scale
    return out, mm(ds, k), mm(ds.transpose(-1, -2), q), mm((w * mult).transpose(-1, -2), g)


@pytest.fixture(scope="module")
def full_width_case():
    """B 2, H 6, T′ 640, hd 48 (tpu_fast_plus at the config's bucket), a
    dropout multiplier at rate 0.12 and a padded batch row; the float64
    plain versions as the reference."""
    rng = np.random.default_rng(20)
    b, h, t, hd = 2, 6, 640, 48
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, t, hd)).astype(np.float32))
                  for _ in range(4))
    km = torch.from_numpy(_key_mask(np.array([t, 301]), t).astype(np.int32))
    mult = torch.from_numpy(((rng.random((t, t)) >= 0.12) / 0.88).astype(np.float32))
    d = [x.double() for x in (q, k, v, g)]
    want = (tattn.fused_attention_plain(*d[:3], km, mult.double()),
            *tattn.fused_attention_bwd_plain(*d[:3], km, mult.double(), d[3]))
    return (q, k, v, km, mult, g), want


def _within(got, want, tol) -> bool:
    return bool(((got.double() - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()).all())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # tf32's mantissa step at 1
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0**-23,
                      one + 3 * ulp / 2, 2.0 - ulp / 4, 0.0, 1e-30, -3.0e30], dtype=torch.float32)
    got = _tf32(x)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + 2 * ulp, 2.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(got[:7], want)
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    # a big/small split leaves 21 significant bits: small carries the rest
    y = torch.tensor([1.2345678, -7.654321e-3, 3.1415927e4], dtype=torch.float32)
    big = _tf32(y)
    rest = (y.double() - big.double() - _tf32(y - big).double()).abs()
    assert bool((rest <= y.double().abs() * 2.0**-21).all())


@pytest.mark.parametrize("products", ["3xtf32", "1xtf32"])
def test_tf32_products_against_float64(full_width_case, products):
    """3×TF32 meets the fp32 tolerances the card kernels are held to
    (forward atol = rtol = 1e-5, gradients 2e-5 + 1e-4 rel) against
    float64; 1×TF32 misses both."""
    inputs, want = full_width_case
    mm = {"3xtf32": _mm_3xtf32, "1xtf32": _mm_1xtf32}[products]
    got = _attention_with_products(*inputs, mm)
    fits = [_within(got[0], want[0], FWD_TOL)] + [_within(a, b, GRAD_TOL)
                                                   for a, b in zip(got[1:], want[1:])]
    if products == "3xtf32":
        assert all(fits), fits
    else:
        assert not any(fits), fits


def _kernel_tiles(q, k, v, key_mask, mult, g, tile=64):
    """The card kernels' algorithm in fp32 torch: the forward streams 64-key
    tiles with an online softmax (μ in the output sum only) and saves the
    row max and sum; the backward sweeps the key tiles once for
    D = Σ w μ dP, again for dq, and sweeps the query tiles for dk and dv.
    Keys are masked by adding a bias of 0, −1e30 or −inf (past T)."""
    B, H, T, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    bias = torch.where(key_mask != 0, 0.0, tattn.MASKED)[:, None, None, :]
    mult = torch.ones((T, T)) if mult is None else mult
    m = torch.full((B, H, T, 1), -torch.inf)
    l = torch.zeros((B, H, T, 1))
    o = torch.zeros_like(q)
    tiles = [slice(k0, min(k0 + tile, T)) for k0 in range(0, T, tile)]
    for j in tiles:
        s = q @ k[:, :, j].transpose(-1, -2) * scale + bias[..., j]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + (p * mult[:, j]) @ v[:, :, j]
        m = m_new
    out = o / l

    def pair(j_q, j_k):
        s = q[:, :, j_q] @ k[:, :, j_k].transpose(-1, -2) * scale + bias[..., j_k]
        w = torch.exp(s - m[:, :, j_q]) / l[:, :, j_q]
        dp = g[:, :, j_q] @ v[:, :, j_k].transpose(-1, -2)
        return w, dp, mult[j_q, j_k]

    every = slice(0, T)
    D = sum((w * mu * dp).sum(dim=-1, keepdim=True) for w, dp, mu in (pair(every, j) for j in tiles))
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for j in tiles:
        w, dp, mu = pair(every, j)
        dq += (w * (dp * mu - D) * scale) @ k[:, :, j]
    for i in tiles:  # the dk/dv launch: one owner per key, query tiles summed
        w, dp, mu = pair(i, every)
        ds = w * (dp * mu - D[:, :, i]) * scale
        dk += ds.transpose(-1, -2) @ q[:, :, i]
        dv += (w * mu).transpose(-1, -2) @ g[:, :, i]
    return out, dq, dk, dv


@pytest.mark.parametrize("case", ["mult_and_padding", "fully_masked_row", "one_key_past_a_tile"])
def test_kernel_tiling_matches_the_plain_versions(case):
    """The tiled algorithm of csrc/attention.cu — online softmax over 64-key
    tiles, row max and sum saved instead of the log-sum-exp, D summed from
    w ∘ μ ∘ dP — against the plain forward and backward, fp32, with the
    JAX package's tolerances."""
    t = 65 if case == "one_key_past_a_tile" else 150
    lengths = {"mult_and_padding": [t, 1, 97], "fully_masked_row": [t, 0, 40],
               "one_key_past_a_tile": [t, t - 1, 64]}[case]
    q, k, v, lengths = _inputs(seed=30 + t, t=t, lengths=lengths)
    heads = [torch.from_numpy(np.transpose(a, (0, 2, 1, 3)).copy()) for a in (q, k, v)]
    km = torch.from_numpy(_key_mask(lengths, t).astype(np.int32))
    rng = np.random.default_rng(31)
    mult = None if case == "fully_masked_row" else torch.from_numpy(
        ((rng.random((t, t)) >= 0.12) / 0.88).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=heads[0].shape).astype(np.float32))
    got = _kernel_tiles(*heads, km, mult, g)
    want = (tattn.fused_attention_plain(*heads, km, mult),
            *tattn.fused_attention_bwd_plain(*heads, km, mult, g))
    torch.testing.assert_close(got[0], want[0], **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)
    pad = km[:, None, :, None] == 0
    if case != "fully_masked_row":  # a fully masked row spreads its weight over every key
        assert bool((got[2].masked_select(pad) == 0).all() and (got[3].masked_select(pad) == 0).all())
