"""Card-only tests of the port's CUDA kernels (log-mel, CTC α and β, fused
attention and the depthwise stencil, forward and backward) against their
plain PyTorch versions, and of the LM-fused beam search on the card against
the CPU. They skip without a card. This file imports neither JAX nor
``ssd_tpu``, so it also runs on a card machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ssd_tpu_torch.ops import attention as attn
from ssd_tpu_torch.ops import ctc_loss as ctc
from ssd_tpu_torch.ops import depthwise_conv as dwc
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
        (2, 4000, {"n_fft": 322}),  # 2·7·23: generic-radix passes
        (2, 3001, {"n_fft": 321}),  # odd n_fft, 3·107: no Nyquist bin
        (3, 2500, {"n_fft": 75, "hop_length": 20, "n_mels": 16}),  # odd, 3·5·5
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
    """Against the CPU recursion: within rtol 1e-5 where it is finite (the
    card's expf / log1pf may differ from the CPU's in the last bit); against
    the same recursion on the card both kernels are bit-equal."""
    finite = want > -1e29
    assert torch.equal(got > -1e29, finite)
    torch.testing.assert_close(got[finite], want[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "B,T,S",
    [(5, 640, 160), (32, 384, 128), (4, 1, 3), (4, 9, 1),
     (4, 50, 16), (4, 70, 31)],  # S2 = 33, 63: a warp boundary among the last states
)
def test_ctc_kernels_match_plain(cuda, B, T, S):
    lp_ext, skip, ll, bfinal, skip_from = _ctc_case(B, T, S, seed=T)
    want_a = ctc.forward_alphas_plain(lp_ext, skip)
    want_b = ctc.betas_plain(lp_ext, ll, bfinal, skip_from)
    before = (ctc.CTC_ALPHA.launches, ctc.CTC_BETA.launches)
    got_a = ctc.forward_alphas(lp_ext.to(cuda), skip.to(cuda))
    got_b = ctc.betas(lp_ext.to(cuda), ll.to(cuda), bfinal.to(cuda), skip_from.to(cuda))
    torch.cuda.synchronize()
    assert (ctc.CTC_ALPHA.launches, ctc.CTC_BETA.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got_a.cpu(), ctc.forward_alphas_plain(lp_ext.to(cuda), skip.to(cuda)).cpu())
    assert torch.equal(got_b.cpu(), ctc.betas_plain(
        lp_ext.to(cuda), ll.to(cuda), bfinal.to(cuda), skip_from.to(cuda)).cpu())
    _assert_recursion_close(got_a.cpu(), want_a)
    _assert_recursion_close(got_b.cpu(), want_b)


# S2 = 2S + 1 states: one warp (shuffles only), a warp boundary among the
# last states (S2 = 33, 63), 16 warps joined through the shared-memory
# handoff, then each instance of J states a thread (S2 ≤ 512·J) up to the
# limit both directions take, S2 ≤ 14 528
@pytest.mark.parametrize("S", [15, 16, 31, 255, 400, 700, 900, 1400, 1900, 2900, 4000, 5000, 7263])
@pytest.mark.parametrize("direction", ["alpha", "beta"])
def test_ctc_kernel_bit_equal_at_every_width(cuda, direction, S):
    """Every width of the α and β kernels gives the plain recursion's bits
    on the card; T = S + 8 steps reach the last state, and one row of
    length T starts β from β_final."""
    lp_ext, skip, ll, bfinal, skip_from = _ctc_case(4, S + 8, S, seed=S)
    ll[0] = S + 8
    lp_ext, skip, ll, bfinal, skip_from = (t.to(cuda) for t in (lp_ext, skip, ll, bfinal, skip_from))
    if direction == "alpha":
        got, want = ctc.CTC_ALPHA(lp_ext, skip.float()), ctc.forward_alphas_plain(lp_ext, skip)
    else:
        got = ctc.CTC_BETA(lp_ext, skip_from.float(), bfinal, ll)
        want = ctc.betas_plain(lp_ext, ll, bfinal, skip_from)
    assert torch.equal(got, want)


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
    wide = torch.zeros((1, 1, 14529), device=cuda), torch.zeros((1, 14529), device=cuda)
    with pytest.raises(RuntimeError, match="ssd_ctc_alpha_launch failed"):  # past β's limit
        ctc.CTC_ALPHA(*wide)
    with pytest.raises(RuntimeError, match="ssd_ctc_beta_launch failed"):
        ctc.CTC_BETA(*wide, wide[1], torch.ones((1,), dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        ctc.CTC_BETA(lp, skip, skip, lens.long())
    with pytest.raises(ValueError, match="CUDA"):
        ctc.CTC_BETA(lp, skip, skip.cpu(), lens)


DW_TOL = dict(atol=1e-5, rtol=1e-5)  # forward and dx
DW_SUM_REL = 1e-4  # dw and db, sums over B·T terms: of the tensor's max-abs
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_fused_attention.py's forward tolerance
ATTN_GRAD_TOL = dict(atol=2e-5, rtol=1e-4)  # … and its gradient tolerance


@pytest.mark.parametrize(
    "B,T,C,K",
    [(5, 640, 288, 15), (32, 384, 288, 15), (2, 37, 40, 3), (3, 100, 50, 31), (2, 1, 288, 15)]
    # one tile, its edges and ten tiles, each unrolled K; C 50: 4-byte copies
    + [(3, T, 50 if K == 31 else 288, K) for T in (1, 63, 64, 65, 640) for K in (1, 15, 31)],
)
def test_depthwise_kernels_match_plain(cuda, B, T, C, K):
    gen = torch.Generator().manual_seed(T)
    x, g = (torch.randn((B, T, C), generator=gen).to(cuda) for _ in range(2))
    w, b = torch.randn((K, C), generator=gen).to(cuda), torch.randn((C,), generator=gen).to(cuda)
    before = (dwc.DW_FWD.launches, dwc.DW_BWD.launches)
    y = dwc.DW_FWD(x, w, b)
    dx, part = dwc.DW_BWD(x, w, g)
    torch.cuda.synchronize()
    assert (dwc.DW_FWD.launches, dwc.DW_BWD.launches) == (before[0] + 1, before[1] + 1)
    want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, g)
    # the forward is the plain version's unfused chain, bias first: bit-equal
    assert torch.equal(y, dwc.depthwise_conv1d_plain(x, w, b))
    torch.testing.assert_close(dx, want_dx, **DW_TOL)
    assert part.shape[2:] == (K + 1, C)
    sums = part.sum(dim=(0, 1))
    for got, want in ((sums[:K], want_dwp.sum(dim=0)), (sums[K], g.sum(dim=(0, 1)))):
        torch.testing.assert_close(got, want, rtol=0, atol=DW_SUM_REL * float(want.abs().max()))
    # fixed-order sums, no atomics: a second backward is bit-identical
    dx2, part2 = dwc.DW_BWD(x, w, g)
    assert torch.equal(dx, dx2) and torch.equal(part, part2)
    # the op's backward is the kernel and one sum of its partials
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    grads = torch.autograd.grad(dwc.depthwise_conv1d(xr, wr, br), (xr, wr, br), g)
    for got, want in zip(grads, (dx, sums[:K], sums[K])):
        assert torch.equal(got, want)


def test_depthwise_backward_takes_misaligned_rows(cuda):
    """x and g 4 bytes off a 16-byte boundary take the 4-byte copies."""
    gen = torch.Generator().manual_seed(1)
    B, T, C, K = 2, 130, 64, 15
    x, g = (torch.randn((B * T * C + 1,), generator=gen).to(cuda)[1:].view(B, T, C)
            for _ in range(2))
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w = torch.randn((K, C), generator=gen).to(cuda)
    dx, part = dwc.DW_BWD(x, w, g)
    want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, g)
    torch.testing.assert_close(dx, want_dx, **DW_TOL)
    want_dw = want_dwp.sum(dim=0)
    torch.testing.assert_close(part.sum(dim=(0, 1))[:K], want_dw, rtol=0,
                               atol=DW_SUM_REL * float(want_dw.abs().max()))


@pytest.mark.parametrize("T", [64, 300, 640])
def test_depthwise_forward_takes_misaligned_rows(cuda, T):
    """x as an offset view, 4 bytes off a 16-byte boundary: one launch a
    call, bit-equal to the plain version."""
    gen = torch.Generator().manual_seed(T)
    B, C, K = 3, 288, 15
    x = torch.randn((B * T * C + 1,), generator=gen).to(cuda)[1:].view(B, T, C)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w, b = torch.randn((K, C), generator=gen).to(cuda), torch.randn((C,), generator=gen).to(cuda)
    before = dwc.DW_FWD.launches
    y = dwc.DW_FWD(x, w, b)
    torch.cuda.synchronize()
    assert dwc.DW_FWD.launches == before + 1
    assert torch.equal(y, dwc.depthwise_conv1d_plain(x, w, b))


def _attn_case(B, T, H, hd, cuda, drop):
    """q, k, v as the model hands them over — (B, H, T, hd) views of
    (B, T, H, hd) projections — a key mask with one row of length 1, and a
    dropout multiplier or None."""
    gen = torch.Generator().manual_seed(T + hd)
    q, k, v, g = (torch.randn((B, T, H, hd), generator=gen).to(cuda).transpose(1, 2)
                  for _ in range(4))
    lengths = torch.randint(max(T // 2, 1), T + 1, (B,), generator=gen)
    lengths[-1] = 1
    mask = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.int32).to(cuda)
    mult = ((torch.rand((T, T), generator=gen) < 0.88).float() / 0.88).to(cuda) if drop else None
    return q, k, v, g, mask, mult


@pytest.mark.parametrize(
    "B,T,H,hd,drop",
    [(5, 640, 6, 48, False), (5, 640, 6, 48, True), (8, 625, 6, 48, False),
     (2, 70, 2, 16, True), (2, 1, 6, 48, False), (2, 100, 2, 64, True),
     (32, 384, 6, 48, True),  # the flagship training shape
     (3, 65, 6, 48, True),  # one key past a 64-row tile
     (2, 130, 3, 20, True),  # hd 20: the last k-step zero-padded, 16-byte staging
     (2, 130, 3, 18, True)],  # hd 18: 4-byte staging
)
def test_attention_kernels_match_plain(cuda, B, T, H, hd, drop):
    q, k, v, g, mask, mult = _attn_case(B, T, H, hd, cuda, drop)
    before = (attn.ATTN_FWD.launches, attn.ATTN_BWD.launches)
    out, row_max, row_sum = attn.ATTN_FWD(q, k, v, mask, mult)
    dq, dk, dv = attn.ATTN_BWD(q, k, v, out, g, row_max, row_sum, mask, mult)
    torch.cuda.synchronize()
    assert (attn.ATTN_FWD.launches, attn.ATTN_BWD.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, attn.fused_attention_plain(q, k, v, mask, mult), **ATTN_TOL)
    want = attn.fused_attention_bwd_plain(q, k, v, mask, mult, g)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(got, w, **ATTN_GRAD_TOL, msg=name)
    # padded keys get exactly zero dk and dv
    pad = mask[:, None, :, None] == 0
    assert bool((dk.masked_select(pad) == 0).all() and (dv.masked_select(pad) == 0).all())
    # one owner per output, no atomics: a second backward is bit-identical
    again = attn.ATTN_BWD(q, k, v, out, g, row_max, row_sum, mask, mult)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        assert torch.equal(a, b), name


def test_attention_and_depthwise_wrappers_reject_bad_cuda_input(cuda):
    q = torch.zeros((2, 4, 8, 3, 16), device=cuda)[..., 0, :].transpose(1, 2)  # (2, 8, 4, 16)
    mask = torch.ones((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        attn.ATTN_FWD(q.double(), q.double(), q.double(), mask)
    with pytest.raises(TypeError):
        attn.ATTN_FWD(q, q, q, mask.long())
    with pytest.raises(ValueError, match="unit stride"):
        attn.ATTN_FWD(q.transpose(-1, -2), q.transpose(-1, -2), q.transpose(-1, -2), mask)
    with pytest.raises(ValueError, match="shape"):
        attn.ATTN_FWD(q, q, q, mask, torch.ones((3, 3), device=cuda))
    wide = torch.zeros((2, 1, 8, 65), device=cuda)
    with pytest.raises(ValueError, match="hd ≤ 64"):
        attn.ATTN_FWD(wide, wide, wide, torch.ones((2, 8), dtype=torch.int32, device=cuda))
    x = torch.zeros((2, 10, 8), device=cuda)
    w, b = torch.zeros((5, 8), device=cuda), torch.zeros((8,), device=cuda)
    with pytest.raises(TypeError):
        dwc.DW_FWD(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        dwc.DW_FWD(x.transpose(0, 1).contiguous().transpose(0, 1), w, b)
    with pytest.raises(ValueError, match="odd kernel size"):
        dwc.DW_FWD(x, torch.zeros((4, 8), device=cuda), b)
    with pytest.raises(ValueError, match="K ≤"):
        dwc.DW_BWD(x, torch.zeros((33, 8), device=cuda), x)


# ------------------------------------------------ bf16 instances

# bf16: the attention kernels round p ∘ μ before dividing by the row sum
# where the plain version rounds the normalised weights, and sum their
# products on the tensor cores: within a few bf16 roundings of each output's
# largest magnitude; the depthwise forward and dx are bit-equal
ATTN_BF16_REL = 2.0**-6
DW_BF16_SUM_REL = 1e-4  # dw and db (fp32 partials) of the tensor's max-abs


def _bf16(t):
    return t.to(torch.bfloat16)


def _bf16_taps_on_ties(gen, shape):
    """Taps ±{1.25, 1.5, 1.75} · 2^e, e in [−3, 0]: 2 or 3 significant bits,
    so a product with a random bf16 x often has a 9th significant bit that is
    exactly one half — a rounding tie."""
    mant = torch.tensor([1.25, 1.5, 1.75])[torch.randint(0, 3, shape, generator=gen)]
    sign = torch.randint(0, 2, shape, generator=gen).float() * 2 - 1
    return _bf16(sign * mant * 2.0 ** -torch.randint(0, 4, shape, generator=gen).float())


@pytest.mark.parametrize(
    "B,T,C,K,data",
    [(32, 384, 768, 15, "normal"), (8, 625, 768, 15, "normal"), (5, 640, 288, 15, "normal"),
     (2, 37, 40, 3, "normal"),
     (3, 100, 50, 31, "normal"),  # C 50: not a multiple of 8, the bf16 ring's element copies
     (2, 1, 768, 15, "normal"), (3, 65, 768, 31, "normal"),
     # odd C: element loads and stores, the last pair's high channel past C
     (3, 130, 7, 15, "normal"), (2, 200, 289, 15, "normal"),
     # C ≡ 2 mod 8: 4-byte words, element copies into the ring, a half-full last slab
     (2, 200, 770, 15, "normal"), (2, 200, 770, 31, "normal"),
     # products in and below bf16's subnormals, near its overflow, and on ties
     (4, 300, 768, 15, "tiny"), (4, 300, 768, 15, "huge"), (4, 300, 768, 15, "ties")],
)
def test_depthwise_bf16_kernels_match_plain(cuda, B, T, C, K, data):
    gen = torch.Generator().manual_seed(T + C)
    x, g = (torch.randn((B, T, C), generator=gen) for _ in range(2))
    w, b = (torch.randn(s, generator=gen) / 4 for s in ((K, C), (C,)))
    if data == "tiny":  # x, g ~ 2⁻¹²⁰: products x · w and g · w reach below 2⁻¹³³
        x, g = x * 2.0**-120, g * 2.0**-120
    elif data == "huge":  # x ~ 2¹²⁰ (g small enough that dw stays finite)
        x, g = x * 2.0**120, g * 2.0**-20
    elif data == "ties":
        w = _bf16_taps_on_ties(gen, (K, C))
    x, g, w, b = (_bf16(t).to(cuda) for t in (x, g, w, b))
    before = (dwc.DW_FWD_BF16.launches, dwc.DW_BWD_BF16.launches, dwc.DW_FWD.launches)
    y = dwc.DW_FWD_BF16(x, w, b)
    dx, part = dwc.DW_BWD_BF16(x, w, g)
    torch.cuda.synchronize()
    assert (dwc.DW_FWD_BF16.launches, dwc.DW_BWD_BF16.launches, dwc.DW_FWD.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert y.dtype == dx.dtype == torch.bfloat16 and part.dtype == torch.float32
    # each tap's product rounded to bf16, then the unfused fp32 chain: bit-equal
    assert torch.equal(y, dwc.depthwise_conv1d_plain(x, w, b))
    want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, g)
    assert torch.equal(dx, want_dx)
    sums = part.sum(dim=(0, 1))
    for got, want in ((sums[:K], want_dwp.sum(dim=0)), (sums[K], g.float().sum(dim=(0, 1)))):
        torch.testing.assert_close(got, want, rtol=0, atol=DW_BF16_SUM_REL * float(want.abs().max()))
    dx2, part2 = dwc.DW_BWD_BF16(x, w, g)
    assert torch.equal(dx, dx2) and torch.equal(part, part2)
    # the op: dw and db rounded to the bf16 of w and b
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    grads = torch.autograd.grad(dwc.depthwise_conv1d(xr, wr, br), (xr, wr, br), g)
    for got, want in zip(grads, (dx, sums[:K].to(torch.bfloat16), sums[K].to(torch.bfloat16))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [1, 2])
def test_depthwise_bf16_takes_misaligned_rows(cuda, offset):
    """x, g, w and b ``offset`` elements into their storage: 2 bytes off a
    4-byte boundary (the forward's element loads and stores) or 4 bytes off a
    16-byte one (its bf16x2 words); both take element copies into the
    backward's ring. One launch a call, bit-equal."""
    gen = torch.Generator().manual_seed(2)
    B, T, C, K = 2, 130, 64, 15

    def view(shape, scale=1.0):
        n = int(np.prod(shape))
        flat = _bf16(torch.randn((n + offset,), generator=gen) * scale).to(cuda)
        return flat[offset:].view(shape)

    x, g = view((B, T, C)), view((B, T, C))
    w, b = view((K, C), 0.25), view((C,), 0.25)
    assert x.data_ptr() % 4 == 2 * offset % 4 and x.data_ptr() % 16 != 0
    before = (dwc.DW_FWD_BF16.launches, dwc.DW_BWD_BF16.launches)
    y = dwc.DW_FWD_BF16(x, w, b)
    dx, part = dwc.DW_BWD_BF16(x, w, g)
    torch.cuda.synchronize()
    assert (dwc.DW_FWD_BF16.launches, dwc.DW_BWD_BF16.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, dwc.depthwise_conv1d_plain(x, w, b))
    want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, g)
    assert torch.equal(dx, want_dx)
    want_dw = want_dwp.sum(dim=0)
    torch.testing.assert_close(part.sum(dim=(0, 1))[:K], want_dw, rtol=0,
                               atol=DW_BF16_SUM_REL * float(want_dw.abs().max()))


@pytest.mark.parametrize(
    "B,T,H,hd,drop",
    [(32, 384, 12, 64, True),  # tpu_scaled_large's training shape
     (8, 625, 12, 64, False),  # … and its serving bucket
     (5, 640, 6, 48, True), (2, 1, 12, 64, False), (3, 65, 6, 48, True),
     (2, 70, 2, 16, True),  # T % 8 ≠ 0: the multiplier's element copies
     (2, 130, 3, 20, True),  # hd 20 ≢ 0 (mod 8): the rows' element copies
     (2, 37, 2, 64, False)],
)
def test_attention_bf16_kernels_match_plain(cuda, B, T, H, hd, drop):
    q, k, v, g, mask, mult = _attn_case(B, T, H, hd, cuda, drop)
    q, k, v, g = (_bf16(t) for t in (q, k, v, g))
    mult = None if mult is None else _bf16(mult)
    before = (attn.ATTN_FWD_BF16.launches, attn.ATTN_BWD_BF16.launches, attn.ATTN_FWD.launches)
    out, out32, row_max, row_sum = attn.ATTN_FWD_BF16(q, k, v, mask, mult, fp32_out=True)
    grads = attn.ATTN_BWD_BF16(q, k, v, out32, g, row_max, row_sum, mask, mult)
    torch.cuda.synchronize()
    assert (attn.ATTN_FWD_BF16.launches, attn.ATTN_BWD_BF16.launches, attn.ATTN_FWD.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert out.dtype == torch.bfloat16 and row_max.dtype == row_sum.dtype == torch.float32
    # the fp32 output is out before its rounding; the serving call computes the same
    assert out32.dtype == torch.float32 and torch.equal(out, out32.to(torch.bfloat16))
    for a, b in zip((out, row_max, row_sum), attn.ATTN_FWD_BF16(q, k, v, mask, mult)):
        assert torch.equal(a, b)
    want = (attn.fused_attention_plain(q, k, v, mask, mult),
            *attn.fused_attention_bwd_plain(q, k, v, mask, mult, g))
    for name, got, w in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert got.dtype == torch.bfloat16, name
        w = w.float()
        torch.testing.assert_close(got.float(), w, rtol=0,
                                   atol=ATTN_BF16_REL * float(w.abs().max()), msg=name)
    pad = mask[:, None, :, None] == 0
    assert bool((grads[1].masked_select(pad) == 0).all() and (grads[2].masked_select(pad) == 0).all())
    again = attn.ATTN_BWD_BF16(q, k, v, out32, g, row_max, row_sum, mask, mult)
    for name, a, b in zip(("dq", "dk", "dv"), grads, again):
        assert torch.equal(a, b), name


def test_attention_train_op_on_the_card(cuda):
    """``ssd_tpu_torch::attention_fwd_train`` on the card: opcheck, the bf16
    instance's four outputs, and the fp32 instance refusing fp32_out."""
    q, k, v, g, mask, mult = _attn_case(2, 70, 2, 64, cuda, True)
    qb, kb, vb, mb = (_bf16(t) for t in (q, k, v, mult))
    torch.library.opcheck(torch.ops.ssd_tpu_torch.attention_fwd_train.default, (qb, kb, vb, mask, mb))
    out, out32, row_max, row_sum = torch.ops.ssd_tpu_torch.attention_fwd_train(qb, kb, vb, mask, mb)
    assert out32.dtype == torch.float32 and out32.is_contiguous()
    assert torch.equal(out, out32.to(torch.bfloat16))
    want = attn.fused_attention_plain(qb, kb, vb, mask, mb).float()
    torch.testing.assert_close(out32, want, rtol=0, atol=ATTN_BF16_REL * float(want.abs().max()))
    with pytest.raises(ValueError, match="fp32_out"):
        attn.ATTN_FWD(q, k, v, mask, mult, fp32_out=True)


def test_bf16_ops_reach_the_bf16_instances(cuda):
    """The custom ops and autograd Functions pick the kernel instance of the
    tensors' dtype; another dtype, or a bf16 input with an fp32 partner,
    raises — there is no fallback to the fp32 instance."""
    q, k, v, g, mask, _ = _attn_case(2, 64, 2, 64, cuda, False)
    qb, kb, vb = (_bf16(t).requires_grad_(True) for t in (q, k, v))
    before = {w: w.launches for w in (attn.ATTN_FWD, attn.ATTN_FWD_BF16, attn.ATTN_BWD_BF16)}
    attn.fused_attention(qb, kb, vb, mask).backward(_bf16(g))
    assert attn.ATTN_FWD.launches == before[attn.ATTN_FWD]
    assert attn.ATTN_FWD_BF16.launches == before[attn.ATTN_FWD_BF16] + 1
    assert attn.ATTN_BWD_BF16.launches == before[attn.ATTN_BWD_BF16] + 1
    with pytest.raises(TypeError):
        attn.fused_attention(q.half(), k.half(), v.half(), mask)
    with pytest.raises(TypeError):
        attn.ATTN_FWD_BF16(_bf16(q), _bf16(k), _bf16(v), mask, torch.ones((64, 64), device=cuda))
    x = _bf16(torch.zeros((2, 10, 8))).to(cuda)
    with pytest.raises(TypeError):
        dwc.depthwise_conv1d(x, torch.zeros((5, 8), device=cuda), torch.zeros((8,), device=cuda))
    with pytest.raises(TypeError):
        dwc.depthwise_conv1d(x.half(), x[0, :5].half(), x[0, 0].half())


# ------------------------------------------------ LM-fused beam search


@pytest.mark.parametrize("seed", [1, 6, 8])
def test_beam_on_the_card_matches_the_cpu_on_flat_inputs(cuda, seed):
    """Beam-50 (plain and LM-fused) on flat log-probs, where scores tie
    exactly at the beam cut: the card's text is the CPU's, run after run —
    ties break lower index first and no step adds atomically (the inputs
    of scripts/beam_card_vs_cpu.py, seeds where the port used to part from
    the JAX search)."""
    from ssd_tpu_torch.data.vocab import default_vocab
    from ssd_tpu_torch.decoding import device_lm as dl
    from ssd_tpu_torch.decoding.lm import train_ngram
    from ssd_tpu_torch.ops import ctc_decode as dec

    vocab = default_vocab()
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, 640, vocab.size)).astype(np.float32) * (0.7, 1.0, 1.5)[seed % 3]
    logits[:, :, vocab.blank_id] += 1.0
    lp = torch.from_numpy(logits).log_softmax(-1)
    lengths = torch.tensor([640, 560])
    kw = dict(blank_id=vocab.blank_id, pad_id=vocab.pad_id, beam_width=50)

    def texts(lp, lengths):
        chars, parents, _ = dec.beam_search(lp, lengths, **kw)
        return [vocab.decode(p) for p in dec.traceback(chars.cpu().numpy(), parents.cpu().numpy())]

    want = texts(lp, lengths)
    assert texts(lp.to(cuda), lengths.to(cuda)) == want == texts(lp.to(cuda), lengths.to(cuda))
    table = dl.pack_lm(train_ngram(["the cat sat on the mat", "a dog ran far away"], order=3), vocab)
    lm = dict(beam_width=50, alpha=0.6, beta=0.1)
    assert (dl.beam_decode_lm_device(lp.to(cuda), lengths.to(cuda), vocab, table, **lm)
            == dl.beam_decode_lm_device(lp, lengths, vocab, table, **lm))


@pytest.mark.parametrize("order,width,top_k", [(3, 16, None), (5, 50, 16)])
def test_lm_search_on_the_card_matches_the_cpu(cuda, order, width, top_k):
    """The packed table's lookups on the card are bit-equal to the CPU's on
    every key and on misses (keys ≥ 2³¹ among them); the LM-fused search
    waits for the device nowhere and decodes the CPU's text on decisive
    log-probs, its final scores within 1e-4."""
    from ssd_tpu_torch.data.vocab import default_vocab
    from ssd_tpu_torch.decoding import device_lm as dl
    from ssd_tpu_torch.decoding.lm import train_ngram

    vocab = default_vocab()
    texts = ["the cat sat on the mat", "a dog ran far away", "hello world", "the dog sat",
             "she said the cat is here"]
    table = dl.pack_lm(train_ngram(texts, order=order), vocab)
    rng = np.random.default_rng(order)
    miss = rng.integers(0, 1 << 32, (2, 4096), dtype=np.uint64).astype(np.int64)
    k1 = torch.from_numpy(np.concatenate([table.keys1[table.used].astype(np.int64), miss[0]]))
    k2 = torch.from_numpy(np.concatenate([table.keys2[table.used].astype(np.int64), miss[1]]))
    want = dl._lookup(dl._packed_device_table(table, "cpu"), k1, k2)
    got = dl._lookup(dl._packed_device_table(table, cuda), k1.to(cuda), k2.to(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[0].sum()) >= int(table.used.sum())

    B, T = 4, 2 * max(len(t) for t in texts[:4])
    logits = rng.normal(size=(B, T, vocab.size)).astype(np.float32)
    logits[:, :, vocab.blank_id] += 1.0
    for b, text in enumerate(texts[:4]):
        for t, cid in enumerate(vocab.encode(text)):
            logits[b, 2 * t, cid] += 8.0
            logits[b, 2 * t + 1, vocab.blank_id] += 8.0
    lp = torch.from_numpy(logits).log_softmax(-1)
    lengths = torch.tensor([2 * len(t) for t in texts[:4]])
    kw = dict(blank_id=vocab.blank_id, pad_id=vocab.pad_id, space_id=vocab.token_to_id[" "],
              beam_width=width, alpha=0.8, beta=0.2, token_top_k=top_k)
    lp_c, len_c = lp.to(cuda), lengths.to(cuda)
    dl.beam_search_lm_device(lp_c, len_c, table, **kw)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside the search raises
    try:
        card = dl.beam_search_lm_device(lp_c, len_c, table, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = dl.beam_search_lm_device(lp, lengths, table, **kw)
    torch.testing.assert_close(card[2].cpu().sort(dim=1).values, cpu[2].sort(dim=1).values,
                               atol=1e-4, rtol=0)
    assert dl.beam_decode_lm_device(lp_c, len_c, vocab, table, beam_width=width,
                                    alpha=0.8, beta=0.2, token_top_k=top_k) == texts[:4]
    assert dl.beam_decode_lm_device(lp, lengths, vocab, table, beam_width=width, alpha=0.8,
                                    beta=0.2, token_top_k=top_k) == texts[:4]


# ------------------------------------------------ the export artifact


def test_exported_bucket_runs_the_kernels(cuda, tmp_path):
    """A full-width ``configs/tpu_fast_plus.yaml`` checkpoint under
    ``attention_impl: fused`` / ``depthwise_impl: pallas`` exported on the
    card: its graph holds the three custom ops (1 log-mel, one attention
    and one depthwise forward a block), every call of the reloaded program
    launches the kernels that often, and its text is the engine's."""
    from pathlib import Path

    from ssd_tpu_torch.data.vocab import default_vocab
    from ssd_tpu_torch.models.conformer import init_flax_style
    from ssd_tpu_torch.models.ssd_model import build_model
    from ssd_tpu_torch.serving.engine import InferenceEngine
    from ssd_tpu_torch.serving.export import ExportedTranscriber, export_checkpoint
    from ssd_tpu_torch.training.checkpoint import save_checkpoint
    from ssd_tpu_torch.utils.config import load_config

    shipped = load_config(Path(__file__).resolve().parents[1] / "configs" / "tpu_fast_plus.yaml")
    shipped["model"]["encoder"].update(attention_impl="fused", depthwise_impl="pallas")
    default_vocab().to_json(tmp_path / "vocab.json")
    cfg = {"data": {"vocab": str(tmp_path / "vocab.json")}, "features": shipped["features"],
           "model": shipped["model"]}
    enc = cfg["model"]["encoder"]
    model = build_model(cfg, input_dim=enc["input_dim"], vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "run", model.state_dict(), cfg)
    ckpt = tmp_path / "run" / "last"
    out = export_checkpoint(ckpt, tmp_path / "artifact", batch_sizes=(1,),
                            sample_lengths=(2560,), device="cuda")
    nodes = [str(n.target) for n in torch.export.load(out / "fn_b1_l2560.pt2").graph.nodes]
    L = enc["num_layers"]
    assert [nodes.count(f"ssd_tpu_torch.{op}.default")
            for op in ("logmel_core", "attention_fwd", "depthwise_fwd")] == [1, L, L]
    t = ExportedTranscriber.load(out, device="cuda")
    emg = [np.random.default_rng(1).normal(size=(2000, 8)).astype(np.float32)]
    kernels = (feat.LOGMEL, attn.ATTN_FWD, dwc.DW_FWD)
    for _ in range(2):
        before = [k.launches for k in kernels]
        text = t.transcribe(emg)
        assert [k.launches - b for k, b in zip(kernels, before)] == [1, L, L]
    assert text == InferenceEngine.from_checkpoint(ckpt, device="cuda").transcribe(emg)


@pytest.mark.parametrize("M,K,N", [(5, 288, 1152), (17, 1152, 288), (5000, 768, 3072),
                                   (625, 3072, 768)])
def test_int8_matmul_on_the_card_is_exact(cuda, M, K, N):
    """``torch._int_mm`` through the wrapper (fewer than 17 rows padded)
    equal to the exact plain product; a launch counted."""
    from ssd_tpu_torch.ops import quant

    rng = np.random.default_rng(M)
    a = torch.from_numpy(rng.integers(-127, 128, size=(M, K), dtype=np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, size=(N, K), dtype=np.int8)).to(cuda)
    before = quant.INT_MM.launches
    got = quant.int8_matmul(a, b)
    assert quant.INT_MM.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert torch.equal(got, quant.int8_matmul_plain(a, b))
    assert torch.equal(got.cpu(), quant.int8_matmul(a.cpu(), b.cpu()))


@pytest.mark.parametrize("mode", ["int8", "int8_prequant"])
def test_quantized_dense_on_the_card_matches_the_cpu(cuda, mode):
    """One quantized Dense layer on identical inputs: the card's output equal
    to the CPU's (the same int8 values and int32 sums; the rescale's fp32
    products in the same order)."""
    from ssd_tpu_torch.models import conformer
    from ssd_tpu_torch.ops import quant

    torch.manual_seed(0)
    dense = conformer.Dense(288, 1152, quantize="int8")
    x = torch.randn(3, 40, 288)
    if mode == "int8_prequant":
        q = quant.QuantDense(288, 1152)
        sd = quant.prequantize_state_dict({"w1.weight": dense.weight.detach(),
                                           "w1.bias": dense.bias.detach()})
        q.load_state_dict({"weight": sd["w1.weight"], "scale": sd["w1.scale"],
                           "bias": sd["w1.bias"]})
        dense = q
    with torch.no_grad():
        want = dense(x)
        got = dense.to(cuda)(x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("parallel", [{}, {"fsdp": True}], ids=["dp", "fsdp"])
def test_world_one_nccl_step_equals_one_process(cuda, tmp_path, parallel):
    """A 1×1 mesh over NCCL (``parallel/``): two fused/pallas train steps
    through ``shard_model`` (FSDP2 too) and the mesh's gradient sync and
    norm, losses and unsharded weights bit-equal to the same steps in one
    process."""
    import copy

    import torch.distributed as dist

    from ssd_tpu_torch.models.conformer import init_flax_style
    from ssd_tpu_torch.models.ssd_model import build_model
    from ssd_tpu_torch.parallel.mesh import ParallelContext, mesh_from_config
    from ssd_tpu_torch.parallel.partition import full_state_dict, grad_norm_fn, shard_model
    from ssd_tpu_torch.training import train as ttrain
    from ssd_tpu_torch.training.schedules import build_optimizer

    cfg = {"model": {"encoder": dict(d_model=96, num_layers=2, num_heads=2, ffn_dim=192,
                                     depthwise_conv_kernel_size=15, subsample_factor=2,
                                     dropout=0.0, attention_impl="fused",
                                     depthwise_impl="pallas"),
                     "projection_dim": 64, "ctc_dropout": 0.0},
           "optim": {"lr": 1e-3, "weight_decay": 1e-2, "clip_grad_norm": 1.0}}
    rng = np.random.default_rng(0)
    B, T, S = 3, 96, 16
    batch = {"emg": torch.from_numpy(rng.normal(size=(B, T, 32)).astype(np.float32)),
             "emg_lengths": torch.tensor([96, 70, 41], dtype=torch.int32),
             "tokens": torch.from_numpy(rng.integers(3, 40, size=(B, S)).astype(np.int32)),
             "token_lengths": torch.tensor([16, 9, 4], dtype=torch.int32),
             "weight": torch.ones(B),
             "teacher": torch.from_numpy(rng.normal(size=(B, 48, 64)).astype(np.float32)),
             "teacher_lengths": torch.tensor([48, 35, 20], dtype=torch.int32)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    model = build_model(cfg, input_dim=32, vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(0))
    models = {"one": copy.deepcopy(model).to(cuda), "mesh": copy.deepcopy(model).to(cuda)}
    cuda = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, device_id=cuda)
    try:
        ctx = ParallelContext.from_mesh(mesh_from_config({"parallel": parallel}),
                                        fsdp=bool(parallel))
        shard_model(models["mesh"], ctx)
        losses = {}
        for name, m in models.items():
            par = ctx if name == "mesh" else None
            opt, _ = build_optimizer(cfg, list(m.parameters()), 10,
                                     grad_norm_fn(m) if par else None)
            step = ttrain.make_train_step(1, False, par=par)
            state = ttrain.TrainState(model=m, optimizer=opt)
            losses[name] = [float(step(state, batch, (0.65, 0.35), None)[1]["total"])
                            for _ in range(2)]
        assert losses["mesh"] == losses["one"]
        got, want = full_state_dict(models["mesh"]), models["one"].state_dict()
        assert all(torch.equal(got[k], want[k].cpu()) for k in want)
    finally:
        dist.destroy_process_group()
