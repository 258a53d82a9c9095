"""The port's kernels as PyTorch custom ops (``ssd_tpu_torch::logmel_core``,
``::attention_fwd``, ``::depthwise_fwd``): ``torch.library.opcheck`` on the
CPU (schema, fake implementation against the real one, autograd
registration, AOT dispatch), and the op on a CPU tensor equal, bit for bit,
to the plain version it stands for — for the attention and depthwise ops in
fp32 and in bf16 (``compute_dtype: bfloat16``)."""

import numpy as np
import pytest
import torch

from ssd_tpu_torch.ops import attention as attn
from ssd_tpu_torch.ops import depthwise_conv as dwc
from ssd_tpu_torch.ops import featurizer as feat

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg_kw,B,L,C", [
    ({"n_fft": 64, "hop_length": 16, "n_mels": 8}, 2, 300, 2),
    ({"n_fft": 75, "hop_length": 20, "n_mels": 16, "fmax": 400.0}, 1, 500, 3),
])
def test_logmel_core_op(cfg_kw, B, L, C):
    cfg = feat.FeaturizerConfig(**cfg_kw)
    emg = torch.from_numpy(np.random.default_rng(B).normal(size=(B, L, C)).astype(np.float32))
    torch.library.opcheck(torch.ops.ssd_tpu_torch.logmel_core.default,
                          (emg, *feat._core_fields(cfg)))
    got = feat.logmel_core(emg, cfg)
    assert got.shape == (B, C, cfg.frame_count(L), cfg.n_mels)
    assert torch.equal(got, feat.logmel_core_plain(emg, cfg))
    with pytest.raises(ValueError, match="shorter than n_fft"):
        feat.logmel_core(emg[:, : cfg.n_fft - 1], cfg)


def _heads(rng, B, T, H, hd):
    """q, k, v as the model hands them over: (B, H, T, hd) views of
    (B, T, H, hd) projections."""
    return [torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(np.float32)).transpose(1, 2)
            for _ in range(3)]


@pytest.mark.parametrize("drop", [False, True])
def test_attention_fwd_op(drop):
    rng = np.random.default_rng(int(drop))
    B, T, H, hd = 2, 9, 3, 8
    q, k, v = _heads(rng, B, T, H, hd)
    key_mask = torch.from_numpy((np.arange(T)[None, :] < np.array([[T], [4]])).astype(np.int32))
    mult = (torch.from_numpy((rng.uniform(size=(T, T)) > 0.3).astype(np.float32) / 0.7)
            if drop else None)
    torch.library.opcheck(torch.ops.ssd_tpu_torch.attention_fwd.default, (q, k, v, key_mask, mult))
    out, row_max, row_sum = torch.ops.ssd_tpu_torch.attention_fwd(q, k, v, key_mask, mult)
    # the output in the kernel's layout: (B, H, T, hd) over (B, T, H, hd) storage
    assert out.shape == (B, H, T, hd) and out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, attn.fused_attention_plain(q, k, v, key_mask, mult))
    assert torch.equal(attn.fused_attention(q, k, v, key_mask, mult), out)
    # the statistics the kernel stores: the masked, scaled row max and the
    # exp-sum under it
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(hd))
    s = s.masked_fill(key_mask[:, None, None, :] == 0, attn.MASKED)
    torch.testing.assert_close(row_max, s.amax(-1), atol=0, rtol=0)
    torch.testing.assert_close(row_sum, torch.exp(s - row_max[..., None]).sum(-1),
                               atol=1e-6, rtol=1e-6)


def test_fused_attention_backward_unchanged():
    """The autograd function around the op still returns the plain
    backward's gradients on the CPU."""
    rng = np.random.default_rng(2)
    q, k, v = (t.detach().requires_grad_() for t in _heads(rng, 2, 7, 2, 4))
    key_mask = torch.tensor([[1] * 7, [1] * 3 + [0] * 4], dtype=torch.int32)
    g = torch.from_numpy(rng.normal(size=(2, 2, 7, 4)).astype(np.float32))
    (attn.fused_attention(q, k, v, key_mask) * g).sum().backward()
    want = attn.fused_attention_bwd_plain(q.detach(), k.detach(), v.detach(), key_mask, None, g)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


def test_depthwise_fwd_op():
    rng = np.random.default_rng(3)
    x, w, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 11, 6), (5, 6), (6,)))
    torch.library.opcheck(torch.ops.ssd_tpu_torch.depthwise_fwd.default, (x, w, b))
    y = torch.ops.ssd_tpu_torch.depthwise_fwd(x, w, b)
    assert torch.equal(y, dwc.depthwise_conv1d_plain(x, w, b))
    assert torch.equal(dwc.depthwise_conv1d(x, w, b), y)


@pytest.mark.parametrize("drop", [False, True])
def test_attention_fwd_op_bf16(drop):
    """bf16 q, k, v (and multiplier): a bf16 output in the same (B, T, H, hd)
    storage, fp32 row statistics."""
    rng = np.random.default_rng(10 + drop)
    B, T, H, hd = 2, 9, 3, 8
    q, k, v = (t.to(torch.bfloat16) for t in _heads(rng, B, T, H, hd))
    key_mask = torch.from_numpy((np.arange(T)[None, :] < np.array([[T], [4]])).astype(np.int32))
    mult = (torch.from_numpy((rng.uniform(size=(T, T)) > 0.1).astype(np.float32))
            .to(torch.bfloat16) / 0.9) if drop else None
    torch.library.opcheck(torch.ops.ssd_tpu_torch.attention_fwd.default, (q, k, v, key_mask, mult))
    out, row_max, row_sum = torch.ops.ssd_tpu_torch.attention_fwd(q, k, v, key_mask, mult)
    assert out.dtype == torch.bfloat16 and row_max.dtype == row_sum.dtype == torch.float32
    assert out.shape == (B, H, T, hd) and out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, attn.fused_attention_plain(q, k, v, key_mask, mult))
    assert torch.equal(attn.fused_attention(q, k, v, key_mask, mult), out)


def test_depthwise_fwd_op_bf16():
    rng = np.random.default_rng(4)
    x, w, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in ((2, 11, 6), (5, 6), (6,)))
    torch.library.opcheck(torch.ops.ssd_tpu_torch.depthwise_fwd.default, (x, w, b))
    y = torch.ops.ssd_tpu_torch.depthwise_fwd(x, w, b)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, dwc.depthwise_conv1d_plain(x, w, b))
    assert torch.equal(dwc.depthwise_conv1d(x, w, b), y)
