"""The operation counts behind ``train_mfu`` and ``serve_mfu`` against
``torch.utils.flop_counter.FlopCounterMode``, and the roofline arithmetic."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_config
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops, weights
from benchmark.reference import model as ref
from ssd_tpu_torch.models.ssd_model import build_model


@pytest.mark.parametrize("name", ["scaled_large_fused", "fast_plus"])
@pytest.mark.parametrize("projection", [False, True])
def test_forward_count_matches_the_flop_counter(name, projection):
    cfg = tiny_config(name)
    cfg["model"]["encoder"]["compute_dtype"] = "float32"
    dims = ref.encoder_dims(cfg)
    vocab = len(cfg["vocab"]["tokens"])
    p = weights.make(ref.param_layout(cfg, vocab), 1, torch.device("cpu"))
    B, T = 3, 57
    feats, lens = torch.randn(B, T, dims["input_dim"]), torch.tensor([57, 40, 33])
    c = ref.Context(cfg, train=False)
    with FlopCounterMode(display=False) as fc:
        enc, _ = ref.encode(c, p, feats, lens)
        lp, student = ref.heads(c, p, enc)
        (lp.sum() + (student.sum() if projection else 0)).detach()
    counted = fc.get_total_flops()
    if not projection:  # the serving forward has no projection head
        counted -= 2 * B * flops.subsampled(T, dims["sub"]) * dims["d"] * dims["proj"]
    assert flops.forward_flops(dims, B, T, vocab, projection) == counted


def test_the_programs_forward_counts_the_same():
    cfg = tiny_config("fast_plus")
    dims = ref.encoder_dims(cfg)
    vocab = len(cfg["vocab"]["tokens"])
    model = build_model(cfg, input_dim=dims["input_dim"], vocab_size=vocab)
    B, T = 2, 64
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.randn(B, T, dims["input_dim"]), torch.tensor([64, 50]))
    assert flops.forward_flops(dims, B, T, vocab, True) == fc.get_total_flops()


def test_backward_is_about_twice_the_forward():
    cfg = tiny_config("fast_plus")
    dims = ref.encoder_dims(cfg)
    vocab = len(cfg["vocab"]["tokens"])
    model = build_model(cfg, input_dim=dims["input_dim"], vocab_size=vocab)
    B, T = 2, 64
    with FlopCounterMode(display=False) as fc:
        lp, _, student = model(torch.randn(B, T, dims["input_dim"]), torch.tensor([64, 50]))
        (lp.sum() + student.sum()).backward()
    fwd = flops.forward_flops(dims, B, T, vocab, True)
    # 3 forwards to within a tenth: the counter's convolution backward and
    # the input's gradient, which is not taken, move it a few percent
    assert abs(fc.get_total_flops() / (3 * fwd) - 1) < 0.1


def test_attention_least_time():
    B, H, T, hd = 32, 12, 384, 64
    fwd = flops.attention_least_s(B, H, T, hd, backward=False, dropout=True)
    n = B * H * T * hd
    ops = 4 * B * H * T * T * hd / 989e12
    nbytes = (2 * 4 * n + 4 * B * T + 2 * T * T) / 3.35e12
    assert fwd == pytest.approx(max(ops, nbytes))
    both = flops.attention_least_s(B, H, T, hd, backward=True, dropout=True)
    assert both == pytest.approx(fwd + max(10 * B * H * T * T * hd / 989e12,
                                           (2 * 7 * n + 4 * B * T + 2 * T * T) / 3.35e12))


def test_subsampled_frames():
    assert flops.subsampled(993, 2) == 497
    assert flops.subsampled(609, 2) == 305
