"""Seeded weights for both sides: made on the device in two normal draws
(one for all matrices, one for all vectors), fp32 as the model keeps its
parameters. Matrices and convolution kernels get N(0, 1/fan_in); biases
and BatchNorm running means N(0, 0.02²); LayerNorm and BatchNorm scales
1 + N(0, 0.1²); BatchNorm running variances exp(N(0, 0.1²)). No vector
takes its neutral value, so a path that drops or misapplies a bias, a
scale or a running statistic reads differently from the reference."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.harness.traffic import sub_seed

BIAS_STD = 0.02
SCALE_STD = 0.1


def make(layout: List[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    mats = [(n, s) for n, s in layout if len(s) >= 2]
    vecs = [(n, s) for n, s in layout if len(s) < 2]
    g = torch.Generator(device).manual_seed(sub_seed(seed, 7))
    flat = torch.randn(sum(math.prod(s) for _, s in mats), generator=g, device=device)
    g_vec = torch.Generator(device).manual_seed(sub_seed(seed, 13))
    flat_vec = torch.randn(sum(math.prod(s) for _, s in vecs), generator=g_vec, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = at_vec = 0
    for name, shape in layout:
        n = math.prod(shape)
        if len(shape) >= 2:
            out[name] = flat[at:at + n].view(shape).mul_((n // shape[0]) ** -0.5)
            at += n
            continue
        z = flat_vec[at_vec:at_vec + n].view(shape)
        at_vec += n
        if name.endswith(".bias") or name.endswith(".mean"):
            out[name] = z.mul_(BIAS_STD)
        elif name.endswith(".var"):
            out[name] = z.mul_(SCALE_STD).exp_()
        else:  # LayerNorm and BatchNorm scales
            out[name] = z.mul_(SCALE_STD).add_(1.0)
    return out
