"""Inverted dropout with an explicit generator (port of the sampling
semantics of ``ssd_tpu/ops/dropout.py:FastDropout``).

Keep each element with probability ``1 − rate`` and scale kept values by
``1/(1 − rate)``, the scale in the tensor's dtype as ``FastDropout`` builds
it (in bf16, 1/0.9 rounds to 1.109375). The mask is drawn from the caller's ``torch.Generator``
on the tensor's device, so a training run's dropout stream is one seeded
generator. The JAX package regenerates its mask from the key in the
backward pass (a custom VJP that saves HBM traffic on a TPU); here autograd
keeps the multiplier, which is plain torch and needs no such trick.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def keep_multiplier(
    shape: Sequence[int],
    rate: float,
    generator: Optional[torch.Generator],
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Bernoulli(1 − rate) keep mask divided by 1 − rate, of ``shape``."""
    keep = torch.rand(tuple(shape), generator=generator, device=device) >= rate
    return keep.to(dtype) / (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout of ``x`` (identity at rate 0)."""
    if rate == 0.0:
        return x
    return x * keep_multiplier(x.shape, rate, generator, x.device, x.dtype)
