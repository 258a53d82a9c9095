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


# dropout regions of a model over a (data, model) mesh, and what their masks
# must share: "replicated" regions (the residual stream when it is not
# T-sharded, the heads, on-device augmentation) the same mask on every
# model rank of a data group; "sharded" regions (the FFN hidden under TP,
# the T-shards under sequence parallelism) a mask of their own on each
# rank; "shared" (attention's one (T, T) mask) the same mask everywhere
REGIONS = ("replicated", "sharded", "shared")


class RngStreams:
    """One generator a dropout region, for a rank of a mesh: each seeded
    from (seed, region, the ranks the region varies over), so ranks that
    must draw the same mask do and the others draw their own. Modules take
    it where they take a generator (:func:`stream` picks the region's);
    ``get_state`` / ``set_state`` cover all three, for rematerialization."""

    def __init__(self, seed: int, data_rank: int, model_rank: int, device: torch.device):
        import numpy as np

        ranks = {"replicated": (data_rank,), "sharded": (data_rank, model_rank), "shared": ()}
        for i, region in enumerate(REGIONS):
            entropy = np.random.SeedSequence((int(seed), i, *ranks[region])).generate_state(2)
            g = torch.Generator(device).manual_seed(int(entropy[0]) << 31 ^ int(entropy[1]))
            setattr(self, region, g)

    def get_state(self):
        return tuple(getattr(self, r).get_state() for r in REGIONS)

    def set_state(self, state) -> None:
        for r, s in zip(REGIONS, state):
            getattr(self, r).set_state(s)


def stream(generator, region: str) -> Optional[torch.Generator]:
    """The generator of ``region``: ``generator`` itself unless it is an
    :class:`RngStreams` (one process draws every mask from one stream)."""
    return getattr(generator, region) if isinstance(generator, RngStreams) else generator
