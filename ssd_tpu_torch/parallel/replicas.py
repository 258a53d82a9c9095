"""Data-parallel inference: one replica of a model a device, each batch's
rows split across them (the serving engine's and the eval CLI's
``data_parallel``; the JAX package shards the batch over a ``(data,)``
mesh and lets XLA run the pipeline SPMD).

The rows are padded to a multiple of the device count — the padding rows
get a valid non-zero length, because a row whose every key is masked makes
the attention NaN — and cut into contiguous blocks; each replica's launches
go to its own device (asynchronous on cards, so they overlap), and the
results come back to the first device in row order.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ssd_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def data_parallel_replicas(model: nn.Module, primary: torch.device,
                           devices: Optional[Sequence] = None,
                           what: str = "data_parallel") -> Optional["Replicas"]:
    """:class:`Replicas` of ``model`` (already on ``primary``) over
    ``devices`` (default: every visible card); ``None``, with the JAX
    package's warning, when there is one device."""
    if devices is None:  # every card, or the CPU alone
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if primary.type == "cuda" else [primary])
    devs = [resolve_device(d) for d in devices]
    if len(devs) <= 1:
        logger.warning("%s requested but only 1 device is visible — serving single-device", what)
        return None
    logger.info("Data-parallel inference over %d devices: %s", len(devs), [str(d) for d in devs])
    return Replicas(model, devs)


class Replicas:
    """``model`` on ``devices[0]`` and a copy on each other device."""

    def __init__(self, model: nn.Module, devices: Sequence[torch.device]) -> None:
        self.devices = list(devices)
        self.models = [model.to(self.devices[0])] + [
            copy.deepcopy(model).to(d) for d in self.devices[1:]]

    def split(
        self,
        fn: Callable[[nn.Module, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
        x: torch.Tensor,
        lengths: torch.Tensor,
        pad_length: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fn(replica, x_rows, lengths_rows)`` on each device's block of
        rows; the two outputs concatenated on the first device, cut back to
        ``x``'s rows."""
        n, b = len(self.devices), x.shape[0]
        bp = -(-b // n) * n
        if bp > b:
            x = torch.cat([x, x.new_zeros((bp - b,) + tuple(x.shape[1:]))])
            lengths = torch.cat([lengths, lengths.new_full((bp - b,), pad_length)])
        m = bp // n
        outs = [fn(model, x[i * m:(i + 1) * m].to(d, non_blocking=True),
                   lengths[i * m:(i + 1) * m].to(d, non_blocking=True))
                for i, (model, d) in enumerate(zip(self.models, self.devices))]
        first = self.devices[0]
        a = torch.cat([o[0].to(first) for o in outs])
        c = torch.cat([o[1].to(first) for o in outs])
        return a[:b], c[:b]
