"""Projection (distillation) and CTC heads (port of ``ssd_tpu/models/heads.py``).

Projection = Dropout + Dense to the teacher dim (768); CTC head = Dropout +
Dense to vocab + log-softmax in fp32. Dropout runs with ``train=True`` only.
The Dense layers run in the encoder's compute dtype (flax ``dtype=``); both
heads return fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.models.conformer import Dense
from ssd_tpu_torch.ops.dropout import dropout, stream


class ProjectionHead(nn.Module):
    def __init__(self, d_model: int, output_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.proj = Dense(d_model, output_dim, dtype)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        if train:
            x = dropout(x, self.dropout, stream(generator, "replicated"))
        return self.proj(x).float()  # distillation MSE always in fp32


class CTCHead(nn.Module):
    def __init__(self, d_model: int, vocab_size: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.fc = Dense(d_model, vocab_size, dtype)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        """(B, T, D) → (B, T, V) log-probs (fp32 — CTC numerics)."""
        if train:
            x = dropout(x, self.dropout, stream(generator, "replicated"))
        return F.log_softmax(self.fc(x).float(), dim=-1)
