"""Projection (distillation) and CTC heads (port of ``ssd_tpu/models/heads.py``).

Projection = Dropout + Linear to the teacher dim (768); CTC head = Dropout +
Linear to vocab + log-softmax in fp32. Dropout runs with ``train=True`` only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.ops.dropout import dropout


class ProjectionHead(nn.Module):
    def __init__(self, d_model: int, output_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.proj = nn.Linear(d_model, output_dim)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        if train:
            x = dropout(x, self.dropout, generator)
        return self.proj(x).float()  # distillation MSE always in fp32


class CTCHead(nn.Module):
    def __init__(self, d_model: int, vocab_size: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc = nn.Linear(d_model, vocab_size)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        """(B, T, D) → (B, T, V) log-probs (fp32 — CTC numerics)."""
        if train:
            x = dropout(x, self.dropout, generator)
        return F.log_softmax(self.fc(x).float(), dim=-1)
