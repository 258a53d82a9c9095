"""Projection (distillation) and CTC heads (port of ``ssd_tpu/models/heads.py``).

Projection = Linear to the teacher dim (768); CTC head = Linear to vocab +
log-softmax in fp32. Dropout is training-only and comes with the training
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ProjectionHead(nn.Module):
    def __init__(self, d_model: int, output_dim: int):
        super().__init__()
        self.proj = nn.Linear(d_model, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).float()  # distillation MSE always in fp32


class CTCHead(nn.Module):
    def __init__(self, d_model: int, vocab_size: int):
        super().__init__()
        self.fc = nn.Linear(d_model, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) → (B, T, V) log-probs (fp32 — CTC numerics)."""
        return F.log_softmax(self.fc(x).float(), dim=-1)
