"""Joint CTC + WavLM-distillation objective (PyTorch port of
``ssd_tpu/models/losses.py``).

* CTC term: :func:`ssd_tpu_torch.ops.ctc_loss.ctc_loss` with
  ``zero_infinity`` and torch's ``mean`` reduction semantics.
* Distillation term: teacher hidden states linearly interpolated along time
  to the student's frame count, teacher lengths rescaled and clamped, a
  min(student, teacher) length mask, optional per-frame LayerNorm of both
  representations, then masked MSE normalized by ``mask · dim``.
* ``total = λ_ctc · ctc + λ_distill · distill``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ssd_tpu_torch.ops.ctc_loss import ctc_loss


@dataclass(frozen=True)
class LossWeights:
    lambda_distill: float = 0.7
    lambda_ctc: float = 0.3


def interpolate_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Time-resize ``(B, T_in, D)`` → ``(B, out_len, D)``.

    ``F.interpolate(mode='linear', align_corners=False)`` is the JAX
    function's twin: output center j maps to input coordinate
    ``(j + 0.5) · T_in/T_out − 0.5`` with edge clamping. JAX writes it as a
    banded weight-matrix product only because gathers are slow on a TPU.
    """
    if x.shape[1] == out_len:
        return x
    return F.interpolate(
        x.transpose(1, 2), size=out_len, mode="linear", align_corners=False
    ).transpose(1, 2)


def _layer_norm(v: torch.Tensor) -> torch.Tensor:
    """Parameterless per-frame LayerNorm (eps 1e-5, biased variance)."""
    mu = v.mean(dim=-1, keepdim=True)
    var = v.var(dim=-1, keepdim=True, unbiased=False)
    return (v - mu) / torch.sqrt(var + 1e-5)


def distillation_mse(
    student: torch.Tensor,
    student_lengths: torch.Tensor,
    teacher: torch.Tensor,
    teacher_lengths: Optional[torch.Tensor],
    normalize: bool = False,
    count_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Masked MSE between student frames and time-aligned teacher frames.

    ``count_reduce`` sums the valid-frame count over the data-parallel
    ranks (the JAX package's count is of the global batch), so each rank's
    value is its share of the global loss."""
    B, t_s, d = student.shape
    t_t = teacher.shape[1]
    teacher = teacher.to(torch.float32)

    aligned = interpolate_linear(teacher, t_s)
    if teacher_lengths is not None and t_t != t_s and t_t > 0:
        scale = float(t_s) / float(t_t)
        # torch.round rounds half to even, as jnp.round does
        teacher_lengths = torch.clamp(
            torch.round(teacher_lengths.to(torch.float32) * scale).to(torch.int32), 0, t_s
        )

    valid = torch.clamp(student_lengths, 0, t_s)
    if teacher_lengths is not None:
        valid = torch.minimum(valid, teacher_lengths.to(valid.dtype))
    mask = torch.arange(t_s, device=student.device)[None, :] < valid[:, None]  # (B, t_s)

    s, t = student, aligned
    if normalize:
        s, t = _layer_norm(s), _layer_norm(t)

    sq = (s - t) ** 2 * mask[:, :, None]
    count = mask.sum()
    if count_reduce is not None:
        count = count_reduce(count)
    denom = torch.clamp(count * d, min=1)
    return sq.sum() / denom


def joint_loss(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    student_repr: torch.Tensor,
    teacher_repr: Optional[torch.Tensor],
    teacher_lengths: Optional[torch.Tensor],
    weights: LossWeights,
    blank_id: int,
    normalize_distill: bool = False,
) -> Dict[str, torch.Tensor]:
    """The training objective. Returns {"total", "ctc", "distill"} scalars."""
    per_sample = ctc_loss(log_probs, logit_lengths, targets, target_lengths, blank_id)
    denom = torch.clamp(target_lengths, min=1).to(torch.float32)
    ctc = (per_sample / denom).mean()

    if teacher_repr is not None:
        distill = distillation_mse(
            student_repr, logit_lengths, teacher_repr, teacher_lengths, normalize_distill
        )
    else:
        distill = torch.zeros((), dtype=torch.float32, device=log_probs.device)

    total = weights.lambda_ctc * ctc + weights.lambda_distill * distill
    return {"total": total, "ctc": ctc, "distill": distill}
