"""Plain reference of one training step: features (raw EMG through
:func:`~benchmark.reference.features.logmel`, then on-device SpecAugment),
the model, CTC (``torch.nn.functional.ctc_loss``) and distillation MSE
against the teacher resized to the student's frames, backward, global-norm
clipping (scale by clip / norm when norm ≥ clip), AdamW (b1 0.9, b2 0.999,
eps 1e-8, decoupled decay on every parameter) at the warm-up-then-hold
learning rate. Everything it computes it computes again from the inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import features as feat
from benchmark.reference import model as ref

BETAS = (0.9, 0.999)
EPS = 1e-8


def lr_at(cfg: dict, update: int) -> float:
    """``warmup_hold``: base · min((update + 1) / warmup, 1)."""
    base = float(cfg["optim"]["lr"])
    sched = cfg["optim"].get("scheduler") or {}
    warm = int(sched.get("warmup_steps", 0))
    if sched.get("name") != "warmup_hold":
        raise ValueError(f"the reference knows warmup_hold only, not {sched.get('name')!r}")
    return base if warm <= 0 else base * min((update + 1) / warm, 1.0)


def lambdas(cfg: dict, epoch: int = 1) -> tuple:
    """(λ_ctc, λ_distill) of ``epoch``: the distillation weight ramps over
    ``distill_warmup_epochs``."""
    loss = cfg["loss"]
    warm = int(loss.get("distill_warmup_epochs") or 0)
    scale = min(1.0, epoch / float(warm)) if warm > 0 else 1.0
    return tuple(np.asarray([loss["lambda_ctc"], float(loss["lambda_distill"]) * scale],
                            np.float32).tolist())


def distill_mse(student: torch.Tensor, s_len: torch.Tensor, teacher: torch.Tensor,
                t_len: torch.Tensor) -> torch.Tensor:
    """Masked MSE between student frames and the teacher linearly resized to
    them (centres aligned, edges clamped), over min(student, rescaled
    teacher) frames, divided by frames · dim."""
    B, ts, d = student.shape
    tt = teacher.shape[1]
    t = teacher.float()
    if tt != ts:
        t = F.interpolate(t.transpose(1, 2), size=ts, mode="linear",
                          align_corners=False).transpose(1, 2)
        t_len = torch.clamp(torch.round(t_len.float() * (ts / tt)).to(torch.int64), 0, ts)
    valid = torch.minimum(torch.clamp(s_len, 0, ts), t_len.to(s_len.dtype))
    mask = torch.arange(ts, device=student.device)[None, :] < valid[:, None]
    return ((student - t).square() * mask[:, :, None]).sum() / torch.clamp(mask.sum() * d, min=1)


def losses(cfg: dict, p: ref.Params, batch: Dict[str, torch.Tensor], blank_id: int,
           generator: torch.Generator, quant=None) -> Dict[str, torch.Tensor]:
    """{"total", "ctc", "distill"} of one batch in training mode."""
    emg, lengths = batch["emg"], batch["emg_lengths"]
    if cfg["data"].get("train_from_raw", False):
        femg = cfg["features"]["emg"]
        emg, lengths = feat.logmel(emg, lengths, femg["sample_rate"], femg["n_fft"],
                                   femg["hop_length"], femg["n_mels"])
        spec = cfg.get("augmentation", {}).get("specaugment")
        if spec and spec.get("p", 0) > 0:
            emg = feat.spec_augment_device(emg, lengths, spec, generator)
    c = ref.Context(cfg, train=True, generator=generator, quant=quant)
    enc, out_lengths = ref.encode(c, p, emg, lengths)
    log_probs, student = ref.heads(c, p, enc)
    tok_lens = batch["token_lengths"].to(torch.int64)
    per = F.ctc_loss(log_probs.transpose(0, 1), batch["tokens"].to(torch.int64), out_lengths,
                     tok_lens, blank=blank_id, reduction="none", zero_infinity=True)
    ctc = (per / torch.clamp(tok_lens, min=1).float()).mean()
    distill = distill_mse(student, out_lengths, batch["teacher"], batch["teacher_lengths"])
    lam = lambdas(cfg)
    return {"total": lam[0] * ctc + lam[1] * distill, "ctc": ctc, "distill": distill}


class AdamW:
    """Global-norm clip + AdamW over the trainable entries of ``p``."""

    def __init__(self, cfg: dict, p: ref.Params, names: List[str]):
        self.cfg = cfg
        self.p = p
        self.names = names
        self.clip = float(cfg["optim"].get("clip_grad_norm", 0.0))
        self.wd = float(cfg["optim"].get("weight_decay", 0.0))
        self.m = {n: torch.zeros_like(p[n]) for n in names}
        self.v = {n: torch.zeros_like(p[n]) for n in names}
        self.t = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Applies one update; returns the (clipped) gradient it used."""
        grads = {n: self.p[n].grad if self.p[n].grad is not None else torch.zeros_like(self.p[n])
                 for n in self.names}
        if self.clip > 0:
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
            if float(norm) >= self.clip:
                grads = {n: g / norm * self.clip for n, g in grads.items()}
        lr = lr_at(self.cfg, self.t)
        self.t += 1
        b1, b2 = BETAS
        for n in self.names:
            w, g = self.p[n], grads[n]
            w.mul_(1 - lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(EPS)
            w.addcdiv_(self.m[n], denom, value=-lr / (1 - b1 ** self.t))
            w.grad = None
        return grads


def train_steps(cfg: dict, p: ref.Params, batches: List[Dict[str, torch.Tensor]], blank_id: int,
                generator: torch.Generator, quant=None) -> Dict[str, list]:
    """Runs ``batches`` as consecutive steps from ``p`` (updated in place).
    Returns each step's total loss, each leaf's clipped gradient norm at the
    first step, and each leaf's change norm after the last."""
    names = [n for n in p if not ref.is_buffer(n)]
    start = {n: p[n].detach().clone() for n in names}
    for n in names:
        p[n].requires_grad_(True)
    opt = AdamW(cfg, p, names)
    out: Dict[str, list] = {"loss": []}
    for i, b in enumerate(batches):
        parts = losses(cfg, p, b, blank_id, generator, quant)
        parts["total"].backward()
        g = opt.step()
        out["loss"].append(float(parts["total"].detach()))
        if i == 0:
            out["grad_norm"] = [float(g[n].norm()) for n in names]
    out["change_norm"] = [float((p[n].detach() - start[n]).norm()) for n in names]
    out["names"] = names
    return out


def to_tensors(batch: Dict[str, np.ndarray], device, teacher_dtype: str) -> Dict[str, torch.Tensor]:
    """A padded numpy batch on ``device``; the teacher rounded to bf16 where
    the configuration moves it so."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    if teacher_dtype == "bfloat16":
        out["teacher"] = out["teacher"].to(torch.bfloat16).float()
    return out


def leaf_gap(prog: List[float], want: List[float], keep: Optional[List[bool]] = None) -> float:
    """Worst leaf: |prog − want| / max(want, median of ``want`` over the
    counted leaves), over the leaves ``keep`` counts."""
    p, w = np.asarray(prog, np.float64), np.asarray(want, np.float64)
    k = np.ones(len(w), bool) if keep is None else np.asarray(keep, bool)
    med = float(np.median(w[k]))
    return float(np.max(np.abs(p[k] - w[k]) / np.maximum(w[k], med)))
