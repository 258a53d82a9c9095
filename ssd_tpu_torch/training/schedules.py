"""Learning-rate schedules and the optimizer (PyTorch port of
``ssd_tpu/training/schedules.py``).

The schedules are plain functions of the 0-based optimizer-update count,
the three of the JAX package (``cosine``, ``linear``, ``warmup_hold``).
:class:`Optimizer` reproduces the optax chain ``MultiSteps(chain(
clip_by_global_norm, adamw))``:

* gradient accumulation as ``optax.MultiSteps``: the running mean of k
  micro-batch gradients (``acc + (g − acc)/(n + 1)``), one update per k;
* clipping the optax way: scale by ``clip / norm`` only when
  ``norm >= clip`` — not ``clip_grad_norm_``'s ``clip / (norm + 1e-6)``;
* AdamW with b1 0.9, b2 0.999, eps 1e-8 and decoupled decay on every
  parameter (``torch.optim.AdamW``, whose update is optax's ``adamw``);
* lr = ``schedule(update_count)``, set on the param group before each update.

Over a mesh the parameters may be local TP slices or FSDP2 ``DTensor``
shards: the accumulation and the clip work on each one's local tensor,
``grad_norm`` (``parallel/partition.py:grad_norm_fn``) takes the norm over
the whole mesh, and :meth:`Optimizer.state_dict` / ``load_state_dict`` take
a ``gather`` / ``scatter`` that turn each per-parameter tensor into the
full one and back, so the saved state is the same at any topology.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ssd_tpu_torch.parallel.partition import local_tensor as _local

Schedule = Callable[[int], float]
PerParam = Callable[[int, torch.Tensor], torch.Tensor]


def build_schedule(cfg: Dict[str, Any], base_lr: float, total_updates: int) -> Schedule:
    """Schedule factory over the reference's ``optim.scheduler`` block."""
    sched_cfg = cfg.get("optim", {}).get("scheduler")
    if not sched_cfg:
        return lambda step: base_lr

    if isinstance(sched_cfg, str):
        name, params = sched_cfg, {}
    else:
        params = dict(sched_cfg)
        name = params.get("name", params.get("type", ""))
    name = str(name).lower()
    total_updates = max(1, total_updates)

    if name in {"cosine", "cosineannealing", "cosine_annealing"}:
        t_max = int(params.get("t_max", total_updates))
        eta_min = float(params.get("eta_min", 0.0))

        def cosine(step: int) -> float:
            frac = min(step, t_max) / t_max
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * frac))

        return cosine

    if name in {"linear", "linear_warmup", "warmup"}:
        warmup = int(params.get("warmup_steps", 0))
        decay = int(params.get("total_steps", total_updates))

        def linear(step: int) -> float:
            if step < warmup:
                return base_lr * (step + 1) / max(1, warmup)
            return base_lr * max(0.0, 1.0 - (step - warmup) / max(1, decay - warmup))

        return linear

    if name in {"warmup_hold", "warmup_constant", "warmup_const"}:
        warmup = int(params.get("warmup_steps", 0))

        def warmup_hold(step: int) -> float:
            if warmup <= 0:
                return base_lr
            return base_lr * min((step + 1) / warmup, 1.0)

        return warmup_hold

    raise ValueError(f"Unknown scheduler {name!r}")


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax's global norm of the tensors this process holds."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([_local(g) for g in grads])))


class Optimizer:
    """Clip + AdamW + schedule + gradient accumulation over ``params``.

    :meth:`step` consumes the parameters' ``.grad`` (a missing one counts as
    zeros) as one micro-step and returns whether an update was applied.
    :meth:`flush_micro_step` is a zero-gradient micro-step.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: Schedule,
        weight_decay: float = 0.0,
        clip: float = 0.0,
        grad_accum: int = 1,
        grad_norm: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None,
    ) -> None:
        self.params: List[torch.nn.Parameter] = list(params)
        self.grad_norm = grad_norm
        self.schedule = schedule
        self.clip = float(clip)
        self.grad_accum = max(1, int(grad_accum))
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.update_count = 0  # optimizer updates applied (the schedule's step)
        self.mini_step = 0  # micro-steps in the open accumulation window
        self._acc: Optional[List[torch.Tensor]] = None

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    # foreach ops throughout: one launch per op for all ~200 tensors, not
    # one per tensor (the per-tensor loop made the optimizer host-bound)
    @torch.no_grad()
    def _micro_step(self, grads: List[torch.Tensor]) -> bool:
        if self.grad_accum > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            # MultiSteps' running mean: acc + (g − acc) / (n + 1)
            acc = [_local(a) for a in self._acc]
            delta = torch._foreach_sub([_local(g) for g in grads], acc)
            torch._foreach_div_(delta, self.mini_step + 1)
            torch._foreach_add_(acc, delta)
            self.mini_step = (self.mini_step + 1) % self.grad_accum
            if self.mini_step:
                return False
            grads = self._acc
        self._apply(grads)
        if self._acc is not None:
            torch._foreach_zero_(self._acc)
        return True

    @torch.no_grad()
    def _apply(self, grads: List[torch.Tensor]) -> None:
        if self.clip > 0:
            norm = (self.grad_norm or _global_norm)(grads)
            # optax.clip_by_global_norm: (g / norm) · clip iff norm >= clip,
            # in that order; below the clip g / 1 · 1 leaves g exact. Each
            # local tensor (a shard's, over a mesh) is scaled in place
            keep = norm < self.clip
            one = torch.ones_like(norm)
            local = [_local(g) for g in grads]
            torch._foreach_div_(local, torch.where(keep, one, norm))
            torch._foreach_mul_(local, torch.where(keep, one, torch.full_like(norm, self.clip)))
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.update_count)
        self.adamw.step()
        self.update_count += 1

    def step(self) -> bool:
        return self._micro_step(self._grads())

    def flush_micro_step(self) -> bool:
        return self._micro_step([torch.zeros_like(p) for p in self.params])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    # ------------------------------------------------------------- state
    def state_dict(self, gather: Optional[PerParam] = None) -> Dict[str, Any]:
        """``gather(i, t)`` maps parameter ``i``'s moment or accumulator to
        the tensor to save (collective over a mesh: every rank calls it)."""
        adamw = self.adamw.state_dict()
        if gather is not None:
            adamw["state"] = {
                i: {k: gather(i, v) if k != "step" else v for k, v in st.items()}
                for i, st in adamw["state"].items()
            }
        g = gather or (lambda i, a: a.detach().cpu())
        return {
            "adamw": adamw,
            "update_count": self.update_count,
            "mini_step": self.mini_step,
            "acc": None if self._acc is None else [g(i, a) for i, a in enumerate(self._acc)],
        }

    def load_state_dict(self, state: Dict[str, Any], scatter: Optional[PerParam] = None) -> None:
        """``scatter(i, t)`` cuts a saved full tensor to parameter ``i``'s
        piece (the inverse of :meth:`state_dict`'s ``gather``)."""
        adamw = state["adamw"]
        if scatter is not None:
            adamw = dict(adamw, state={
                i: {k: scatter(int(i), v) if k != "step" else v for k, v in st.items()}
                for i, st in adamw["state"].items()
            })
        self.adamw.load_state_dict(adamw)
        self.update_count = int(state["update_count"])
        self.mini_step = int(state["mini_step"])
        acc = state.get("acc")
        if acc is None:
            self._acc = None
        elif scatter is not None:
            self._acc = [scatter(i, a) for i, a in enumerate(acc)]
        else:
            self._acc = [a.to(p.device) for a, p in zip(acc, self.params)]


def build_optimizer(
    cfg: Dict[str, Any], params: Iterable[torch.nn.Parameter], total_updates: int,
    grad_norm: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None,
) -> Tuple[Optimizer, Schedule]:
    """AdamW + clip + schedule + grad accumulation (reference semantics)."""
    optim_cfg = cfg["optim"]
    schedule = build_schedule(cfg, float(optim_cfg["lr"]), total_updates)
    opt = Optimizer(
        params,
        schedule,
        weight_decay=float(optim_cfg.get("weight_decay", 0.0)),
        clip=float(optim_cfg.get("clip_grad_norm", 0.0)),
        grad_accum=int(optim_cfg.get("grad_accum", 1)),
        grad_norm=grad_norm,
    )
    return opt, schedule
