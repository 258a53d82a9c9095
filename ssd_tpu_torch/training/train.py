"""Training CLI (PyTorch port of ``ssd_tpu/training/train.py``):

  python -m ssd_tpu_torch.training.train --config <config.json|yaml> \\
      [--run-dir …] [--init-checkpoint …] [--dry-run] [--overfit-batches N] \\
      [--resume] [--device cuda|cpu]

Same config schema, artifacts (``<run>/last``, ``<run>/best``,
``config.json``, scalars under ``tb/``), per-epoch validation with
best-checkpoint selection on val total loss, early stopping, per-epoch
distillation-λ warmup, strict=False warm starts and ``--resume``.

One step on one device: the featurizer (raw-EMG mode, through the CUDA
log-mel kernel), on-device augmentation, the encoder, both heads, CTC
(through the CUDA α/β kernels) and distillation MSE, backward, then clip +
AdamW through :class:`~ssd_tpu_torch.training.schedules.Optimizer`. The
encoder computes in ``model.encoder.compute_dtype`` (fp32 or bf16, the
parameters fp32) and rematerializes as ``remat`` / ``attn_remat`` say;
``data.teacher_dtype`` / ``emg_dtype: bfloat16`` move those batch arrays
as bf16. Dropout
and on-device augmentation draw from one ``torch.Generator`` on the device,
seeded with ``logging.seed + 1``; the model is initialized by
``init_flax_style`` from a generator seeded with ``logging.seed``.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); a missing card raises. Config values
that select a path this slice does not port raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import signal
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ssd_tpu_torch.data.augment import (
    ChannelDropoutConfig,
    SpecAugmentConfig,
    channel_dropout,
    spec_augment,
)
from ssd_tpu_torch.data.dataset import Batch, DataLoader, make_dataloader, prefetch
from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.models.conformer import init_flax_style
from ssd_tpu_torch.models.losses import LossWeights, distillation_mse
from ssd_tpu_torch.models.ssd_model import SSDModel, build_model
from ssd_tpu_torch.ops.ctc_loss import ctc_loss
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig, logmel_batch
from ssd_tpu_torch.training.checkpoint import (
    load_checkpoint,
    load_params_partial,
    save_checkpoint,
)
from ssd_tpu_torch.training.schedules import Optimizer, build_optimizer
from ssd_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class TrainState:
    model: SSDModel
    optimizer: Optimizer
    step: int = 0  # micro-steps taken, train and flush (the JAX state.step)


# --------------------------------------------------------------------------
# Steps
# --------------------------------------------------------------------------


def batch_to_arrays(batch: Batch, include_teacher: bool) -> Dict[str, np.ndarray]:
    arrays = {
        "emg": batch.emg,
        "emg_lengths": batch.emg_lengths,
        "tokens": batch.tokens,
        "token_lengths": batch.token_lengths,
        "weight": np.ones((batch.emg.shape[0],), np.float32),
    }
    if include_teacher and batch.teacher is not None:
        arrays["teacher"] = batch.teacher
        arrays["teacher_lengths"] = batch.teacher_lengths
    return arrays


def to_device(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch → tensors on ``device``; uint16 arrays are the loader's bf16
    bit patterns (``data.teacher_dtype`` / ``emg_dtype: bfloat16``) and
    arrive as bfloat16."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if v.dtype == np.uint16:
            t = t.view(torch.bfloat16)
        out[k] = t.to(device)
    return out


def _losses(
    model: SSDModel,
    batch: Dict[str, torch.Tensor],
    lambdas,
    blank_id: int,
    normalize_distill: bool,
    train: bool,
    generator: Optional[torch.Generator],
    augment: Optional[Tuple] = None,
    featurize: Optional[FeaturizerConfig] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its {"total", "ctc", "distill"} parts for one batch.

    ``train=True`` runs dropout and MaskedBatchNorm batch statistics (whose
    running averages update in place). ``featurize`` (raw-EMG mode) log-mels
    ``batch["emg"]`` inside the step; ``augment=(spec_cfg, chan_cfg,
    n_mels)`` runs channel dropout then SpecAugment on the device.
    """
    emg = batch["emg"]
    emg_lengths = batch["emg_lengths"]
    if featurize is not None:
        feats, emg_lengths, _, _ = logmel_batch(emg, emg_lengths, featurize)
        B, T, C, M = feats.shape
        emg = feats.reshape(B, T, C * M)
    if train and augment is not None and generator is not None:
        spec_cfg, chan_cfg, n_mels = augment
        if chan_cfg is not None:
            B, T, F = emg.shape
            emg = channel_dropout(
                emg.reshape(B, T, F // n_mels, n_mels), chan_cfg, generator
            ).reshape(B, T, F)
        if spec_cfg is not None:
            emg = spec_augment(emg, emg_lengths, spec_cfg, generator)

    log_probs, out_lengths, student = model(emg, emg_lengths, train=train, generator=generator)

    w = batch["weight"]
    w_sum = torch.clamp(w.sum(), min=1.0)
    per_sample = ctc_loss(log_probs, out_lengths, batch["tokens"], batch["token_lengths"], blank_id)
    denom = torch.clamp(batch["token_lengths"], min=1).to(torch.float32)
    ctc = (w * per_sample / denom).sum() / w_sum

    if "teacher" in batch:
        distill = distillation_mse(
            student,
            torch.where(w > 0, out_lengths, 0),
            batch["teacher"],
            batch["teacher_lengths"],
            normalize=normalize_distill,
        )
    else:
        distill = torch.zeros((), dtype=torch.float32, device=log_probs.device)

    total = lambdas[0] * ctc + lambdas[1] * distill
    return total, {"total": total, "ctc": ctc, "distill": distill}


def make_train_step(blank_id, normalize_distill, augment=None, featurize=None):
    """One micro-step: forward + loss, backward, optimizer (which applies an
    update every ``grad_accum`` micro-steps)."""

    def train_step(state: TrainState, batch, lambdas, generator):
        state.optimizer.zero_grad()
        total, losses = _losses(
            state.model, batch, lambdas, blank_id, normalize_distill, True,
            generator, augment, featurize,
        )
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in losses.items()}

    return train_step


def make_flush_step():
    """Zero-gradient micro-step: flushes a partial gradient accumulation.

    The accumulator keeps a running mean, so j real + (k−j) zero micro-steps
    update with (Σ grads)/k — the reference's 1/k-scaled leftover update. No
    forward pass runs, so the batch statistics are untouched.
    """

    def flush_step(state: TrainState) -> TrainState:
        state.optimizer.flush_micro_step()
        state.step += 1
        return state

    return flush_step


def flush_partial_accumulation(state: TrainState, flush_step, grad_accum: int) -> TrainState:
    """Apply the end-of-epoch leftover-gradient update (if any)."""
    if grad_accum <= 1:
        return state
    for _ in range((grad_accum - state.optimizer.mini_step) % grad_accum):
        state = flush_step(state)
    return state


def make_eval_step(blank_id, normalize_distill, featurize=None):
    """Losses with running statistics, no dropout and no statistics update."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, lambdas):
        _, losses = _losses(
            state.model, batch, lambdas, blank_id, normalize_distill, False,
            None, None, featurize,
        )
        return losses

    return eval_step


# --------------------------------------------------------------------------
# Epochs
# --------------------------------------------------------------------------


class PreemptionGuard:
    """SIGTERM/SIGINT → checkpoint-and-stop instead of dying mid-step.

    The signal sets a flag that the epoch loop polls at step granularity, so
    the run saves a resumable ``last`` checkpoint and returns. Installed only
    in the main thread (Python restricts signal handlers to it).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        self.requested = False
        self._signals = signals
        self._old: Dict[int, Any] = {}

    def _handler(self, signum, frame) -> None:  # pragma: no cover - signal path
        self.requested = True
        logger.warning("Signal %d received: checkpointing and stopping at the next step", signum)

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                try:
                    self._old[s] = signal.signal(s, self._handler)
                except (ValueError, OSError):  # pragma: no cover - exotic envs
                    pass
        return self

    def __exit__(self, *exc) -> bool:
        for s, h in self._old.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):  # pragma: no cover
                pass
        return False


def run_train_epoch(
    train_step,
    state: TrainState,
    loader: DataLoader,
    device: torch.device,
    lambdas,
    generator: Optional[torch.Generator],
    include_teacher: bool,
    writer,
    log_interval: int,
    schedule,
    grad_accum: int,
    stop_flag: Optional[PreemptionGuard] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    last_losses = None
    n_batches = 0
    n_utterances = 0
    epoch_start = time.time()
    for batch in prefetch(loader):
        if stop_flag is not None and stop_flag.requested:
            break
        arrays = batch_to_arrays(batch, include_teacher)
        state, losses = train_step(state, to_device(arrays, device), lambdas, generator)
        last_losses = losses
        n_batches += 1
        n_utterances += batch.size
        # float(...) below waits for the device; gated behind log_interval so
        # the steady-state loop stays asynchronous
        if writer is not None and n_batches % (log_interval * grad_accum) == 0:
            update = n_batches // grad_accum
            writer.add_scalar("train/total_loss", float(losses["total"]), update)
            writer.add_scalar("train/ctc_loss", float(losses["ctc"]), update)
            writer.add_scalar("train/distill_loss", float(losses["distill"]), update)
            writer.add_scalar("train/lr", float(schedule(update)), update)
    final = {k: float(v) for k, v in (last_losses or {}).items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = max(time.time() - epoch_start, 1e-9)
    final["batches"] = n_batches
    final["utterances_per_sec_per_chip"] = n_utterances / wall
    return state, final


def run_eval_epoch(
    eval_step, state: TrainState, loader: DataLoader, device: torch.device, lambdas,
    include_teacher: bool,
) -> Dict[str, float]:
    totals, ctcs, distills = [], [], []
    for batch in prefetch(loader):
        losses = eval_step(state, to_device(batch_to_arrays(batch, include_teacher), device), lambdas)
        totals.append(float(losses["total"]))
        ctcs.append(float(losses["ctc"]))
        distills.append(float(losses["distill"]))
    return {
        "total": float(np.mean(totals)) if totals else 0.0,
        "ctc": float(np.mean(ctcs)) if ctcs else 0.0,
        "distill": float(np.mean(distills)) if distills else 0.0,
        "batches": len(totals),
    }


# --------------------------------------------------------------------------
# Main
# --------------------------------------------------------------------------


def _augment_cfgs(cfg: Dict[str, Any]):
    spec_cfg = None
    spec = cfg.get("augmentation", {}).get("specaugment")
    if spec and spec.get("p", 0) > 0:
        spec_cfg = SpecAugmentConfig(
            time_masks=spec.get("time_masks", 2),
            time_mask_width=spec.get("time_mask_width", 0.05),
            freq_masks=spec.get("freq_masks", 2),
            freq_mask_width=spec.get("freq_mask_width", 8),
            p=spec.get("p", 0.0),
        )
    chan_cfg = None
    chan = cfg.get("augmentation", {}).get("channel_dropout")
    if chan and chan.get("p", 0) > 0:
        chan_cfg = ChannelDropoutConfig(
            p=chan.get("p", 0.0), max_channels=chan.get("max_channels", 1)
        )
    return spec_cfg, chan_cfg


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to ssd_tpu_torch yet (ROADMAP.md {item})")


def _check_slice(cfg: Dict[str, Any]) -> None:
    """Refuse config values outside the port, and ``data.emg_dtype:
    bfloat16`` without a bf16 encoder (the JAX trainer's check)."""
    par = cfg.get("parallel") or {}
    if int(par.get("model", 1)) > 1:
        raise _not_ported(f"parallel.model={par['model']}", "queue 1 item 10")
    data = par.get("data", "auto")
    if data not in ("auto", None) and int(data) > 1:
        raise _not_ported(f"parallel.data={data}", "queue 1 item 10")
    for key in ("fsdp", "sequence"):
        if par.get(key):
            raise _not_ported(f"parallel.{key}", "queue 1 item 10")
    if int(par.get("pipeline_microbatches", 0) or 0) > 0:
        raise _not_ported("parallel.pipeline_microbatches", "queue 1 item 10")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise _not_ported("training in more than one process", "queue 1 item 10")
    enc = cfg["model"]["encoder"]
    if enc.get("quantize", "none") != "none":
        raise _not_ported(f"model.encoder.quantize={enc['quantize']!r}", "queue 1 item 9")
    for key in ("emg_dtype", "teacher_dtype"):
        name = str(cfg["data"].get(key, "float32"))
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"data.{key} must be float32|bfloat16, got {name}")
    if str(cfg["data"].get("emg_dtype", "float32")) == "bfloat16":
        if enc.get("compute_dtype", "float32") != "bfloat16":
            raise ValueError(
                "data.emg_dtype: bfloat16 requires model.encoder.compute_dtype: "
                "bfloat16 (otherwise it silently changes training numerics)"
            )


def train_from_config(
    cfg: Dict[str, Any],
    run_dir: Path,
    init_checkpoint: Optional[Path] = None,
    dry_run: bool = False,
    overfit_batches: int = 0,
    writer=None,
    resume: bool = False,
    device: str | torch.device = "cuda",
    profile_dir: Optional[Path] = None,
) -> Dict[str, Any]:
    """Programmatic entry; returns a summary (best epoch/val, per-epoch losses).

    ``resume=True`` continues from ``<run_dir>/last`` (weights, optimizer
    state, epoch and step); best-checkpoint tracking restarts there.
    ``profile_dir`` captures a ``torch.profiler`` trace of the first epoch.
    """
    dev = resolve_device(device)
    _check_slice(cfg)
    run_dir = Path(run_dir)
    seed = int(cfg["logging"].get("seed", 42))
    np.random.seed(seed)
    vocab = Vocab.from_json(Path(cfg["data"]["vocab"]))
    spec_cfg, chan_cfg = _augment_cfgs(cfg)
    # raw mode featurizes on device, so augmentation moves there with it
    train_from_raw = bool(cfg["data"].get("train_from_raw", False))
    on_device_augment = train_from_raw or bool(
        cfg.get("augmentation", {}).get("on_device", False)
    )
    loader_spec_cfg, loader_chan_cfg = (None, None) if on_device_augment else (spec_cfg, chan_cfg)
    featurize = FeaturizerConfig.from_config(cfg) if train_from_raw else None

    include_teacher = bool(cfg["data"].get("include_teacher", True))
    teacher_strict = bool(cfg["data"].get("teacher_strict", True))

    train_limit = val_limit = None
    shuffle_train = True
    if overfit_batches > 0:
        train_limit = val_limit = overfit_batches * cfg["optim"]["batch_size"]
        shuffle_train = False
        logger.info("Overfitting on %d batches (~%d items)", overfit_batches, train_limit)

    num_workers = int(cfg["data"].get("num_workers", cfg["optim"].get("num_workers", 0)))
    if num_workers > 0:
        logger.info(
            "num_workers=%d: the loader runs in-process with its prefetch thread "
            "(batches are bit-identical either way; the worker pool is ROADMAP.md "
            "queue 1 item 15)", num_workers,
        )
    if bool(cfg["logging"].get("async_checkpoints", False)):
        logger.info(
            "logging.async_checkpoints: true is not honoured: the port saves each "
            "checkpoint synchronously (the saved contents are the same either way)"
        )
    common = dict(
        index_path=Path(cfg["data"]["index"]),
        features_root=Path(cfg["data"]["features_root"]),
        vocab=vocab,
        include_teacher=include_teacher,
        strict=teacher_strict,
        raw=train_from_raw,
        raw_hop_length=featurize.hop_length if featurize else 10,
        # bf16 halves the host copy and host→device bytes of these arrays;
        # the distillation loss upcasts the teacher, the encoder casts its
        # input to its compute dtype
        teacher_dtype=str(cfg["data"].get("teacher_dtype", "float32")),
        emg_dtype=str(cfg["data"].get("emg_dtype", "float32")),
    )
    train_loader = make_dataloader(
        splits=cfg["data"]["train_splits"],
        subsets=cfg["data"].get("train_subsets"),
        batch_size=cfg["optim"]["batch_size"],
        shuffle=shuffle_train,
        seed=seed,
        spec_augment_cfg=loader_spec_cfg,
        channel_dropout_cfg=loader_chan_cfg,
        max_items=train_limit,
        **common,
    )
    val_loader = make_dataloader(
        splits=cfg["data"]["val_splits"],
        subsets=cfg["data"].get("val_subsets"),
        batch_size=max(1, cfg["optim"]["batch_size"] // 2),
        shuffle=False,
        seed=seed,
        max_items=val_limit,
        **common,
    )
    logger.info(
        "Train batches: %d | Val batches: %d | batch %d | accum %d | device %s",
        len(train_loader), len(val_loader), cfg["optim"]["batch_size"],
        cfg["optim"].get("grad_accum", 1), dev,
    )
    if len(train_loader.dataset) == 0:
        raise ValueError("Empty training dataset after filtering.")
    first = train_loader.dataset.get(0)
    if train_from_raw:
        input_dim = first["emg"].shape[1] * featurize.n_mels
    else:
        input_dim = first["emg"].shape[1]
    # the checkpoint's config must describe the model on its own (serving
    # featurizes raw EMG and has no cache to probe)
    cfg.setdefault("model", {}).setdefault("encoder", {})["input_dim"] = int(input_dim)

    grad_accum = int(cfg["optim"].get("grad_accum", 1))
    max_epochs = 1 if dry_run else int(cfg["optim"].get("max_epochs", 1))
    updates_per_epoch = max(1, math.ceil(len(train_loader) / grad_accum))
    total_updates = max_epochs * updates_per_epoch

    model = build_model(cfg, input_dim=input_dim, vocab_size=vocab.size)
    init_flax_style(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    optimizer, schedule = build_optimizer(cfg, model.parameters(), total_updates)
    state = TrainState(model=model, optimizer=optimizer)
    generator = torch.Generator(dev).manual_seed(seed + 1)

    if init_checkpoint is not None:
        logger.info("Warm start from %s", init_checkpoint)
        payload = load_checkpoint(Path(init_checkpoint))
        model.load_state_dict(load_params_partial(model.state_dict(), payload["state_dict"]))

    start_epoch = 1
    if resume and (run_dir / "last").exists():
        payload = load_checkpoint(run_dir / "last")
        if "optimizer" not in payload or "epoch" not in payload:
            raise ValueError(
                f"{run_dir / 'last'} holds weights only (no optimizer state / epoch); "
                "warm start from it with --init-checkpoint instead of --resume"
            )
        model.load_state_dict(payload["state_dict"])
        optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        start_epoch = int(payload["epoch"]) + 1
        train_loader.epoch = start_epoch - 1  # keep per-epoch shuffles distinct
        logger.info("Resuming %s at epoch %d", run_dir, start_epoch)

    base_weights = LossWeights(
        lambda_distill=float(cfg["loss"]["lambda_distill"]),
        lambda_ctc=float(cfg["loss"]["lambda_ctc"]),
    )
    normalize_distill = bool(cfg["loss"].get("distill_normalize", False))
    distill_warmup_epochs = int(cfg["loss"].get("distill_warmup_epochs") or 0)
    blank_id = vocab.blank_id

    augment = None
    if on_device_augment and (spec_cfg is not None or chan_cfg is not None):
        n_mels = cfg.get("features", {}).get("emg", {}).get("n_mels", 80)
        augment = (spec_cfg, chan_cfg, int(n_mels))
    train_step = make_train_step(blank_id, normalize_distill, augment, featurize)
    eval_step = make_eval_step(blank_id, normalize_distill, featurize)
    flush_step = make_flush_step() if grad_accum > 1 else None

    early = cfg["optim"].get("early_stopping", {}) or {}
    patience = int(early.get("patience", 0))
    min_delta = float(early.get("min_delta", 0.0))

    def checkpoint(epoch: int, is_best: bool) -> None:
        save_checkpoint(
            run_dir, model.state_dict(), cfg, is_best=is_best,
            optimizer=optimizer.state_dict(), epoch=epoch, step=state.step,
        )

    best_val = float("inf")
    best_epoch = 0
    patience_counter = 0
    history = []
    epoch = start_epoch - 1
    preempted = False
    with _deterministic_cudnn(dev), PreemptionGuard() as guard:
        for epoch in range(start_epoch, max_epochs + 1):
            warmup_scale = 1.0
            if distill_warmup_epochs > 0:
                warmup_scale = min(1.0, epoch / float(distill_warmup_epochs))
            lambdas = np.asarray(
                [base_weights.lambda_ctc, base_weights.lambda_distill * warmup_scale], np.float32
            ).tolist()
            start = time.time()
            with _maybe_profile(profile_dir if epoch == start_epoch else None, dev):
                state, train_losses = run_train_epoch(
                    train_step, state, train_loader, dev, lambdas, generator,
                    include_teacher, writer, cfg["logging"].get("log_interval", 10),
                    schedule, grad_accum, stop_flag=guard,
                )
            if guard.requested:
                # save a resumable `last` labeled with the LAST COMPLETED
                # epoch: --resume re-runs the interrupted one
                checkpoint(epoch - 1, is_best=False)
                logger.warning(
                    "Preempted during epoch %d: saved resumable 'last' "
                    "(resume with --resume; the epoch re-runs)", epoch,
                )
                preempted = True
                break
            if flush_step is not None:
                state = flush_partial_accumulation(state, flush_step, grad_accum)
            train_time = time.time() - start
            val_losses = run_eval_epoch(eval_step, state, val_loader, dev, lambdas, include_teacher)
            history.append({"epoch": epoch, "train": train_losses, "val": val_losses})
            logger.info(
                "Epoch %d done in %.1fs | train total %.4f | val total %.4f (ctc %.4f, "
                "distill %.4f) | λ_ctc %.2f λ_distill %.2f | %.2f utt/s",
                epoch, train_time, train_losses.get("total", float("nan")),
                val_losses["total"], val_losses["ctc"], val_losses["distill"],
                lambdas[0], lambdas[1], train_losses["utterances_per_sec_per_chip"],
            )
            if writer is not None:
                writer.add_scalar("val/total_loss", val_losses["total"], epoch)
                writer.add_scalar("val/ctc_loss", val_losses["ctc"], epoch)
                writer.add_scalar("val/distill_loss", val_losses["distill"], epoch)
                writer.add_scalar("train/lambda_ctc", float(lambdas[0]), epoch)
                writer.add_scalar("train/lambda_distill", float(lambdas[1]), epoch)

            is_best = val_losses["total"] < (best_val - min_delta)
            if is_best:
                best_val = val_losses["total"]
                best_epoch = epoch
                patience_counter = 0
            else:
                patience_counter += 1
            checkpoint(epoch, is_best)

            if dry_run:
                break
            if patience and patience_counter >= patience:
                logger.info(
                    "Early stopping at epoch %d (best %d, val %.4f)", epoch, best_epoch, best_val
                )
                break

    return {
        "best_epoch": best_epoch,
        "best_val": best_val,
        "epochs": epoch,
        "preempted": preempted,
        "history": history,
    }


@contextlib.contextmanager
def _deterministic_cudnn(dev: torch.device):
    """cuDNN's deterministic algorithms (and no autotuning) while training on
    the card, both flags restored on exit: the composite path's convolution
    backward otherwise picks algorithms that add in atomic order, and the
    same seed would not give the same losses run to run (the JAX package's
    contract, ``tests/test_determinism.py``). The port's own kernels and its
    CTC gradient add in a fixed order already."""
    if dev.type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _maybe_profile(profile_dir: Optional[Path], dev: torch.device):
    """A ``torch.profiler`` trace written to ``profile_dir/trace.json``."""
    if profile_dir is None:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def traced():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            yield
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
        logger.info("Wrote a torch.profiler trace of the first epoch to %s", profile_dir)

    return traced()


class JsonlScalarWriter:
    """Where tensorboardX is missing: the same tags, one JSON object a line
    (``{"tag", "value", "step", "wall_time"}``) in ``<log_dir>/scalars.jsonl``."""

    def __init__(self, log_dir: Path) -> None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self.path = Path(log_dir) / "scalars.jsonl"
        self._f = self.path.open("a", encoding="utf-8")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step), "wall_time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def make_writer(log_dir: Path):
    """tensorboardX's ``SummaryWriter`` where installed, else :class:`JsonlScalarWriter`."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        writer = JsonlScalarWriter(log_dir)
        logger.info("tensorboardX is not installed: scalars go to %s", writer.path)
        return writer
    return SummaryWriter(log_dir=str(log_dir))


def _parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the EMG-to-text model (PyTorch port).")
    p.add_argument("--config", type=Path, required=True, help="JSON or YAML config.")
    p.add_argument("--run-dir", type=Path)
    p.add_argument("--init-checkpoint", type=Path)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--overfit-batches", type=int, default=0)
    p.add_argument(
        "--resume",
        action="store_true",
        help="Continue mid-run from <run-dir>/last (weights + optimizer state + epoch).",
    )
    p.add_argument(
        "--profile-dir",
        type=Path,
        help="Capture a torch.profiler trace of the first epoch into this dir.",
    )
    p.add_argument(
        "--compile-cache",
        type=Path,
        help="Accepted for CLI parity with the JAX trainer; nothing is compiled "
        "ahead here, so it is ignored.",
    )
    p.add_argument(
        "--device", default="cuda", help="cuda (default), cuda:N or cpu; no card raises."
    )
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ssd_tpu_torch.utils.config import load_config, setup_cli_logging

    setup_cli_logging()
    args = _parse_args(argv)
    if args.compile_cache:
        logger.info("--compile-cache %s ignored: the port compiles nothing ahead", args.compile_cache)
    cfg = load_config(args.config)
    run_name = cfg["logging"].get("run_name", "run")
    run_dir = args.run_dir or Path("results/checkpoints") / run_name
    writer = make_writer(run_dir / "tb")
    try:
        train_from_config(
            cfg,
            run_dir,
            init_checkpoint=args.init_checkpoint,
            dry_run=args.dry_run,
            overfit_batches=args.overfit_batches,
            resume=args.resume,
            writer=writer,
            device=args.device,
            profile_dir=args.profile_dir,
        )
    finally:
        writer.close()


if __name__ == "__main__":
    main()
