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
(``device="cpu"`` / ``--device cpu``); a missing card raises.

``data.num_workers`` (else ``optim.num_workers``, the JAX trainer's keys)
builds both loaders' batches in that many worker processes
(``data/dataset.py``), bit-identical to ``0``; the trainer closes them when
it returns or raises. The count is the host's, as in the JAX package, where
one process drives a host: under ``torchrun`` each of a node's
``LOCAL_WORLD_SIZE`` ranks builds the whole node batch and takes its rows,
so each starts ``max(1, num_workers // LOCAL_WORLD_SIZE)`` workers.

Over several cards (``python -m torch.distributed.run --nproc-per-node N
-m ssd_tpu_torch.training.train ...``, one process a card, NCCL; gloo with
``--device cpu``) the ``parallel:`` block places the model over a ``(data,
model)`` mesh (``parallel/``): data parallelism, ``model`` tensor
parallelism, ``sequence`` parallelism and ``fsdp``, as the JAX trainer
reads them; ``pipeline_microbatches: M`` makes the ``model`` ranks GPipe
stages instead (``parallel/pipeline.py``), each data rank's rows padded to
a multiple of M with weight-0 rows (one process too, as the JAX trainer
pads). Each rank takes its rows of the node's batch; the CTC weight sum,
the distillation count and the BatchNorm statistics are those of the
global batch, and each rank's loss is scaled so that the averaged gradient
is the global batch's.
Logging, scalars and checkpoints are rank 0's; a checkpoint holds the full
tensors, so it loads at any topology.

``logging.async_checkpoints: true`` writes each checkpoint on a background
thread from a host copy taken at the save, while the next epoch trains
(:class:`~ssd_tpu_torch.training.checkpoint.CheckpointWriter`); the files
are the synchronous save's, and they have landed when the trainer returns
or raises. ``--compile-cache DIR`` (or ``$SSD_COMPILE_CACHE``) is where the
kernels and the host library are built and found again
(:func:`~ssd_tpu_torch.utils.cuda_build.enable_compile_cache`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
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
from ssd_tpu_torch.ops.dropout import RngStreams, stream
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig, logmel_batch
from ssd_tpu_torch.parallel.mesh import (
    ParallelContext,
    RowSplit,
    maybe_initialize_distributed,
    mesh_from_config,
    rank_device,
    row_split,
)
from ssd_tpu_torch.parallel.partition import (
    full_state_dict,
    gather_for,
    grad_norm_fn,
    local_piece,
    shard_model,
    sync_grads,
)
from ssd_tpu_torch.training.checkpoint import (
    CheckpointWriter,
    load_checkpoint,
    load_params_partial,
)
from ssd_tpu_torch.training.schedules import Optimizer, build_optimizer
from ssd_tpu_torch.utils.cuda_build import enable_compile_cache
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
    par: Optional[ParallelContext] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its {"total", "ctc", "distill"} parts for one batch.

    ``train=True`` runs dropout and MaskedBatchNorm batch statistics (whose
    running averages update in place). ``featurize`` (raw-EMG mode) log-mels
    ``batch["emg"]`` inside the step; ``augment=(spec_cfg, chan_cfg,
    n_mels)`` runs channel dropout then SpecAugment on the device.

    Over ``data`` ranks (``par``) the weight sum and the distillation count
    are the global batch's: the returned total is this rank's share of the
    global loss, the parts dict the global values.
    """
    dp = par is not None and par.data > 1
    emg = batch["emg"]
    emg_lengths = batch["emg_lengths"]
    if featurize is not None:
        feats, emg_lengths, _, _ = logmel_batch(emg, emg_lengths, featurize)
        B, T, C, M = feats.shape
        emg = feats.reshape(B, T, C * M)
    if train and augment is not None and generator is not None:
        spec_cfg, chan_cfg, n_mels = augment
        generator = stream(generator, "replicated")
        if chan_cfg is not None:
            B, T, F = emg.shape
            emg = channel_dropout(
                emg.reshape(B, T, F // n_mels, n_mels), chan_cfg, generator
            ).reshape(B, T, F)
        if spec_cfg is not None:
            emg = spec_augment(emg, emg_lengths, spec_cfg, generator)

    log_probs, out_lengths, student = model(emg, emg_lengths, train=train, generator=generator)

    w = batch["weight"]
    w_sum = torch.clamp(par.all_reduce(w.sum()) if dp else w.sum(), min=1.0)
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
            count_reduce=par.all_reduce if dp else None,
        )
    else:
        distill = torch.zeros((), dtype=torch.float32, device=log_probs.device)

    total = lambdas[0] * ctc + lambdas[1] * distill
    parts = {"total": total, "ctc": ctc, "distill": distill}
    if dp:
        summed = par.all_reduce(torch.stack([total, ctc, distill]).detach())
        parts = dict(zip(("total", "ctc", "distill"), summed.unbind()))
    return total, parts


def make_train_step(blank_id, normalize_distill, augment=None, featurize=None, par=None):
    """One micro-step: forward + loss, backward, optimizer (which applies an
    update every ``grad_accum`` micro-steps). Over a mesh (``par``) each
    rank's share of the loss is scaled by the data degree, and the
    gradients are summed over ``model`` where T-sharded and averaged over
    ``data`` (``parallel/partition.py:sync_grads``) before the update."""

    def train_step(state: TrainState, batch, lambdas, generator):
        state.optimizer.zero_grad()
        total, losses = _losses(
            state.model, batch, lambdas, blank_id, normalize_distill, True,
            generator, augment, featurize, par,
        )
        if par is not None and par.data > 1:
            total = total * par.data
        total.backward()
        sync_grads(state.model)
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


def make_eval_step(blank_id, normalize_distill, featurize=None, par=None):
    """Losses with running statistics, no dropout and no statistics update
    (the global batch's over a mesh)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, lambdas):
        _, losses = _losses(
            state.model, batch, lambdas, blank_id, normalize_distill, False,
            None, None, featurize, par,
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


# over a mesh: how many batches between agreements on the stop flag (each a
# one-element all-reduce: cheap, but a host sync)
_PREEMPT_SYNC_EVERY = 32


def _stop_requested_globally(guard: PreemptionGuard, device: torch.device) -> bool:
    """True iff ANY rank was signalled, the same answer on every rank: a
    rank that stopped alone would leave the others blocked in the next
    step's collectives."""
    import torch.distributed as dist

    flag = torch.tensor([int(guard.requested)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


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
    split: RowSplit = RowSplit(),
    par: Optional[ParallelContext] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    last_losses = None
    n_batches = 0
    n_utterances = 0
    epoch_start = time.time()
    for batch in prefetch(loader):
        # one process polls its flag every batch; ranks agree every
        # _PREEMPT_SYNC_EVERY batches (they all step the same batch count)
        if stop_flag is not None:
            if par is None:
                if stop_flag.requested:
                    break
            elif n_batches % _PREEMPT_SYNC_EVERY == 0 and _stop_requested_globally(
                    stop_flag, device):
                break
        arrays = split.take(batch_to_arrays(batch, include_teacher), batch.size)
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
    # the node batches of every node, over every device (JAX: mesh.size)
    world = par.world if par is not None else 1
    final["utterances_per_sec_per_chip"] = n_utterances * split.num_shards / wall / world
    return state, final


def run_eval_epoch(
    eval_step, state: TrainState, loader: DataLoader, device: torch.device, lambdas,
    include_teacher: bool, split: RowSplit = RowSplit(),
) -> Dict[str, float]:
    totals, ctcs, distills = [], [], []
    for batch in prefetch(loader):
        arrays = split.take(batch_to_arrays(batch, include_teacher), batch.size)
        losses = eval_step(state, to_device(arrays, device), lambdas)
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


def _parallel_context(cfg: Dict[str, Any], dev: torch.device) -> Optional[ParallelContext]:
    """The mesh of the ``parallel:`` block over the running process group,
    with the JAX trainer's checks (``shard_model`` raises when the degree
    does not divide the encoder's dims); ``None`` in one process."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = mesh_from_config(cfg, world, dev.type)
    par = cfg.get("parallel") or {}
    model_par = mesh.shape[1] if mesh is not None else 1
    pp_micro = pipeline_microbatches(cfg)
    seq = bool(par.get("sequence", False))
    if seq:
        if model_par <= 1:
            logger.warning("parallel.sequence=true has no effect with parallel.model=1")
        # recorded in the checkpoint's config, as the JAX trainer does
        cfg["model"]["encoder"]["sequence_parallel"] = True
    if mesh is None:
        return None
    ctx = ParallelContext.from_mesh(mesh, sequence=seq, fsdp=bool(par.get("fsdp", False)),
                                    pipeline=pp_micro)
    if ctx.is_main:
        logger.info("Mesh: {'data': %d, 'model': %d} over %d device(s)%s%s%s", ctx.data,
                    ctx.model, ctx.world, " (fsdp)" if ctx.fsdp else "",
                    " (seq-parallel)" if ctx.sequence else "",
                    f" (pipeline ×{ctx.model}, {pp_micro} microbatches)" if ctx.pipeline else "")
    return ctx


def pipeline_microbatches(cfg: Dict[str, Any]) -> int:
    """``parallel.pipeline_microbatches`` written into the encoder's config
    (so the checkpoint records it, as the JAX trainer does), else the
    encoder's own value."""
    pp = int((cfg.get("parallel") or {}).get("pipeline_microbatches", 0) or 0)
    if pp > 0:
        cfg["model"]["encoder"]["pipeline_microbatches"] = pp
    return int(cfg["model"]["encoder"].get("pipeline_microbatches", 0) or 0)


def _quiet(*args, **kwargs) -> None:
    pass


def workers_per_rank(cfg: Dict[str, Any], local_world: int) -> int:
    """``data.num_workers`` (else ``optim.num_workers``), the host's count,
    split over the ``local_world`` ranks of a node, at least one each when
    it is above 0."""
    n = int(cfg["data"].get("num_workers", cfg["optim"].get("num_workers", 0)) or 0)
    return max(1, n // max(1, local_world)) if n > 0 else 0


def _check_slice(cfg: Dict[str, Any]) -> None:
    """Refuse ``int8_prequant`` training, and ``data.emg_dtype: bfloat16``
    without a bf16 encoder (the JAX trainer's checks)."""
    enc = cfg["model"]["encoder"]
    if enc.get("quantize") == "int8_prequant":
        # int8 trains float: its forward quantizes only when not training
        raise ValueError(
            "model.encoder.quantize: int8_prequant is inference-only; "
            "train with quantize: none (or int8, which trains float)"
        )
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

    Under a launcher (torchrun's ``RANK`` / ``WORLD_SIZE``, or the JAX
    package's variables) the process group is joined first, NCCL for
    ``device="cuda"`` (the rank's card is ``cuda:LOCAL_RANK``) and gloo for
    ``"cpu"``, and left again at the end if this call joined it.
    """
    import torch.distributed as dist

    created = maybe_initialize_distributed(device=device)
    try:
        # the loaders' worker processes stop however _train ends
        with contextlib.ExitStack() as closing:
            return _train(cfg, run_dir, init_checkpoint, dry_run, overfit_batches, writer,
                          resume, device, profile_dir, closing)
    finally:
        if created:
            dist.destroy_process_group()


def _train(cfg, run_dir, init_checkpoint, dry_run, overfit_batches, writer, resume, device,
           profile_dir, closing: contextlib.ExitStack) -> Dict[str, Any]:
    import torch.distributed as dist

    _check_slice(cfg)
    dev = resolve_device(rank_device(device))
    ctx = _parallel_context(cfg, dev)
    split = row_split(ctx, microbatches=pipeline_microbatches(cfg))
    main_rank = ctx is None or ctx.is_main
    info = logger.info if main_rank else _quiet
    if not main_rank:
        writer = profile_dir = None
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
        info("Overfitting on %d batches (~%d items)", overfit_batches, train_limit)

    num_workers = workers_per_rank(cfg, split.local_data * (ctx.model if ctx else 1))
    # overlaps each epoch's checkpoint write with the next epoch; its files
    # land before this call returns or raises
    ckpt_writer = CheckpointWriter(async_saves=bool(cfg["logging"].get("async_checkpoints", False)))
    closing.callback(ckpt_writer.finalize)
    if ckpt_writer.async_saves:
        info("logging.async_checkpoints: checkpoints are written on a background thread "
             "while the next epoch trains")
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
        # a node's shard of every global batch (optim.batch_size is per node)
        num_shards=split.num_shards,
        shard_index=split.shard_index,
        num_workers=num_workers,
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
    closing.callback(train_loader.close)
    closing.callback(val_loader.close)
    info(
        "Train batches: %d | Val batches: %d | batch %d | accum %d | workers %d | device %s",
        len(train_loader), len(val_loader), cfg["optim"]["batch_size"],
        cfg["optim"].get("grad_accum", 1), num_workers, dev,
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

    if init_checkpoint is not None:
        info("Warm start from %s", init_checkpoint)
        payload = load_checkpoint(Path(init_checkpoint))
        model.load_state_dict(load_params_partial(model.state_dict(), payload["state_dict"]))

    payload = None
    if resume and (run_dir / "last").exists():
        payload = load_checkpoint(run_dir / "last")
        if "optimizer" not in payload or "epoch" not in payload:
            raise ValueError(
                f"{run_dir / 'last'} holds weights only (no optimizer state / epoch); "
                "warm start from it with --init-checkpoint instead of --resume"
            )
        model.load_state_dict(payload["state_dict"])
    # the full model, loaded, is placed over the mesh; the optimizer then
    # holds this rank's pieces (checkpoints hold the full tensors)
    shard_model(model, ctx)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    optimizer, schedule = build_optimizer(cfg, params, total_updates, grad_norm_fn(model))
    state = TrainState(model=model, optimizer=optimizer)
    if ctx is not None and ctx.world > 1:
        generator = RngStreams(seed + 1, ctx.data_rank, ctx.model_rank, dev)
    else:
        generator = torch.Generator(dev).manual_seed(seed + 1)

    start_epoch = 1
    if payload is not None:
        scatter = None
        if ctx is not None:
            def scatter(i, t):
                return local_piece(model, names[i], t, params[i])
        optimizer.load_state_dict(payload["optimizer"], scatter=scatter)
        state.step = int(payload["step"])
        start_epoch = int(payload["epoch"]) + 1
        train_loader.epoch = start_epoch - 1  # keep per-epoch shuffles distinct
        info("Resuming %s at epoch %d", run_dir, start_epoch)

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
    train_step = make_train_step(blank_id, normalize_distill, augment, featurize, ctx)
    eval_step = make_eval_step(blank_id, normalize_distill, featurize, ctx)
    flush_step = make_flush_step() if grad_accum > 1 else None

    early = cfg["optim"].get("early_stopping", {}) or {}
    patience = int(early.get("patience", 0))
    min_delta = float(early.get("min_delta", 0.0))

    def checkpoint(epoch: int, is_best: bool, wait: bool = False) -> None:
        if ctx is None:
            ckpt_writer.save(
                run_dir, model.state_dict(), cfg, is_best=is_best, wait=wait,
                optimizer=optimizer.state_dict(), epoch=epoch, step=state.step,
            )
            return
        # every rank gathers (collectives); rank 0 writes
        full = full_state_dict(model)
        opt = optimizer.state_dict(gather=lambda i, t: gather_for(model, names[i], t))
        if ctx.is_main:
            ckpt_writer.save(run_dir, full, cfg, is_best=is_best, wait=wait, optimizer=opt,
                             epoch=epoch, step=state.step)
        dist.barrier()

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
                    schedule, grad_accum, stop_flag=guard, split=split, par=ctx,
                )
            # over a mesh the ranks agree again here: a signal may reach some
            # ranks only, or after the epoch's last agreement, and every rank
            # must take the same branch (both run collectives)
            if guard.requested if ctx is None else _stop_requested_globally(guard, dev):
                # save a resumable `last` labeled with the LAST COMPLETED
                # epoch: --resume re-runs the interrupted one
                checkpoint(epoch - 1, is_best=False, wait=True)
                logger.warning(
                    "Preempted during epoch %d: saved resumable 'last' "
                    "(resume with --resume; the epoch re-runs)", epoch,
                )
                preempted = True
                break
            if flush_step is not None:
                state = flush_partial_accumulation(state, flush_step, grad_accum)
            train_time = time.time() - start
            val_losses = run_eval_epoch(eval_step, state, val_loader, dev, lambdas,
                                        include_teacher, split)
            history.append({"epoch": epoch, "train": train_losses, "val": val_losses})
            info(
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
                info(
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
        help="Build the CUDA kernels and the host library into this directory and "
        "reuse what an earlier run built there (default: $SSD_COMPILE_CACHE, else "
        "ssd_tpu_torch/_build/).",
    )
    p.add_argument(
        "--device", default="cuda", help="cuda (default), cuda:N or cpu; no card raises."
    )
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ssd_tpu_torch.utils.config import load_config, setup_cli_logging

    setup_cli_logging()
    args = _parse_args(argv)
    enable_compile_cache(args.compile_cache)
    import torch.distributed as dist

    cfg = load_config(args.config)
    run_name = cfg["logging"].get("run_name", "run")
    run_dir = args.run_dir or Path("results/checkpoints") / run_name
    # under a launcher, join the group first: only rank 0 writes scalars
    created = maybe_initialize_distributed(device=args.device)
    writer = None
    try:
        if not dist.is_initialized() or dist.get_rank() == 0:
            writer = make_writer(run_dir / "tb")
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
        if writer is not None:
            writer.close()
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
