"""The port's checkpoint format.

Orbax needs JAX to read, so the port keeps its own format beside the same
embedded-config contract as ``ssd_tpu/training/checkpoint.py``:

    <run_dir>/last/model.pt    torch.save({"format", "state_dict",
                               ["optimizer", "epoch", "step"]})
    <run_dir>/best/model.pt    (when is_best)
    <run_dir>/config.json      the run's config; eval and serving rebuild
                               the model from it

``state_dict`` holds every parameter and the MaskedBatchNorm running
statistics (buffers ``…bn.mean`` / ``…bn.var``, the JAX ``batch_stats``).
A trainer's save adds the optimizer state (AdamW moments, the update count
and the open accumulation window), the epoch and the micro-step count, which
``--resume`` restores; a weights-only checkpoint still loads. Converting an
orbax directory needs JAX and is a separate tool (ROADMAP.md queue 1 item 12).

``load_params_partial`` reproduces ``load_state_dict(strict=False)`` for warm
starts: intersecting, shape-matching tensors are copied, everything else
keeps its fresh initialization.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

logger = logging.getLogger(__name__)

FORMAT = "ssd_tpu_torch/1"
MODEL_FILE = "model.pt"


def save_checkpoint(
    run_dir: Path,
    state_dict: Dict[str, torch.Tensor],
    cfg: Dict[str, Any],
    is_best: bool = False,
    optimizer: Optional[Dict[str, Any]] = None,
    epoch: Optional[int] = None,
    step: Optional[int] = None,
) -> None:
    """Write ``last`` (and optionally ``best``) + ``config.json``."""
    run_dir = Path(run_dir).resolve()
    payload: Dict[str, Any] = {
        "format": FORMAT,
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
    }
    if optimizer is not None:
        payload["optimizer"] = optimizer
    if epoch is not None:
        payload["epoch"] = int(epoch)
    if step is not None:
        payload["step"] = int(step)
    for name in ("last", "best") if is_best else ("last",):
        (run_dir / name).mkdir(parents=True, exist_ok=True)
        tmp = run_dir / name / f"{MODEL_FILE}.tmp"
        torch.save(payload, tmp)
        tmp.replace(run_dir / name / MODEL_FILE)
    (run_dir / "config.json").write_text(json.dumps(cfg, indent=2))


def load_checkpoint(path: Path) -> Dict[str, Any]:
    """Read a checkpoint directory (``…/last`` or ``…/best``) onto the CPU."""
    f = Path(path).resolve() / MODEL_FILE
    if not f.exists():
        raise FileNotFoundError(f)
    payload = torch.load(f, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{f}: not an {FORMAT} checkpoint (format={payload.get('format')!r})")
    return payload


def load_config_for(path: Path) -> Dict[str, Any]:
    """Config stored next to a checkpoint dir (embedded-config contract)."""
    cfg_path = Path(path).resolve().parent / "config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(cfg_path)
    return json.loads(cfg_path.read_text())


def load_params_partial(
    fresh: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Copy intersecting, shape-matching tensors of ``loaded`` onto ``fresh``."""
    copied = skipped = 0
    merged: Dict[str, torch.Tensor] = {}
    for name, tensor in fresh.items():
        other = loaded.get(name)
        if other is not None and tuple(other.shape) == tuple(tensor.shape):
            merged[name] = other
            copied += 1
        else:
            merged[name] = tensor
            if other is not None:
                skipped += 1
    logger.info("Warm start: copied %d tensors, kept %d fresh", copied, skipped)
    return merged
