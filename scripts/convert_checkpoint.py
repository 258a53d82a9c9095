#!/usr/bin/env python3
"""Convert a run's checkpoint between the JAX package's orbax format and the
port's ``model.pt``, optimizer state included.

    python scripts/convert_checkpoint.py --from-jax RUN/last --output OUT
    python scripts/convert_checkpoint.py --from-torch RUN/last --output OUT

``--from-jax`` reads an orbax ``last`` / ``best`` directory
(``ssd_tpu.training.checkpoint.load_checkpoint_np``, no device) and writes
``OUT/last/model.pt`` with ``ssd_tpu_torch.training.checkpoint``: the
weights through ``state_dict_from_flax`` (a scanned or pipelined tree is
unstacked), and the optax state, when the checkpoint has one, as the port's
``Optimizer.state_dict()``, so ``python -m ssd_tpu_torch.training.train
--resume`` continues the JAX run. ``--from-torch`` is the inverse, written
with ``ssd_tpu.training.checkpoint.save_checkpoint`` in the layout the
embedded config asks for (stacked under ``scan_layers`` or
``pipeline_microbatches``), with the optax state of the config's optimizer,
so ``python -m ssd_tpu.evaluation.evaluate`` reads it and
``ssd_tpu.training.train --resume`` continues it. Either way the epoch and
step counters carry over and ``config.json`` is copied unchanged.

It needs both packages (JAX, orbax and torch); it runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ssd_tpu.training import checkpoint as jckpt  # noqa: E402
from ssd_tpu_torch.models import flax_bridge  # noqa: E402
from ssd_tpu_torch.models.ssd_model import build_model  # noqa: E402
from ssd_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from ssd_tpu_torch.training.schedules import build_optimizer  # noqa: E402

logger = logging.getLogger("convert_checkpoint")


def from_jax(ckpt: Path, out_dir: Path) -> None:
    cfg = jckpt.load_config_for(ckpt)
    payload = jckpt.load_checkpoint_np(ckpt)
    params = payload["params"]
    # the input width and the vocabulary, as the weights have them
    conv0 = params["encoder"]["subsample"]["conv_0"]["kernel"]  # (K, in, out)
    model = build_model(cfg, input_dim=np.shape(conv0)[1],
                        vocab_size=np.shape(params["ctc_head"]["fc"]["kernel"])[-1])
    model.load_state_dict(flax_bridge.state_dict_from_flax(
        params, payload.get("batch_stats") or {}, model.encoder_cfg))
    optimizer = None
    if payload.get("opt_state") is not None:
        opt, _ = build_optimizer(cfg, model.parameters(), total_updates=1)
        names = [n for n, _ in model.named_parameters()]
        optimizer = flax_bridge.optimizer_from_optax(
            payload["opt_state"], opt.state_dict(), names, model.encoder_cfg)
        opt.load_state_dict(optimizer)  # shapes and counts checked against the model
    tckpt.save_checkpoint(
        out_dir, model.state_dict(), cfg, optimizer=optimizer,
        epoch=int(payload["epoch"]) if "epoch" in payload else None,
        step=int(payload["step"]) if "step" in payload else None)


def _fill_optax(node: Any, leaves: Mapping[str, Any]) -> Any:
    """``node`` (an optax state made by ``tx.init``) with its Adam, schedule
    and ``MultiSteps`` fields replaced by ``leaves``."""
    import optax

    if isinstance(node, optax.ScaleByAdamState):
        return node._replace(count=np.asarray(leaves["count"], np.int32), mu=leaves["mu"],
                             nu=leaves["nu"])
    if isinstance(node, optax.ScaleByScheduleState):
        return node._replace(count=np.asarray(leaves["update_count"], np.int32))
    if isinstance(node, optax.MultiStepsState):
        return node._replace(
            mini_step=np.asarray(leaves["mini_step"], np.int32),
            gradient_step=np.asarray(leaves["update_count"], np.int32),
            inner_opt_state=_fill_optax(node.inner_opt_state, leaves),
            acc_grads=leaves["acc_grads"])
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        return tuple(_fill_optax(child, leaves) for child in node)
    return node


def from_torch(ckpt: Path, out_dir: Path) -> None:
    from ssd_tpu.training.schedules import build_optimizer as jax_build_optimizer

    cfg = tckpt.load_config_for(ckpt)
    payload = tckpt.load_checkpoint(ckpt)
    sd = payload["state_dict"]
    model = build_model(cfg, input_dim=sd["encoder.subsample.convs.conv_0.weight"].shape[1],
                        vocab_size=sd["ctc_head.fc.weight"].shape[0])
    model.load_state_dict(sd)
    stacked = flax_bridge.stacked_layout(cfg["model"]["encoder"])
    params, batch_stats = flax_bridge.flax_from_state_dict(sd, model.encoder_cfg, stacked)
    out: Dict[str, Any] = {"params": params, "batch_stats": batch_stats}
    if "optimizer" in payload:
        tx, _ = jax_build_optimizer(cfg, total_updates=1)
        names = [n for n, _ in model.named_parameters()]
        leaves = flax_bridge.optax_from_optimizer(payload["optimizer"], names, model.encoder_cfg,
                                                  stacked)
        out["opt_state"] = _fill_optax(tx.init(params), leaves)
    # the dtypes the JAX trainer saves its counters with
    if "epoch" in payload:
        out["epoch"] = np.asarray(payload["epoch"], np.int64)
    if "step" in payload:
        out["step"] = np.asarray(payload["step"], np.int32)
    jckpt.save_checkpoint(out_dir, out, cfg)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s", force=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    source = ap.add_mutually_exclusive_group(required=True)
    source.add_argument("--from-jax", type=Path, help="orbax checkpoint dir (…/last or …/best)")
    source.add_argument("--from-torch", type=Path,
                        help="the port's checkpoint dir (…/last or …/best)")
    ap.add_argument("--output", type=Path, required=True,
                    help="output run dir (gets <output>/last + config.json)")
    args = ap.parse_args(argv)
    src = (args.from_jax or args.from_torch).resolve()
    (from_jax if args.from_jax is not None else from_torch)(src, args.output.resolve())
    logger.info("Converted %s → %s", src, args.output.resolve() / "last")


if __name__ == "__main__":
    main()
