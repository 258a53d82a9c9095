"""Convert a checkpoint between the unrolled and the scanned
(``model.encoder.scan_layers: true``) encoder layouts (the port's copy of
``ssd_tpu/training/convert_layout.py`` over its ``model.pt``).

The port keeps one parameter layout (``encoder.blocks.<i>``) whatever the
config says, so only the embedded config changes; but the layout is not
math-neutral: ``scan_layers`` feeds ``block_0`` an fp32 carry, which moves
a bf16 model's outputs, and a pipelined model (``pipeline_microbatches >
0``) cannot also scan. The source layout is read as the JAX tool reads it:
stacked when the config scans or pipelines (the JAX ``blocks/block`` tree).
Converting a pipelined checkpoint to scan only flips the flags; either way
``pipeline_microbatches`` goes from the output's config. The converted
checkpoint carries the weights, the batch statistics and the epoch / step
counters; the optimizer state is dropped, as the JAX tool drops it
(converted checkpoints are for evaluation, serving and ``--init-checkpoint``
warm starts, not ``--resume``). Loading and saving need no device.

Usage:
  python -m ssd_tpu_torch.training.convert_layout \
      --checkpoint results/checkpoints/run/best --to scan \
      --output results/checkpoints/run_scan
"""

from __future__ import annotations

import argparse
import copy
import logging
from pathlib import Path
from typing import Any, Dict, Tuple

from ssd_tpu_torch.models.flax_bridge import stacked_layout
from ssd_tpu_torch.training.checkpoint import load_checkpoint, load_config_for, save_checkpoint

logger = logging.getLogger(__name__)


def convert_payload(payload: Dict[str, Any], cfg: Dict[str, Any],
                    to: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Return (converted payload, updated cfg). ``to`` ∈ {scan, unrolled}."""
    enc = cfg["model"]["encoder"]
    was_stacked = stacked_layout(enc)
    was_pipelined = int(enc.get("pipeline_microbatches", 0) or 0) > 0
    if (to == "scan") == was_stacked and not (to == "scan" and was_pipelined):
        raise ValueError(
            f"checkpoint is already in the "
            f"{'stacked (scan/pipeline)' if was_stacked else 'unrolled'} layout"
        )
    out = {"state_dict": payload["state_dict"]}
    for key in ("epoch", "step"):
        if key in payload:
            out[key] = payload[key]
    new_cfg = copy.deepcopy(cfg)
    new_cfg["model"]["encoder"]["scan_layers"] = to == "scan"
    # the output layout is exactly scan-or-unrolled; a pipelined source's
    # flag would otherwise conflict with scan_layers at load time
    new_cfg["model"]["encoder"].pop("pipeline_microbatches", None)
    return out, new_cfg


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s",
                        force=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (…/last or …/best)")
    ap.add_argument("--to", required=True, choices=("scan", "unrolled"))
    ap.add_argument("--output", required=True,
                    help="output run dir (gets <output>/last + config.json)")
    args = ap.parse_args(argv)

    ckpt = Path(args.checkpoint).resolve()
    cfg = load_config_for(ckpt)
    out_payload, out_cfg = convert_payload(load_checkpoint(ckpt), cfg, args.to)

    out_dir = Path(args.output).resolve()
    save_checkpoint(out_dir, out_payload["state_dict"], out_cfg,
                    epoch=out_payload.get("epoch"), step=out_payload.get("step"))
    logger.info(
        "Converted %s → %s (%s layout); optimizer state dropped "
        "(eval/serve/warm-start only)", ckpt, out_dir / "last", args.to,
    )


if __name__ == "__main__":
    main()
