"""Average N checkpoints into one (uniform parameter averaging of the
last / best checkpoints; the port's copy of
``ssd_tpu/training/average_checkpoints.py`` over its ``model.pt``).

Usage:
  python -m ssd_tpu_torch.training.average_checkpoints \
      --checkpoints run/last run/best \
      --output results/checkpoints/run_avg

All inputs must share one state_dict (same config). Every tensor — the
parameters and the ``MaskedBatchNorm`` ``mean`` / ``var`` buffers, which
the JAX package keeps as ``batch_stats`` — is summed in float64 in
checkpoint order, divided by N and cast back to its dtype, as the JAX tool
does leaf by leaf; epoch / step take the max; the embedded config comes
from the first checkpoint; the optimizer state is dropped (averaged
checkpoints are for evaluation, serving and warm starts — not
``--resume``). Writes ``<output>/last/model.pt`` and ``<output>/config.json``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, List, Mapping

import torch

from ssd_tpu_torch.training.checkpoint import load_checkpoint, load_config_for, save_checkpoint

logger = logging.getLogger(__name__)


def average_state_dicts(state_dicts: List[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Uniform average of state_dicts with the same keys and shapes; a
    shape or key mismatch and a non-float tensor (an ``int8_prequant``
    checkpoint's int8 weights) raise ``ValueError``."""
    if not state_dicts:
        raise ValueError("need at least one checkpoint")
    first = state_dicts[0]
    for sd in state_dicts[1:]:
        if set(sd) != set(first):
            raise ValueError(
                f"checkpoint topology mismatch: keys {sorted(set(sd) ^ set(first))} "
                "are not in every checkpoint"
            )
    out = {}
    for name, leaf in first.items():
        acc = torch.zeros(leaf.shape, dtype=torch.float64)
        for sd in state_dicts:
            t = sd[name]
            if t.shape != acc.shape:
                raise ValueError(
                    f"checkpoint topology mismatch: {name} {tuple(t.shape)} vs {tuple(acc.shape)}"
                )
            acc += t.to(torch.float64)
        mean = acc / len(state_dicts)
        if not leaf.is_floating_point():
            raise ValueError(
                f"non-float tensor {name} ({leaf.dtype}) in checkpoint — averaging only "
                "supports float checkpoints (not int8_prequant conversions)"
            )
        out[name] = mean.to(leaf.dtype)
    return out


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s",
                        force=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoints", nargs="+", required=True,
                    help="checkpoint dirs (…/last, …/best)")
    ap.add_argument("--output", required=True,
                    help="output run dir (gets <output>/last + config.json)")
    args = ap.parse_args(argv)

    paths = [Path(p).resolve() for p in args.checkpoints]
    cfg = load_config_for(paths[0])
    payloads = [load_checkpoint(p) for p in paths]
    counters = {
        key: max(vals)
        for key in ("epoch", "step")
        if (vals := [int(p[key]) for p in payloads if key in p])
    }
    state_dict = average_state_dicts([p["state_dict"] for p in payloads])

    out_dir = Path(args.output).resolve()
    save_checkpoint(out_dir, state_dict, cfg, **counters)
    logger.info(
        "Averaged %d checkpoints → %s (optimizer state dropped)",
        len(paths), out_dir / "last",
    )


if __name__ == "__main__":
    main()
