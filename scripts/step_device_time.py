#!/usr/bin/env python3
"""Device time of tpu_scaled_large's bf16 train step on the card, for
comparing two trees of the port in one call.

    python3 scripts/step_device_time.py [--tree DIR] [--shipped] [--profiles 5]

Imports ``chip_smoke`` and ``ssd_tpu_torch`` from ``--tree`` (default: this
checkout) and takes the trainer's step as chip_smoke's phase 15d does: the
full-width, full-depth ``configs/tpu_scaled_large.yaml`` model with seeded
random weights, bf16, remat ``full``, a raw-EMG batch of B = 32 in one
768-frame bucket (T' 384), forward and loss, backward, AdamW; the
``attention_impl: fused`` + ``depthwise_impl: pallas`` configuration unless
``--shipped``. It prints the host p50 of 10 warm steps (a sync after each)
and, for ``--profiles`` profiled steps, the device time of a step (the sum
of ``torch.profiler``'s device events, phase 15d's "device busy") with the
depthwise kernels' share, their median, and one JSON line with the card's
name and power limit. Run each tree in its own process, parent, change,
change, parent, in one call: the host clock moves between calls, and the
device time is what two trees compare by.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1],
                   help="the checkout to import chip_smoke and ssd_tpu_torch from")
    p.add_argument("--shipped", action="store_true",
                   help="the configuration as shipped (composite attention, cuDNN conv)")
    p.add_argument("--profiles", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("step_device_time: no CUDA device visible", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs

    card = cs.card_line()
    rng = np.random.default_rng(cs.SEED)
    model = cs.large_model(**({} if args.shipped else cs.FUSED)).cuda()
    opt, _ = cs.build_optimizer(cs.large_config(), model.parameters(), 1000)
    featurize = cs.feat.FeaturizerConfig.from_config(cs.large_config())
    batch = cs.trainer.to_device(cs.large_batch(rng, cs.LARGE_TRAIN_SHAPE[0]), torch.device("cuda"))
    gen = torch.Generator("cuda").manual_seed(cs.SEED + 1)

    def step():
        opt.zero_grad()
        total, _ = cs.trainer._losses(model, batch, cs.LAMBDAS, cs.BLANK, False, True, gen, None,
                                      featurize)
        total.backward()
        opt.step()

    for _ in range(3):
        step()
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    device, depthwise = [], []
    for _ in range(args.profiles):
        events = cs.device_events(step)
        device.append(sum(e.self_device_time_total for e in events) / 1e3)
        depthwise.append(sum(e.self_device_time_total for e in events if "dw_" in e.key) / 1e3)
    name = "shipped" if args.shipped else "fused"
    print(f"[step] {tree.name} {name} bf16 remat B={cs.LARGE_TRAIN_SHAPE[0]} T'="
          f"{cs.LARGE_TRAIN_SHAPE[1]}: device ms a step "
          f"{', '.join(f'{v:.3f}' for v in device)} (depthwise kernels "
          f"{', '.join(f'{v:.3f}' for v in depthwise)}); host p50 {np.median(host):.3f} ms; {card}")
    print(json.dumps({"tree": str(tree), "config": name, "device_ms_median": float(np.median(device)),
                      "depthwise_ms_median": float(np.median(depthwise)),
                      "host_p50_ms": float(np.median(host)), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
