#!/usr/bin/env python3
"""How often the card's CTC beam search and the CPU's disagree on the same
log-probs.

    python3 scripts/beam_card_vs_cpu.py [--seeds 12] [--reps 3]

Both run ``ssd_tpu_torch.decoding.ctc.build_decoder("beam", beam_width=50)``
(the eval CLI's beam-50, exact token sort) on identical float32 log-probs,
B = 2, T' 640 / 560, V = 48, made from seeded normal logits at three
spreads: flat ones, like a barely trained model's, and decisive ones, the
logits ×10 (as chip_smoke's serving checkpoints scale their CTC head). For
each input it prints whether the card's text equals the CPU's and whether
the card gives the same text on every repetition. Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ssd_tpu_torch.data.vocab import default_vocab  # noqa: E402
from ssd_tpu_torch.decoding.ctc import build_decoder  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("beam_card_vs_cpu: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    decode = build_decoder("beam", default_vocab(), beam_width=50)
    lengths = torch.tensor([640, 560])
    totals = {}
    for seed in range(args.seeds):
        rng = np.random.default_rng(seed)
        spread = (0.7, 1.0, 1.5)[seed % 3]
        logits = rng.normal(size=(2, 640, 48)).astype(np.float32) * spread
        logits[:, :, 1] += 1.0  # blank-heavy, as a CTC head is
        for kind, scale in (("flat", 1.0), ("decisive", 10.0)):
            lp = torch.log_softmax(torch.from_numpy(logits * scale), -1)
            want = decode(lp, lengths)
            outs = {tuple(decode(lp.cuda(), lengths.cuda())) for _ in range(args.reps)}
            equal = outs == {tuple(want)}
            t = totals.setdefault(kind, [0, 0, 0])
            t[0] += 1
            t[1] += equal
            t[2] += len(outs) == 1
            print(f"seed {seed} spread {spread} {kind:8s}: card text equal to the CPU's: {equal}; "
                  f"the card's {args.reps} repetitions agree: {len(outs) == 1}")
    for kind, (n, equal, same) in totals.items():
        print(f"{kind}: {equal} of {n} inputs decode to the CPU's text on the card; the card "
              f"repeats itself on {same} of {n}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
