#!/usr/bin/env python3
"""Greedy serving p50 of the full-width engine on the card, for comparing
two trees of the port in one call.

    python3 scripts/bench_serving_dispatch.py [--tree DIR] [--runs 30]

Imports ``ssd_tpu_torch`` from ``--tree`` (default: this checkout), builds
the ``configs/tpu_fast_plus.yaml`` model with seeded random weights (the
×10 CTC head of chip_smoke.py) in both configurations (the defaults, and
``attention_impl: fused`` + ``depthwise_impl: pallas``), and times
``InferenceEngine.transcribe`` with greedy decoding at B = 1 and 8 on
12 000-sample requests: the p50 of ``--runs`` calls an utterance, host
clock, end to end. It prints one JSON line with the card's name and power
limit. Run parent, change, change, parent in one call: the host clock moves
2× between calls, so only times from one call compare.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", type=Path, default=REPO, help="the checkout whose ssd_tpu_torch to time")
    p.add_argument("--runs", type=int, default=30)
    args = p.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import torch

    from ssd_tpu_torch.data.vocab import default_vocab
    from ssd_tpu_torch.models.conformer import init_flax_style
    from ssd_tpu_torch.models.ssd_model import build_model
    from ssd_tpu_torch.serving.engine import InferenceEngine
    from ssd_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("bench_serving_dispatch: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shipped = load_config(REPO / "configs" / "tpu_fast_plus.yaml")
    rng = np.random.default_rng(0)
    requests = {B: [rng.normal(size=(12000, 8)).astype(np.float32) for _ in range(B)]
                for B in (1, 8)}
    import ssd_tpu_torch

    out = {"package": str(Path(ssd_tpu_torch.__file__).parent), "runs": args.runs}
    for name, enc in (("default", {}), ("fused", {"attention_impl": "fused",
                                                  "depthwise_impl": "pallas"})):
        cfg = {"features": shipped["features"], "model": json.loads(json.dumps(shipped["model"]))}
        cfg["model"]["encoder"].update(enc)
        model = build_model(cfg, input_dim=cfg["model"]["encoder"]["input_dim"], vocab_size=48)
        init_flax_style(model, torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.ctc_head.fc.weight.mul_(10.0)
        engine = InferenceEngine(cfg, model.state_dict(), default_vocab(), device="cuda")
        for B, reqs in requests.items():
            for _ in range(3):
                engine.transcribe(reqs)  # warm: the kernels' build, the allocator
            per_utt = []
            for _ in range(args.runs):
                t0 = time.perf_counter()
                engine.transcribe(reqs)
                per_utt.append((time.perf_counter() - t0) / B * 1e3)
            out[f"{name}_greedy_b{B}_p50_ms"] = float(np.percentile(per_utt, 50))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
