#!/usr/bin/env python3
"""Device time a frame of the plain beam-50 search, for comparing trees of
the port in one call.

    python3 scripts/profile_beam_decode.py [--tree DIR] [--runs 10]

Imports ``ssd_tpu_torch`` from ``--tree`` (default: this checkout), builds
the ``configs/tpu_fast_plus.yaml`` model with seeded random weights (the ×10
CTC head of chip_smoke.py, as ``bench_serving_dispatch.py`` does) and takes
the log-probs of 12 000-sample requests at B = 1 and 8 through
``InferenceEngine.forward``. It then times ``InferenceEngine.decode`` (the
device search and the host traceback) alone on them: the host clock's
median over ``--runs`` decodes, and ``torch.profiler``'s device time and
device events over one decode, each per frame, with the ops that take the
most device time. Prints one JSON line with the card's name and power
limit. Run parent, change, change, parent in one call.
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
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--top", type=int, default=6)
    args = p.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import ssd_tpu_torch
    from ssd_tpu_torch.data.vocab import default_vocab
    from ssd_tpu_torch.models.conformer import init_flax_style
    from ssd_tpu_torch.models.ssd_model import build_model
    from ssd_tpu_torch.serving.engine import InferenceEngine
    from ssd_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("profile_beam_decode: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shipped = load_config(REPO / "configs" / "tpu_fast_plus.yaml")
    cfg = {"features": shipped["features"], "model": json.loads(json.dumps(shipped["model"]))}
    model = build_model(cfg, input_dim=cfg["model"]["encoder"]["input_dim"], vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.ctc_head.fc.weight.mul_(10.0)
    engine = InferenceEngine(cfg, model.state_dict(), default_vocab(), decoder="beam", device="cuda")
    rng = np.random.default_rng(0)
    out = {"package": str(Path(ssd_tpu_torch.__file__).parent), "runs": args.runs}
    for B in (1, 8):
        reqs = [rng.normal(size=(12000, 8)).astype(np.float32) for _ in range(B)]
        lp, ol = engine.forward(reqs)
        frames = lp.shape[1]

        def decode():
            texts = engine.decode(lp, ol)
            torch.cuda.synchronize()
            return texts

        texts = decode()
        host = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            decode()
            host.append((time.perf_counter() - t0) * 1e3)
        for _ in range(2):  # the first profiled run pays the tracer's start-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                decode()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]
        out[f"b{B}"] = {
            "frames": frames,
            "host_ms_per_frame": float(np.median(host)) / frames,
            "device_ms_per_frame": dev_ms / frames,
            "device_events_per_frame": sum(e.count for e in events) / frames,
            "top_us_per_frame": {e.key[:70]: e.self_device_time_total / frames for e in top},
            "text0": texts[0],
        }
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
