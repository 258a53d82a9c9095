#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on one CUDA card.

    python3 scripts/profile_torch_serving.py [--batch 1 8] [--iters 5]

Builds the full-width ``tpu_fast_plus`` model with chip_smoke.py's seeded
random weights and, for each batch size and for greedy and beam-50
decoding, times ``InferenceEngine.transcribe`` stage by stage on requests
of 12 000 samples (the 12 800-sample bucket):

* host clock per stage, each stage ending in ``torch.cuda.synchronize()``:
  pad + upload, featurize (the CUDA log-mel kernel + clip/z-norm), encoder
  + CTC head, decode (device search + host traceback);
* ``torch.profiler`` over one whole ``transcribe`` (after one discarded
  profiled run that starts the tracer): device time by kernel, and the
  device's busy share of the unprofiled wall time — the profiler's own
  per-launch cost would otherwise inflate the wall time of a launch-bound
  loop several-fold.

Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the model and config the smoke run uses)
from ssd_tpu_torch.ops.featurizer import logmel_batch  # noqa: E402
from ssd_tpu_torch.serving.engine import InferenceEngine  # noqa: E402


def stage_times(eng: InferenceEngine, reqs) -> dict:
    sync = torch.cuda.synchronize
    out = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        batch, lens = eng._pad(reqs)
        emg = torch.from_numpy(batch).to(eng.device)
        lens = torch.from_numpy(lens).to(eng.device)
        sync()
        t1 = time.perf_counter()
        feats, flen, _, _ = logmel_batch(emg, lens, eng.feat_cfg)
        sync()
        t2 = time.perf_counter()
        B, T, C, M = feats.shape
        lp, ol = eng.model.ctc_log_probs(feats.reshape(B, T, C * M), flen)
        sync()
        t3 = time.perf_counter()
        eng.decode(lp, ol)
        sync()
        t4 = time.perf_counter()
    out["upload"], out["featurize"], out["encoder"], out["decode"] = (
        (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3)
    return out


def profile_once(eng: InferenceEngine, reqs, wall_ms: float, top: int = 12) -> None:
    """Device time by kernel over one ``transcribe``; busy share against
    ``wall_ms``, the unprofiled time of the same call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first profiled run pays the tracer's start-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.transcribe(reqs)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"    profiler: device busy {dev_us / 1e3:.3f} ms = {100 * dev_us / 1e3 / wall_ms:.1f}% "
          f"of the unprofiled {wall_ms:.3f} ms; {launches} device events (kernels + copies)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"      {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device visible", file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)
    run_dir = Path(tempfile.mkdtemp(prefix="ssd_profile_"))
    try:
        ckpt = chip_smoke.build_run_dir(run_dir)
        for decoder in ("greedy", "beam"):
            eng = InferenceEngine.from_checkpoint(ckpt, decoder=decoder, device="cuda")
            for B in args.batch:
                reqs = [rng.normal(size=(12000, chip_smoke.CHANNELS)).astype(np.float32)
                        for _ in range(B)]
                eng.transcribe(reqs)  # warm
                runs = [stage_times(eng, reqs) for _ in range(args.iters)]
                med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
                total = sum(med.values())
                print(f"{decoder} B={B}: median of {args.iters} — total {total:.3f} ms "
                      f"({total / B:.3f} ms/utterance): "
                      + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()))
                profile_once(eng, reqs, total)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
