#!/usr/bin/env python3
"""Time variants of the CUDA log-mel kernel against the committed one.

    python3 scripts/bench_logmel_variants.py [--rounds 3]

Each variant is the committed ``ssd_tpu_torch/csrc/logmel.cu`` with a few
text substitutions (launch bounds, unrolling), written to
``ssd_tpu_torch/_build/variants/`` and built with the package's own nvcc
flags. Every variant is checked against the plain PyTorch version and timed
with CUDA events (mean of 100 warm launches) at B = 1 and B = 8, 8
channels, the 12 800-sample bucket; rounds alternate the order. Prints
ptxas's register / spill report per variant. Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ssd_tpu_torch.ops import featurizer as feat  # noqa: E402
from ssd_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR  # noqa: E402

_BOUNDS = "__launch_bounds__(kThreads, 2)"
_UNROLL = "#pragma unroll 1  // unrolling the n-loop"
VARIANTS = {
    "committed": [],
    "unroll2": [(_UNROLL, "#pragma unroll 2  // unrolling the n-loop")],
    "nocap": [(_BOUNDS, "__launch_bounds__(kThreads, 1)")],
    "nocap_unroll4": [(_BOUNDS, "__launch_bounds__(kThreads, 1)"),
                      (_UNROLL, "#pragma unroll 4  // unrolling the n-loop")],
}


def build(name: str, subs) -> feat.LogmelKernel:
    src = (CSRC_DIR / "logmel.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in logmel.cu")
        src = src.replace(old, new)
    path = BUILD_DIR / "variants" / f"{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    k = feat.LogmelKernel()
    k.library.name = f"logmel_{name}"
    k.library.source = path
    k.library.load()
    report = [ln.strip() for ln in k.library.build_log.splitlines()
              if "registers" in ln or "spill" in ln]
    print(f"{name}: {' | '.join(report)}")
    return k


def cuda_ms(fn, iters: int = 100) -> float:
    for _ in range(10):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_logmel_variants: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = feat.FeaturizerConfig()
    rng = np.random.default_rng(0)
    xs = {B: torch.from_numpy(rng.normal(size=(B, 12800, 8)).astype(np.float32)).cuda()
          for B in (1, 8)}
    ref = {B: feat.logmel_core_plain(x, cfg) for B, x in xs.items()}
    kernels = {name: build(name, subs) for name, subs in VARIANTS.items()}
    times = {(n, B): [] for n in kernels for B in xs}
    for r in range(args.rounds):
        for name in (list(kernels) if r % 2 == 0 else list(kernels)[::-1]):
            for B, x in xs.items():
                err = float((kernels[name](x, cfg) - ref[B]).abs().max())
                if err > 1e-3:
                    raise SystemExit(f"{name} B={B}: max abs dB error {err} vs plain")
                times[name, B].append(cuda_ms(lambda: kernels[name](x, cfg)))
    for (name, B), t in times.items():
        print(f"{name:14s} B={B}: median {np.median(t):.4f} ms over {len(t)} rounds "
              f"({', '.join(f'{v:.4f}' for v in t)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
