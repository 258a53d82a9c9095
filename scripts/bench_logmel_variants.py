#!/usr/bin/env python3
"""Time variants of the CUDA log-mel kernel against the committed one.

    python3 scripts/bench_logmel_variants.py [--rounds 3]

A variant sets the FFT kernel's knobs: frames a CTA (the wrapper's
``FRAMES_PER_CTA``, patched; no rebuild), radix-4 or radix-2 passes (the
host's plan, ``FFT_RADICES`` patched) and threads a CTA (``kThreads`` in
``ssd_tpu_torch/csrc/logmel.cu``, a text substitution written to
``ssd_tpu_torch/_build/variants/`` and built with the package's own nvcc
flags; all sources build at once). Every variant
is held to the plain PyTorch version (normalised features within atol =
rtol = 1e-4, as chip_smoke.py) and timed with CUDA events (mean of 100 warm
launches queued behind a device spin) at B = 1 and B = 8, 8 channels, the
12 800-sample bucket; rounds alternate the order. Prints ptxas's register /
spill report per source. Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ssd_tpu_torch.ops import featurizer as feat  # noqa: E402
from ssd_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR  # noqa: E402

_THREADS = "constexpr int kThreads = 256;"
SOURCES = {"committed": [], "threads128": [(_THREADS, "constexpr int kThreads = 128;")]}
FRAMES, RADICES = feat.FRAMES_PER_CTA, feat.FFT_RADICES
RADIX2 = tuple(r for r in RADICES if r != 4)
# name: (source, frames a CTA, the plan's radices)
VARIANTS = {
    "committed": ("committed", FRAMES, RADICES),
    "frames8": ("committed", 8, RADICES),
    "frames32": ("committed", 32, RADICES),
    "frames64": ("committed", 64, RADICES),
    "radix2": ("committed", FRAMES, RADIX2),
    "threads128": ("threads128", FRAMES, RADICES),
    "threads128_frames32": ("threads128", 32, RADICES),
    "threads128_frames8": ("threads128", 8, RADICES),
}
TOL = dict(atol=1e-4, rtol=1e-4)


def library(name: str, subs):
    lib = copy.copy(feat.LOGMEL.library)
    if subs:
        src = (CSRC_DIR / "logmel.cu").read_text()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in logmel.cu")
            src = src.replace(old, new)
        path = BUILD_DIR / "variants" / f"logmel_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        lib.name, lib.source = f"ssd_logmel_{name}", path
    lib._lib, lib._lock = None, threading.Lock()
    return lib


@contextlib.contextmanager
def knobs(frames: int, radices: tuple):
    """The wrapper's frames a CTA and the plan's radices, set for a block."""
    try:
        feat.FRAMES_PER_CTA, feat.FFT_RADICES = frames, radices
        yield
    finally:
        feat.FRAMES_PER_CTA, feat.FFT_RADICES = FRAMES, RADICES


def cuda_ms(fn, iters: int = 100) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    s.record()
    for _ in range(iters):
        fn()
    if s.query():
        raise SystemExit("the device spin ran out before the launches were queued")
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
    libs = {name: library(name, subs) for name, subs in SOURCES.items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    for name, lib in libs.items():
        report = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(report) or 'reused the built library'}")
    kernels = {}
    for name, (src, *_) in VARIANTS.items():
        kernels[name] = feat.LogmelKernel()  # its own constants: the plan of its radices
        kernels[name].library = libs[src]
    cfg = feat.FeaturizerConfig()
    rng = np.random.default_rng(0)
    xs, lens, ref = {}, {}, {}
    for B in (1, 8):
        lengths = rng.integers(4000, 12001, size=B)
        x = np.zeros((B, 12800, 8), np.float32)
        for i, n in enumerate(lengths):
            x[i, :n] = rng.normal(size=(n, 8))
        xs[B], lens[B] = torch.from_numpy(x).cuda(), torch.from_numpy(lengths).cuda()
        ref[B] = feat.normalize_logmels(feat.logmel_core_plain(xs[B], cfg), lens[B], cfg)[0]
    times = {(n, B): [] for n in kernels for B in xs}
    for r in range(args.rounds):
        for name in (list(kernels) if r % 2 == 0 else list(kernels)[::-1]):
            for B, x in xs.items():
                with knobs(*VARIANTS[name][1:]):
                    got = feat.normalize_logmels(kernels[name](x, cfg), lens[B], cfg)[0]
                    if not torch.allclose(got, ref[B], **TOL):
                        raise SystemExit(f"{name} B={B}: max abs err {float((got - ref[B]).abs().max())}")
                    times[name, B].append(cuda_ms(lambda: kernels[name](x, cfg)))
    for (name, B), t in times.items():
        print(f"{name:20s} B={B}: median {np.median(t):.4f} ms over {len(t)} rounds "
              f"({', '.join(f'{v:.4f}' for v in t)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
