#!/usr/bin/env python3
"""Time the CUDA CTC α kernel at each CTA width (warps a batch row).

    python3 scripts/bench_ctc_variants.py [--rounds 3]

A width is ``ssd_tpu_torch/csrc/ctc.cu`` with the warps a row that
``alpha_shape`` picks replaced by a fixed count (1 warp: shuffles only, no
barrier; more: the shared-memory handoff at warp boundaries, and
⌈S2/(32·warps)⌉ states a thread), a text substitution written to
``ssd_tpu_torch/_build/variants/`` and built with the package's own nvcc
flags, all sources at once; "committed" is the source as it stands
(⌈S2/32⌉ warps, one state a thread). Each is held bit-equal to the plain
recursion on the card and timed with CUDA events (mean of 50 warm launches
queued behind a device spin) at the main path's shapes — B = 5, T' = 640,
S = 160 (S2 = 321) and B = 32, T' = 384, S = 128 (S2 = 257) — beside the
β kernel; rounds alternate the order. Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ssd_tpu_torch.ops import ctc_loss as ctc  # noqa: E402
from ssd_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR  # noqa: E402

_WARPS = "const int warps = min((S2 + 31) / 32, kMaxAlphaWarps);"
WARPS = (1, 2, 4, 8, 16)
SHAPES = {"config": (5, 640, 160), "flagship": (32, 384, 128)}


def cuda_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(80_000_000)
    s.record()
    for _ in range(iters):
        fn()
    if s.query():
        raise SystemExit("the device spin ran out before the launches were queued")
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def library(warps):
    """The CTC library built from ctc.cu as it stands (``warps`` None) or
    with ``warps`` warps a row."""
    lib = copy.copy(ctc.CTC_ALPHA.library)
    if warps is not None:
        src = (CSRC_DIR / "ctc.cu").read_text()
        if _WARPS not in src:
            raise SystemExit(f"{_WARPS!r} not in ctc.cu")
        path = BUILD_DIR / "variants" / f"ctc_w{warps}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src.replace(_WARPS, f"const int warps = {warps};"))
        lib.name, lib.source = f"ssd_ctc_w{warps}", path
    lib._lib, lib._lock = None, threading.Lock()
    return lib


def case(B: int, T: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(B, T, 48)).astype(np.float32) * 3), -1)
    tg = torch.from_numpy(rng.integers(3, 48, size=(B, S)).astype(np.int32))
    ext, skip = ctc._topology(tg, 1)
    lp_ext = ctc._emissions(lp, ext).cuda()
    tl = torch.from_numpy(rng.integers(S // 2, S + 1, size=B).astype(np.int32))
    ll = torch.full((B,), T, dtype=torch.int32)
    bfinal = ctc._final_states(tl, ext.shape[1]).cuda()
    skip_from = torch.nn.functional.pad(skip[:, 2:], (0, 2), value=False).float().cuda()
    return lp_ext, skip.cuda(), bfinal, skip_from, ll.cuda()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_ctc_variants: no CUDA device visible", file=sys.stderr)
        return 2
    libs = {"alpha_committed": library(None), **{f"alpha_w{w}": library(w) for w in WARPS}}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    kernels = {}
    for name, lib in libs.items():
        kernels[name] = ctc.CTCAlphaKernel()
        kernels[name].library = lib
    cases = {label: case(*shape, seed=i) for i, (label, shape) in enumerate(SHAPES.items())}
    for label, (lp_ext, skip, *_) in cases.items():
        want = ctc.forward_alphas_plain(lp_ext, skip)
        for name, k in kernels.items():
            if not torch.equal(k(lp_ext, skip.float()), want):
                raise SystemExit(f"{name} at {label}: not bit-equal to the plain recursion")
    print(f"every width bit-equal to the plain recursion at {list(SHAPES)}")
    times = {(n, label): [] for n in [*kernels, "beta"] for label in cases}
    for r in range(args.rounds):
        for name in (list(kernels) if r % 2 == 0 else list(kernels)[::-1]):
            for label, (lp_ext, skip, *_) in cases.items():
                skipf = skip.float()
                times[name, label].append(cuda_ms(lambda: kernels[name](lp_ext, skipf)))
        for label, (lp_ext, _, bfinal, skip_from, ll) in cases.items():
            times["beta", label].append(cuda_ms(lambda: ctc.CTC_BETA(lp_ext, skip_from, bfinal, ll)))
    for (name, label), t in times.items():
        T = SHAPES[label][1]
        print(f"{name:10s} {label:8s} B={SHAPES[label][0]} T'={T}: median {np.median(t):.4f} ms "
              f"({np.median(t) * 1e3 / T:.3f} µs a step) over {len(t)} rounds "
              f"({', '.join(f'{v:.4f}' for v in t)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
