#!/usr/bin/env python3
"""Time the CUDA depthwise backward kernel's variants, and the op's whole
backward.

    python3 scripts/bench_depthwise_variants.py [--rounds 3]
    python3 scripts/bench_depthwise_variants.py --op-only --tree DIR

A variant is ``ssd_tpu_torch/csrc/depthwise_conv.cu`` with one constant
replaced by text substitution — strips of 1, 2 or 3 tiles, or one strip of
the whole T, in place of the cost model's choice (``kStripTiles``), 64
channels a CTA (``kBwdCh``), a three-stage ring (``kStages``), and the
K ≤ 15 instance built for three CTAs an SM (``kBwdMinBlocks``, at most 80
registers) — written to ``ssd_tpu_torch/_build/variants/`` and
built with the package's own nvcc flags, all sources at once. Each is held
to the plain version on the card (dx within 1e-5; dw and db within 1e-4 of
their largest magnitude) and timed with CUDA events (mean of 50 warm
launches queued behind a device spin) at the training path's shapes:
B = 5, T' = 640 and B = 32, T' = 384, C 288, K 15. Rounds alternate the
order.

It also times the op's whole backward — ``torch.autograd.grad`` through
``depthwise_conv1d``: the kernel and whatever the op does around it — of
the package it imports. ``--tree DIR`` imports ``ssd_tpu_torch`` from
another checkout (say the parent commit, unpacked with ``git archive``), and
``--op-only`` times only that, so two trees are compared in one call.
Needs a card.
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

SHAPES = {"config": (5, 640), "flagship": (32, 384)}
C, K = 288, 15
_TILES = "constexpr int kStripTiles = 0;"
VARIANTS = {  # name: (the committed line, its replacement)
    **{f"tiles{n}": (_TILES, f"constexpr int kStripTiles = {n};") for n in (1, 2, 3)},
    "one_strip": (_TILES, "constexpr int kStripTiles = 1 << 20;"),
    "ch64": ("constexpr int kBwdCh = 32;", "constexpr int kBwdCh = 64;"),
    "stages3": ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
    "blocks3": ("constexpr int kBwdMinBlocks = 1;", "constexpr int kBwdMinBlocks = 3;"),
}


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches queued behind a
    device spin; the spin doubles (up to 8×) while it runs out before the
    host has queued them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for doubling in range(4):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(80_000_000 << doubling)
        s.record()
        for _ in range(iters):
            fn()
        outran = s.query()
        e.record()
        torch.cuda.synchronize()
        if not outran:
            return s.elapsed_time(e) / iters
    raise SystemExit("the device spin ran out before the launches were queued")


def case(B: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)).cuda() for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32) / 4).cuda()
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32)).cuda()
    return x, w, b, g


def op_times(dwc, cases: dict) -> dict:
    """The op's whole backward at each shape, ms."""
    out = {}
    for label, (x, w, b, g) in cases.items():
        xr, wr, br = (v.clone().requires_grad_(True) for v in (x, w, b))
        y = dwc.depthwise_conv1d(xr, wr, br)
        out[label] = cuda_ms(lambda: torch.autograd.grad(y, (xr, wr, br), g, retain_graph=True))
    return out


def library(dwc, name: str | None, src_dir: Path, build_dir: Path):
    """The depthwise library built from the source as it stands (``name``
    None) or with ``VARIANTS[name]``'s substitution."""
    lib = copy.copy(dwc.DW_BWD.library)
    if name is not None:
        old, new = VARIANTS[name]
        src = (src_dir / "depthwise_conv.cu").read_text()
        if old not in src:
            raise SystemExit(f"{old!r} not in depthwise_conv.cu")
        path = build_dir / "variants" / f"depthwise_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src.replace(old, new))
        lib.name, lib.source = f"ssd_depthwise_{name}", path
    lib._lib, lib._lock = None, threading.Lock()
    return lib


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1],
                   help="the checkout to import ssd_tpu_torch from (default: this one)")
    p.add_argument("--op-only", action="store_true", help="time only the op's whole backward")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_depthwise_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve()))
    from ssd_tpu_torch.ops import depthwise_conv as dwc
    from ssd_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

    torch.backends.cudnn.allow_tf32 = False
    print(f"ssd_tpu_torch from {Path(dwc.__file__).resolve().parents[2]}; "
          f"{torch.cuda.get_device_name(0)}")
    cases = {label: case(B, T, seed=i) for i, (label, (B, T)) in enumerate(SHAPES.items())}
    ops = {label: [] for label in cases}
    for _ in range(args.rounds):
        for label, ms in op_times(dwc, cases).items():
            ops[label].append(ms)
    for label, t in ops.items():
        print(f"op backward {label:8s} B={SHAPES[label][0]} T'={SHAPES[label][1]}: median "
              f"{np.median(t):.4f} ms over {len(t)} rounds ({', '.join(f'{v:.4f}' for v in t)})")
    if args.op_only:
        return 0

    libs = {"committed": library(dwc, None, CSRC_DIR, BUILD_DIR),
            **{name: library(dwc, name, CSRC_DIR, BUILD_DIR) for name in VARIANTS}}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    kernels = {}
    for name, lib in libs.items():
        kernels[name] = dwc.DepthwiseBwdKernel()
        kernels[name].library = lib
    for label, (x, w, _, g) in cases.items():
        want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, g)
        want = torch.cat([want_dwp.sum(dim=0), g.sum(dim=(0, 1))[None]])
        for name, k in kernels.items():
            dx, part = k(x, w, g)
            sums = part.sum(dim=(0, 1))
            dx_err = float((dx - want_dx).abs().max())
            if not bool(((dx - want_dx).abs() <= 1e-5 + 1e-5 * want_dx.abs()).all()):
                raise SystemExit(f"{name} at {label}: dx max abs err {dx_err}")
            for what, got, ref in (("dw", sums[:K], want[:K]), ("db", sums[K], want[K])):
                err = float((got - ref).abs().max())
                if err > 1e-4 * float(ref.abs().max()):
                    raise SystemExit(f"{name} at {label}: {what} max abs err {err}")
            print(f"{name:10s} {label:8s}: {part.shape[1]} strip(s); dx max abs err {dx_err:.2e}")
    times = {(name, label): [] for name in kernels for label in cases}
    for r in range(args.rounds):
        for key in (list(times) if r % 2 == 0 else list(times)[::-1]):
            x, w, _, g = cases[key[1]]
            times[key].append(cuda_ms(lambda: kernels[key[0]](x, w, g)))
    for (name, label), t in times.items():
        print(f"{name:10s} {label:8s} B={SHAPES[label][0]} T'={SHAPES[label][1]}: median "
              f"{np.median(t):.4f} ms over {len(t)} rounds ({', '.join(f'{v:.4f}' for v in t)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
