#!/usr/bin/env python3
"""Time the CUDA depthwise kernels' variants, forward and backward, and the
op's forward and whole backward.

    python3 scripts/bench_depthwise_variants.py [--rounds 3]
    python3 scripts/bench_depthwise_variants.py --op-only --tree DIR

A variant is ``ssd_tpu_torch/csrc/depthwise_conv.cu`` with one constant
replaced by text substitution, or the forward yardstick
``scripts/depthwise_fwd_ring.cu`` (the backward's design applied to the
forward) with or without one, written to ``ssd_tpu_torch/_build/variants/``
and built with the package's own nvcc flags, all sources at once. Forward:
8 or 32 rows a thread (``kFwdRows``), 2 or 8 warps a CTA (``kFwdWarps``);
the ring yardstick with the cost model's strips, strips of 1 tile or one
strip of the whole T (``kFwdStripTiles``), 64 channels a CTA (``kFwdCh``)
and a three-stage ring (``kFwdStages``). Backward: strips of 1, 2 or 3
tiles, or one strip (``kStripTiles``), 64 channels a CTA (``kBwdCh``), a
three-stage ring (``kStages``), and the K ≤ 15 instance built for three
CTAs an SM (``kBwdMinBlocks``, at most 80 registers). Each variant is held
to the plain version on the card (the forward bit-equal; dx within 1e-5; dw
and db within 1e-4 of their largest magnitude) and timed, with the committed
source, in the direction it changes, with CUDA events (mean of 50 warm
launches queued behind a device spin) at the main path's shapes: B = 5,
T' = 640 and B = 32, T' = 384 (training) and B = 8, T' = 625 (serving),
C 288, K 15. Rounds alternate the order. ptxas's registers and spills are
printed for each forward variant.

It also times the op — ``depthwise_conv1d``'s forward, and its whole
backward through ``torch.autograd.grad``: the kernel and whatever the op
does around it — of the package it imports. ``--tree DIR`` imports
``ssd_tpu_torch`` from another checkout (say the parent commit, unpacked with
``git archive``), and ``--op-only`` times only that, so two trees are
compared in one call. Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import re
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SHAPES = {"config": (5, 640), "flagship": (32, 384), "serving": (8, 625)}
C, K = 288, 15
RING = Path(__file__).resolve().parent / "depthwise_fwd_ring.cu"
_ROWS, _WARPS = "constexpr int kFwdRows = 16;", "constexpr int kFwdWarps = 4;"
_RING_TILES = "constexpr int kFwdStripTiles = 0;"
_TILES = "constexpr int kStripTiles = 0;"
VARIANTS = {  # name: (direction, source: the package's or the ring yardstick, the line, its replacement)
    **{f"rows{n}": ("fwd", "package", _ROWS, f"constexpr int kFwdRows = {n};") for n in (8, 32)},
    **{f"warps{n}": ("fwd", "package", _WARPS, f"constexpr int kFwdWarps = {n};") for n in (2, 8)},
    "ring": ("fwd", "ring", None, None),
    "ring_tiles1": ("fwd", "ring", _RING_TILES, "constexpr int kFwdStripTiles = 1;"),
    "ring_one_strip": ("fwd", "ring", _RING_TILES, "constexpr int kFwdStripTiles = 1 << 20;"),
    "ring_ch64": ("fwd", "ring", "constexpr int kFwdCh = 32;", "constexpr int kFwdCh = 64;"),
    "ring_stages3": ("fwd", "ring", "constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;"),
    **{f"tiles{n}": ("bwd", "package", _TILES, f"constexpr int kStripTiles = {n};") for n in (1, 2, 3)},
    "one_strip": ("bwd", "package", _TILES, "constexpr int kStripTiles = 1 << 20;"),
    "ch64": ("bwd", "package", "constexpr int kBwdCh = 32;", "constexpr int kBwdCh = 64;"),
    "stages3": ("bwd", "package", "constexpr int kStages = 2;", "constexpr int kStages = 3;"),
    "blocks3": ("bwd", "package", "constexpr int kBwdMinBlocks = 1;", "constexpr int kBwdMinBlocks = 3;"),
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
    """The op's forward and whole backward at each shape, ms."""
    out = {}
    for label, (x, w, b, g) in cases.items():
        xr, wr, br = (v.clone().requires_grad_(True) for v in (x, w, b))
        y = dwc.depthwise_conv1d(xr, wr, br)
        with torch.no_grad():
            out["forward", label] = cuda_ms(lambda: dwc.depthwise_conv1d(x, w, b))
        out["backward", label] = cuda_ms(
            lambda: torch.autograd.grad(y, (xr, wr, br), g, retain_graph=True))
    return out


def library(dwc, name: str | None, src_dir: Path, build_dir: Path):
    """The depthwise library built from the source as it stands (``name``
    None) or from ``VARIANTS[name]``'s source and substitution; the ring
    yardstick exports the forward only."""
    lib = copy.copy(dwc.DW_BWD.library)
    if name is not None:
        _, source, old, new = VARIANTS[name]
        src = (RING if source == "ring" else src_dir / "depthwise_conv.cu").read_text()
        if old is not None:
            if old not in src:
                raise SystemExit(f"{old!r} not in {source}'s source")
            src = src.replace(old, new)
        path = build_dir / "variants" / f"depthwise_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        lib.name, lib.source = f"ssd_depthwise_{name}", path
        if source == "ring":
            keep = ("ssd_dw_fwd_launch", "ssd_dw_error_string")
            lib.functions = {k: v for k, v in lib.functions.items() if k in keep}
            lib.functions["ssd_dw_fwd_strips"] = ([ctypes.c_int] * 4, ctypes.c_int)
    lib._lib, lib._lock = None, threading.Lock()
    return lib


def check_variant(dwc, name: str, fwd, bwd, cases: dict) -> None:
    """Raise unless the variant's kernels agree with the plain versions
    (``bwd`` None: a forward-only yardstick)."""
    for label, (x, w, b, g) in cases.items():
        y = fwd(x, w, b)
        if not torch.equal(y, dwc.depthwise_conv1d_plain(x, w, b)):
            raise SystemExit(f"{name} at {label}: the forward is not bit-equal to the plain version")
        B, T, _ = x.shape
        if bwd is None:
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            strips = fwd.library.load().ssd_dw_fwd_strips(B, T, C, sms)
            print(f"{name:14s} {label:8s}: forward bit-equal, {strips} strip(s) a batch row")
            continue
        want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, g)
        want = torch.cat([want_dwp.sum(dim=0), g.sum(dim=(0, 1))[None]])
        dx, part = bwd(x, w, g)
        sums = part.sum(dim=(0, 1))
        dx_err = float((dx - want_dx).abs().max())
        if not bool(((dx - want_dx).abs() <= 1e-5 + 1e-5 * want_dx.abs()).all()):
            raise SystemExit(f"{name} at {label}: dx max abs err {dx_err}")
        for what, got, ref in (("dw", sums[:K], want[:K]), ("db", sums[K], want[K])):
            err = float((got - ref).abs().max())
            if err > 1e-4 * float(ref.abs().max()):
                raise SystemExit(f"{name} at {label}: {what} max abs err {err}")
        print(f"{name:14s} {label:8s}: forward bit-equal; backward {part.shape[1]} strip(s), "
              f"dx max abs err {dx_err:.2e}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1],
                   help="the checkout to import ssd_tpu_torch from (default: this one)")
    p.add_argument("--op-only", action="store_true", help="time only the op's forward and backward")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_depthwise_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve()))
    from ssd_tpu_torch.ops import depthwise_conv as dwc
    from ssd_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"ssd_tpu_torch from {Path(dwc.__file__).resolve().parents[2]}; {card}")
    cases = {label: case(B, T, seed=i) for i, (label, (B, T)) in enumerate(SHAPES.items())}
    ops = {}
    for _ in range(args.rounds):
        for key, ms in op_times(dwc, cases).items():
            ops.setdefault(key, []).append(ms)
    for (direction, label), t in ops.items():
        print(f"op {direction:8s} {label:8s} B={SHAPES[label][0]} T'={SHAPES[label][1]}: median "
              f"{np.median(t):.4f} ms over {len(t)} rounds ({', '.join(f'{v:.4f}' for v in t)})")
    if args.op_only:
        return 0

    libs = {"committed": library(dwc, None, CSRC_DIR, BUILD_DIR),
            **{name: library(dwc, name, CSRC_DIR, BUILD_DIR) for name in VARIANTS}}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    kernels = {}
    for name, lib in libs.items():
        fwd, bwd = dwc.DepthwiseFwdKernel(), dwc.DepthwiseBwdKernel()
        fwd.library = bwd.library = lib
        ring = name in VARIANTS and VARIANTS[name][1] == "ring"
        if name == "committed" or VARIANTS[name][0] == "fwd":
            entry = ""
            for line in lib.build_log.splitlines():
                if "Compiling entry function" in line:
                    found = re.search(r"(dw_fwd\w*?_kernel)ILi(\d+)E", line)
                    entry = f"{found.group(1)}<{found.group(2)}>" if found else ""
                elif entry and ("registers" in line or "spill" in line):
                    print(f"[ptxas] {name} {entry}: {line.strip()}")
        check_variant(dwc, name, fwd, None if ring else bwd, cases)
        kernels[name] = {"fwd": fwd, "bwd": bwd}
    timed = [(name, d) for d in ("fwd", "bwd") for name in ["committed"] + [
        n for n, (direction, _, _, _) in VARIANTS.items() if direction == d]]
    times = {(name, d, label): [] for name, d in timed for label in cases}
    for r in range(args.rounds):
        for key in (list(times) if r % 2 == 0 else list(times)[::-1]):
            name, d, label = key
            x, w, b, g = cases[label]
            k = kernels[name][d]
            times[key].append(cuda_ms((lambda: k(x, w, b)) if d == "fwd" else (lambda: k(x, w, g))))
    for (name, d, label), t in times.items():
        print(f"{d} {name:14s} {label:8s} B={SHAPES[label][0]} T'={SHAPES[label][1]}: median "
              f"{np.median(t):.4f} ms over {len(t)} rounds ({', '.join(f'{v:.4f}' for v in t)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
