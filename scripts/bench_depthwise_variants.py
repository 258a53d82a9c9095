#!/usr/bin/env python3
"""Time the CUDA depthwise kernels' variants, forward and backward, and the
op's forward and whole backward, for the fp32 or the bf16 instances.

    python3 scripts/bench_depthwise_variants.py [--dtype fp32|bf16] [--rounds 3]
        [--variants NAME ...]
    python3 scripts/bench_depthwise_variants.py --op-only [--dtype bf16] --tree DIR

A variant is ``ssd_tpu_torch/csrc/depthwise_conv.cu`` with constants
replaced by text substitution, or (fp32) the forward yardstick
``scripts/depthwise_fwd_ring.cu`` (the backward's design applied to the
forward) with or without one, written to ``ssd_tpu_torch/_build/variants/``
and built with the package's own nvcc flags, all sources at once; a variant
that does not build is reported and left out.

fp32, at the main path's shapes B = 5, T' = 640 and B = 32, T' = 384
(training) and B = 8, T' = 625 (serving), C 288, K 15. Forward: 8 or 32
rows a thread (``kFwdRows``), 2 or 8 warps a CTA (``kFwdWarps``); the ring
yardstick with the cost model's strips, strips of 1 tile or one strip of
the whole T (``kFwdStripTiles``), 64 channels a CTA (``kFwdCh``) and a
three-stage ring (``kFwdStages``). Backward: strips of 1, 2 or 3 tiles, or
one strip (``kStripTiles``), 64 channels a CTA (``kBwdCh``), a three-stage
ring (``kStages``), and the K ≤ 15 instance built for three CTAs an SM
(``kBwdMinBlocks``, at most 80 registers).

bf16, at tpu_scaled_large's shapes B = 32, T' = 384 (training) and B = 8,
T' = 625 (serving), C 768, K 15. Channels a thread: 1 (``kBf16Pairs``
false, the one-channel design of the fp32 instance), 2 (committed: one
bf16x2 word) or 4 (``kFwdPairs`` 2: 8-byte loads); 8 or 32 rows and 2 or 8
warps as fp32's; the forward built for 4 or 6 CTAs an SM (``kFwdMinBlocks``);
the backward's ring 2 or 4 tiles deep (``kPairStages``), strips of 1 or 2 tiles
or one strip (``kPairStripTiles``), built for 1 or 3 CTAs an SM
(``kPairMinBlocks``), 4 or 16 rows a thread (``kPairRows``; 16 also at 4
CTAs an SM); ``packed``, two channels' products a
bf16x2 multiply, each unpacked to fp32 after it by a shift or a mask
(``kZeroLane`` false); ``generic_k``, K a runtime value also where it
equals the instance's bound (the guarded taps of every other K);
and ``ch1_noround``, the one-channel design
without the per-tap rounding (``kRoundTaps`` false): **not bit-equal**,
never gated and never shipped, it times what the rounding's conversions
cost there. A TMA fill of the backward's ring is not built.

Each variant is held to the plain version on the card — the forward
bit-equal; dx within 1e-5 (fp32) or bit-equal (bf16); dw and db within
1e-4 of their largest magnitude — except ``ch1_noround``, whose errors are
printed, and timed, with the committed source, in the directions it
changes, with CUDA events (mean of 50 warm launches queued behind a device
spin). Rounds alternate the order. ptxas's registers and spills are printed
for each variant's kernels of the dtype; ``--sass`` also prints the committed
build's SASS instruction mix for each of them (``cuobjdump -sass``: static
counts by opcode, the unrolled loops' bodies once).

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

RING = Path(__file__).resolve().parent / "depthwise_fwd_ring.cu"
_ROWS, _WARPS = "constexpr int kFwdRows = 16;", "constexpr int kFwdWarps = 4;"
_RING_TILES = "constexpr int kFwdStripTiles = 0;"
_TILES = "constexpr int kStripTiles = 0;"
_PAIR_TILES = "constexpr int kPairStripTiles = 0;"
_ONE_CHANNEL = ("constexpr bool kBf16Pairs = true;", "constexpr bool kBf16Pairs = false;")
_GENERIC_FWD = {  # forward geometry, both instances
    **{f"rows{n}": ("fwd", "package", [(_ROWS, f"constexpr int kFwdRows = {n};")]) for n in (8, 32)},
    **{f"warps{n}": ("fwd", "package", [(_WARPS, f"constexpr int kFwdWarps = {n};")]) for n in (2, 8)},
}
# dtype → name: (directions, source: the package's or the ring yardstick, [(line, replacement)])
VARIANTS = {
    "fp32": {
        **_GENERIC_FWD,
        "ring": ("fwd", "ring", []),
        "ring_tiles1": ("fwd", "ring", [(_RING_TILES, "constexpr int kFwdStripTiles = 1;")]),
        "ring_one_strip": ("fwd", "ring", [(_RING_TILES, "constexpr int kFwdStripTiles = 1 << 20;")]),
        "ring_ch64": ("fwd", "ring", [("constexpr int kFwdCh = 32;", "constexpr int kFwdCh = 64;")]),
        "ring_stages3": ("fwd", "ring",
                         [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;")]),
        **{f"tiles{n}": ("bwd", "package", [(_TILES, f"constexpr int kStripTiles = {n};")])
           for n in (1, 2, 3)},
        "one_strip": ("bwd", "package", [(_TILES, "constexpr int kStripTiles = 1 << 20;")]),
        "ch64": ("bwd", "package", [("constexpr int kBwdCh = 32;", "constexpr int kBwdCh = 64;")]),
        "stages3": ("bwd", "package", [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
        "blocks3": ("bwd", "package",
                    [("constexpr int kBwdMinBlocks = 1;", "constexpr int kBwdMinBlocks = 3;")]),
    },
    "bf16": {
        "ch1": ("fwd bwd", "package", [_ONE_CHANNEL]),
        "ch1_noround": ("fwd bwd", "package",
                        [_ONE_CHANNEL, ("constexpr bool kRoundTaps = true;",
                                        "constexpr bool kRoundTaps = false;")]),
        "ch4": ("fwd", "package", [("constexpr int kFwdPairs = 1;", "constexpr int kFwdPairs = 2;")]),
        "generic_k": ("fwd bwd", "package", [("if constexpr (kExact) K = KMAX;", "")]),
        "packed": ("fwd bwd", "package", [("constexpr bool kZeroLane = true;",
                                           "constexpr bool kZeroLane = false;")]),
        **_GENERIC_FWD,
        **{f"fwd_blocks{n}": ("fwd", "package", [("constexpr int kFwdMinBlocks = 5;",
                                                  f"constexpr int kFwdMinBlocks = {n};")])
           for n in (4, 6)},
        **{f"bwd_rows{n}": ("bwd", "package", [("constexpr int kPairRows = 8;",
                                                f"constexpr int kPairRows = {n};")])
           for n in (4, 16)},
        "bwd_rows16_blocks4": ("bwd", "package", [
            ("constexpr int kPairRows = 8;", "constexpr int kPairRows = 16;"),
            ("constexpr int kPairMinBlocks = 2;", "constexpr int kPairMinBlocks = 4;")]),
        **{f"stages{n}": ("bwd", "package",
                          [("constexpr int kPairStages = 3;", f"constexpr int kPairStages = {n};")])
           for n in (2, 4)},
        **{f"tiles{n}": ("bwd", "package", [(_PAIR_TILES, f"constexpr int kPairStripTiles = {n};")])
           for n in (1, 2)},
        "one_strip": ("bwd", "package", [(_PAIR_TILES, "constexpr int kPairStripTiles = 1 << 20;")]),
        **{f"blocks{n}": ("bwd", "package", [("constexpr int kPairMinBlocks = 2;",
                                              f"constexpr int kPairMinBlocks = {n};")])
           for n in (1, 3)},
    },
}
NOT_BIT_EQUAL = {"ch1_noround"}  # timing only: never gated, never shipped
SHAPES = {"fp32": {"config": (5, 640), "flagship": (32, 384), "serving": (8, 625)},
          "bf16": {"train": (32, 384), "serve": (8, 625)}}
CHANNELS = {"fp32": 288, "bf16": 768}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
K = 15


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


def case(B: int, T: int, C: int, dtype: torch.dtype, seed: int):
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)).cuda().to(dtype)
            for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32) / 4).cuda().to(dtype)
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32)).cuda().to(dtype)
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


def library(dwc, dtype: str, name: str | None, src_dir: Path, build_dir: Path):
    """The depthwise library built from the source as it stands (``name``
    None) or from ``VARIANTS[dtype][name]``'s source and substitutions; the
    ring yardstick exports the fp32 forward only."""
    lib = copy.copy(dwc.DW_BWD.library)
    if name is not None:
        _, source, subs = VARIANTS[dtype][name]
        src = (RING if source == "ring" else src_dir / "depthwise_conv.cu").read_text()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{old!r} not in {source}'s source")
            src = src.replace(old, new)
        path = build_dir / "variants" / f"depthwise_{dtype}_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        lib.name, lib.source = f"ssd_depthwise_{dtype}_{name}", path
        if source == "ring":
            keep = ("ssd_dw_fwd_launch", "ssd_dw_error_string")
            lib.functions = {k: v for k, v in lib.functions.items() if k in keep}
            lib.functions["ssd_dw_fwd_strips"] = ([ctypes.c_int] * 4, ctypes.c_int)
    lib._lib, lib._lock = None, threading.Lock()
    return lib


def ptxas_lines(name: str, dtype: str, log: str) -> None:
    """Print ptxas's registers and spills for the variant's kernels of the
    dtype (bf16: the pair kernels and the bf16 instances of the others)."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"(dw_\w+?_kernel)I(\w+?)EEv", line)
            entry = ""
            if found:
                args = found.group(2)
                is_bf16 = "pair" in found.group(1) or "bfloat16" in args
                if is_bf16 == (dtype == "bf16"):
                    args = re.sub(r"Li(\d+)E", r"\1,", args.replace("13__nv_bfloat16", "bf16,"))
                    args = args.replace("Lb1E", "true,").replace("Lb0E", "false,")
                    entry = f"{found.group(1)}<{args.lstrip('f').strip(',')}>"
        elif entry and ("registers" in line or "spill" in line):
            print(f"[ptxas] {name} {entry}: {line.strip()}")


def sass_mix(path: Path, dtype: str, top: int = 16) -> None:
    """Print the SASS opcodes of the library's kernels of the dtype, most
    frequent first (static counts)."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(path)],
                         capture_output=True, text=True, timeout=300).stdout
    for section in out.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        found = re.search(r"(dw_\w+?_kernel)I(\w+?)EEv", name)
        if not found or ("pair" in found.group(1) or "bfloat16" in found.group(2)) != (dtype == "bf16"):
            continue
        ops = {}
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", section):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        mix = sorted(ops.items(), key=lambda kv: -kv[1])
        print(f"[sass] {found.group(1)}<{found.group(2)}>: {sum(ops.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in mix[:top]))


def check_variant(dwc, dtype: str, name: str, fwd, bwd, cases: dict) -> None:
    """Raise unless the variant's kernels agree with the plain versions
    (``bwd`` None: a forward-only yardstick); a timing-only variant prints
    its errors."""
    gated = name not in NOT_BIT_EQUAL
    for label, (x, w, b, g) in cases.items():
        y = fwd(x, w, b)
        want_y = dwc.depthwise_conv1d_plain(x, w, b)
        y_err = float((y.float() - want_y.float()).abs().max())
        if gated and not torch.equal(y, want_y):
            raise SystemExit(f"{name} at {label}: the forward is not bit-equal to the plain version")
        B, T, C = x.shape
        if bwd is None:
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            strips = fwd.library.load().ssd_dw_fwd_strips(B, T, C, sms)
            print(f"{name:14s} {label:8s}: forward bit-equal, {strips} strip(s) a batch row")
            continue
        want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, g)
        want = torch.cat([want_dwp.sum(dim=0), g.float().sum(dim=(0, 1))[None]])
        dx, part = bwd(x, w, g)
        sums = part.sum(dim=(0, 1))
        dx_err = float((dx.float() - want_dx.float()).abs().max())
        if dtype == "bf16":
            dx_ok = torch.equal(dx, want_dx)
        else:
            dx_ok = bool(((dx - want_dx).abs() <= 1e-5 + 1e-5 * want_dx.abs()).all())
        if gated and not dx_ok:
            raise SystemExit(f"{name} at {label}: dx max abs err {dx_err}")
        errs = {}
        for what, got, ref in (("dw", sums[:K], want[:K]), ("db", sums[K], want[K])):
            errs[what] = float((got - ref).abs().max()) / float(ref.abs().max())
            if errs[what] > 1e-4:
                raise SystemExit(f"{name} at {label}: {what} {errs[what]} of its largest")
        print(f"{name:14s} {label:8s}: "
              + (f"forward and dx {'bit-equal' if dtype == 'bf16' else 'checked'}" if gated else
                 f"NOT BIT-EQUAL (timing only): forward max abs err {y_err:.3e}, dx {dx_err:.3e}")
              + f"; backward {part.shape[1]} strip(s), dx max abs err {dx_err:.2e}, dw / db "
              f"{errs['dw']:.1e} / {errs['db']:.1e} of their largest")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", choices=sorted(DTYPES), default="fp32")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--variants", nargs="+", help="time only these variants (default: all)")
    p.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1],
                   help="the checkout to import ssd_tpu_torch from (default: this one)")
    p.add_argument("--op-only", action="store_true", help="time only the op's forward and backward")
    p.add_argument("--sass", action="store_true", help="print the committed kernels' SASS mix")
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
    print(f"ssd_tpu_torch from {Path(dwc.__file__).resolve().parents[2]}; {args.dtype}; {card}")
    dtype, shapes, C = DTYPES[args.dtype], SHAPES[args.dtype], CHANNELS[args.dtype]
    cases = {label: case(B, T, C, dtype, seed=i) for i, (label, (B, T)) in enumerate(shapes.items())}
    ops = {}
    for _ in range(args.rounds):
        for key, ms in op_times(dwc, cases).items():
            ops.setdefault(key, []).append(ms)
    for (direction, label), t in ops.items():
        print(f"op {direction:8s} {label:8s} B={shapes[label][0]} T'={shapes[label][1]} C={C}: median "
              f"{np.median(t):.4f} ms over {len(t)} rounds ({', '.join(f'{v:.4f}' for v in t)})")
    if args.op_only:
        return 0

    variants = VARIANTS[args.dtype]
    names = args.variants or list(variants)
    unknown = set(names) - set(variants)
    if unknown:
        raise SystemExit(f"unknown {args.dtype} variants: {sorted(unknown)}")
    libs = {"committed": library(dwc, args.dtype, None, CSRC_DIR, BUILD_DIR),
            **{name: library(dwc, args.dtype, name, CSRC_DIR, BUILD_DIR) for name in names}}

    def build(item):
        try:
            item[1].load()
            return item[0], None
        except RuntimeError as err:
            return item[0], err

    with ThreadPoolExecutor(len(libs)) as pool:
        for name, err in pool.map(build, list(libs.items())):
            if err is not None:
                print(f"{name}: does not build, left out:\n{str(err)[-3000:]}")
                if name == "committed":
                    return 1
                del libs[name]
    if args.sass:
        sass_mix(libs["committed"].library_path(), args.dtype)
    kernels = {}
    for name, lib in libs.items():
        fwd, bwd = dwc.DepthwiseFwdKernel(dtype), dwc.DepthwiseBwdKernel(dtype)
        fwd.library = bwd.library = lib
        ring = name in variants and variants[name][1] == "ring"
        ptxas_lines(name, args.dtype, lib.build_log)
        check_variant(dwc, args.dtype, name, fwd, None if ring else bwd, cases)
        kernels[name] = {"fwd": fwd, "bwd": bwd}
    timed = [(name, d) for d in ("fwd", "bwd") for name in ["committed"] + [
        n for n in libs if n != "committed" and d in variants[n][0].split()]]
    times = {(name, d, label): [] for name, d in timed for label in cases}
    for r in range(args.rounds):
        for key in (list(times) if r % 2 == 0 else list(times)[::-1]):
            name, d, label = key
            x, w, b, g = cases[label]
            k = kernels[name][d]
            times[key].append(cuda_ms((lambda: k(x, w, b)) if d == "fwd" else (lambda: k(x, w, g))))
    for (name, d, label), t in times.items():
        note = " (NOT BIT-EQUAL, timing only)" if name in NOT_BIT_EQUAL else ""
        print(f"{d} {name:14s} {label:8s} B={shapes[label][0]} T'={shapes[label][1]} C={C}: median "
              f"{np.median(t):.4f} ms over {len(t)} rounds ({', '.join(f'{v:.4f}' for v in t)}){note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
