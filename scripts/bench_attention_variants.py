#!/usr/bin/env python3
"""Time variants of the CUDA attention kernels against the committed ones.

    python3 scripts/bench_attention_variants.py [--rounds 2]

Each variant is the committed ``ssd_tpu_torch/csrc/attention.cu`` with a
few text substitutions (how the tf32 split rounds, whether the products
summed over keys or queries start from a fresh accumulator, how many score
columns the backward holds at once), written to
``ssd_tpu_torch/_build/variants/`` and built with the package's own nvcc
flags, all variants at once. Each is held to the plain PyTorch version
(forward atol = rtol = 1e-5, gradients 2e-5 + 1e-4 rel, the tolerances of
chip_smoke.py) and timed with CUDA events (mean of 30 warm launches queued
behind a device spin) at the main path's shapes — B = 5 / T' = 640 and
B = 32 / T' = 384 with a dropout multiplier, B = 8 / T' = 625 without —
H 6, hd 48, with one batch row of length 1. Rounds alternate the order.
Prints ptxas's register / spill report per variant. Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ssd_tpu_torch.ops import attention as attn  # noqa: E402
from ssd_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR  # noqa: E402

_RNA = "return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
_FRESH = """  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, a.small, bb);
  mma_tf32(c, a.big, bs);
  mma_tf32(c, a.big, bb);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];"""
_CHUNK = "constexpr int kChunk = 2;"
VARIANTS = {
    "committed": [],
    # the same rounding on the conversion unit
    "cvt_rna": [(_RNA, 'uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); return r;')],
    # long sums accumulate in the tensor cores' truncating adds
    "one_accumulator": [(_FRESH, """  mma_tf32(acc, a.small, bb);
  mma_tf32(acc, a.big, bs);
  mma_tf32(acc, a.big, bb);""")],
    "chunk1": [(_CHUNK, "constexpr int kChunk = 1;")],
    "chunk4": [(_CHUNK, "constexpr int kChunk = 4;")],
}
SHAPES = {"config": (5, 640, True), "serving": (8, 625, False), "flagship": (32, 384, True)}
HEADS, HEAD_DIM = 6, 48
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def library(name: str, subs) -> attn.CudaLibrary:
    src = (CSRC_DIR / "attention.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old[:40]!r} not in attention.cu")
        src = src.replace(old, new)
    path = BUILD_DIR / "variants" / f"attention_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = copy.copy(attn.ATTN_FWD.library)
    lib.name, lib.source, lib._lib, lib._lock = f"ssd_attention_{name}", path, None, threading.Lock()
    return lib


def cuda_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    if start.query():
        raise SystemExit("the device spin ran out before the launches were queued")
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def case(B: int, T: int, drop: bool):
    gen = torch.Generator().manual_seed(T)
    dev = torch.device("cuda")
    q, k, v, g = (torch.randn((B, T, HEADS, HEAD_DIM), generator=gen).to(dev).transpose(1, 2)
                  for _ in range(4))
    lengths = torch.randint(T // 2, T + 1, (B,), generator=gen)
    lengths[-1] = 1
    mask = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
    mult = ((torch.rand((T, T), generator=gen) < 0.88).float() / 0.88).to(dev) if drop else None
    return q, k, v, g, mask, mult


def close(a, b, tol) -> bool:
    return bool(((a - b).abs() <= tol["atol"] + tol["rtol"] * b.abs()).all())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    libs = {name: library(name, subs) for name, subs in VARIANTS.items()}
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per variant, together
        list(pool.map(lambda lib: lib.load(), libs.values()))
    kernels = {}
    for name, lib in libs.items():
        fwd, bwd = attn.AttentionFwdKernel(), attn.AttentionBwdKernel()
        fwd.library = bwd.library = lib
        kernels[name] = (fwd, bwd)
        report = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(report)}")
    for label, (B, T, drop) in SHAPES.items():
        q, k, v, g, mask, mult = case(B, T, drop)
        want = attn.fused_attention_plain(q, k, v, mask, mult)
        want_grads = attn.fused_attention_bwd_plain(q, k, v, mask, mult, g)
        times = {name: [] for name in kernels}
        for r in range(args.rounds):
            order = list(kernels) if r % 2 == 0 else list(reversed(kernels))
            for name in order:
                fwd, bwd = kernels[name]
                out, rmax, rsum = fwd(q, k, v, mask, mult)
                grads = bwd(q, k, v, out, g, rmax, rsum, mask, mult)
                if r == 0:
                    ok = close(out, want, FWD_TOL) and all(
                        close(a, b, GRAD_TOL) for a, b in zip(grads, want_grads))
                    err = max(float((a - b).abs().max()) for a, b in zip(grads, want_grads))
                    times[name].append(("within" if ok else "OUTSIDE") + f" tolerance, grads {err:.2e}")
                times[name].append((cuda_ms(lambda: fwd(q, k, v, mask, mult)),
                                    cuda_ms(lambda: bwd(q, k, v, out, g, rmax, rsum, mask, mult))))
        for name, rows in times.items():
            ms = rows[1:]
            print(f"[{label} B={B} T'={T}{' mult' if drop else ''}] {name}: {rows[0]}; forward "
                  f"{' / '.join(f'{f:.4f}' for f, _ in ms)} ms, backward "
                  f"{' / '.join(f'{b:.4f}' for _, b in ms)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
