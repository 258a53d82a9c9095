#!/usr/bin/env python3
"""Time variants of the CUDA attention kernels against the committed ones.

    python3 scripts/bench_attention_variants.py [--dtype fp32|bf16] [--rounds 2] [--variants ...]

Each variant is the committed ``ssd_tpu_torch/csrc/attention.cu`` with a
few text substitutions, written to ``ssd_tpu_torch/_build/variants/`` and
built with the package's own nvcc flags, all variants at once (one that
does not build is reported and left out).

fp32 (the 3×TF32 kernels): how the tf32 split rounds, whether the products
summed over keys or queries start from a fresh accumulator, how many score
columns the backward holds at once. Each is held to the plain PyTorch
version (forward atol = rtol = 1e-5, gradients 2e-5 + 1e-4 rel, the
tolerances of chip_smoke.py) at the main path's shapes — B = 5 / T' = 640
and B = 32 / T' = 384 with a dropout multiplier, B = 8 / T' = 625 without —
H 6, hd 48 (tpu_fast_plus).

bf16 (the ``compute_dtype: bfloat16`` instances, hd 64): the products on
wgmma from 128-byte-swizzled tiles (committed) against ldmatrix + mma.sync,
and around each the forward's warps a CTA (64 or 128 queries), the CTAs an
SM each kernel's launch bounds ask for (which caps its registers), the
columns of scores a backward warpgroup holds at once and whether that loop
is unrolled; exp2f in place of MUFU.EX2 through PTX; and the backward's dq
and dk/dv launches timed apart. ``--variants`` names a subset. Each is held to the plain bf16 versions within 2⁻⁶ of
each output's largest (chip_smoke.py's gate) at tpu_scaled_large's shapes —
B = 32 / T' = 384 with a dropout multiplier, B = 8 / T' = 625 without —
H 12, hd 64; the forward is timed as the training call (it also writes the
fp32 output) and the serving call.

Times are CUDA-event means of 30 warm launches queued behind a device spin,
with one batch row of length 1. Rounds alternate the order. Prints ptxas's
register / spill report per variant. Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import re
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ssd_tpu_torch.ops import attention as attn  # noqa: E402
from ssd_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR, CudaLibrary  # noqa: E402

_RNA = "return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
_FRESH = """  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, a.small, bb);
  mma_tf32(c, a.big, bs);
  mma_tf32(c, a.big, bb);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];"""
_CHUNK = "constexpr int kChunk = 2;"
FP32_VARIANTS = {
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
_DQ_LOOP = """#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += kChunkH) {  // 8 · kChunkH keys at a time"""
_KV_LOOP = """#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += kChunkH) {  // 8 · kChunkH queries at a time"""
_EXP = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"((x - m) * kLog2e));'
_DQ_LAUNCH = """  attn_bwd_dq_bf16_kernel<kVec, kK, kSw><<<grid, kThreads, smem_dq, stream>>>(q, k, v, o32, g, dq,
                                                                               rmax, rsum, rows, P);"""
_KV_LAUNCH = """  attn_bwd_dkdv_bf16_kernel<kVec, kK, kSw><<<grid, kThreads, smem_kv, stream>>>(q, k, v, g, dk, dv,
                                                                                 rmax, rows, P);"""
_SRC = (CSRC_DIR / "attention.cu").read_text()


def _set(name: str, value) -> tuple:
    """The substitution that sets the constant ``name`` of attention.cu."""
    m = re.search(rf"constexpr \w+ {name} = [^;]+;", _SRC)
    if m is None:
        raise SystemExit(f"no constant {name} in attention.cu")
    return m.group(0), re.sub(r"= [^;]+;", f"= {str(value).lower()};", m.group(0))


# the hd 64 launches on the mma.sync instances
_MMA = [(f"launch_{kind}_h<{vec}, 4, true>", f"launch_{kind}_h<{vec}, 4, false>")
        for kind in ("fwd", "bwd") for vec in ("true", "false")]
BF16_VARIANTS = {
    # hd 64: wgmma from 128-byte-swizzled tiles (the forward's q · kᵀ with
    # both operands in shared memory, every other product with A from
    # registers); the forward 8 warps, 2 CTAs an SM; the backward 3 CTAs an
    # SM, 32-key chunks
    "committed": [],
    "wgmma_fwd_4warps": [_set("kFwdWarpsWg", 4), _set("kFwdMinBlocksWg", 3)],
    "wgmma_fwd_4warps_min2": [_set("kFwdWarpsWg", 4), _set("kFwdMinBlocksWg", 2)],
    "wgmma_bwd_chunk2": [_set("kBwdChunkWg", 2)],
    "wgmma_bwd_min4": [_set("kBwdMinBlocksWg", 4)],
    "wgmma_bwd_min2": [_set("kBwdMinBlocksWg", 2)],
    # 64-key chunks: dk and dv come out wrong (PERF.md §7)
    "wgmma_bwd_chunk8_min2": [_set("kBwdChunkWg", 8), _set("kBwdMinBlocksWg", 2)],
    "bwd_unrolled": [(_DQ_LOOP, _DQ_LOOP.replace("#pragma unroll 1", "#pragma unroll")),
                     (_KV_LOOP, _KV_LOOP.replace("#pragma unroll 1", "#pragma unroll"))],
    # exp2f, which guards denormal results, in place of ex2.approx.ftz
    "exp2f": [(_EXP, "r = exp2f((x - m) * kLog2e);")],
    # ldmatrix + mma.sync for every product (4 CTAs an SM, 16-key chunks)
    "mma_sync": _MMA,
    "mma_fwd_8warps": _MMA + [_set("kFwdWarpsH", 8), _set("kFwdMinBlocksH", 2)],
    # the backward's two launches timed apart (each leaves the other's
    # outputs unwritten, so these are outside the tolerance by design)
    "dq_launch_only": [(_KV_LAUNCH, "")],
    "dkdv_launch_only": [(_DQ_LAUNCH, "")],
    "mma_dq_launch_only": _MMA + [(_KV_LAUNCH, "")],
    "mma_dkdv_launch_only": _MMA + [(_DQ_LAUNCH, "")],
}
SETUPS = {  # dtype → variants, shapes (B, T', dropout multiplier), H, hd
    "fp32": (FP32_VARIANTS, {"config": (5, 640, True), "serving": (8, 625, False),
                             "flagship": (32, 384, True)}, 6, 48),
    "bf16": (BF16_VARIANTS, {"train": (32, 384, True), "serving": (8, 625, False)}, 12, 64),
}
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_REL = 2.0**-6


def library(name: str, subs) -> "CudaLibrary":
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


def case(B: int, T: int, drop: bool, heads: int, head_dim: int, dtype: torch.dtype):
    gen = torch.Generator().manual_seed(T)
    dev = torch.device("cuda")
    q, k, v, g = (torch.randn((B, T, heads, head_dim), generator=gen).to(dev, dtype).transpose(1, 2)
                  for _ in range(4))
    lengths = torch.randint(T // 2, T + 1, (B,), generator=gen)
    lengths[-1] = 1
    mask = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
    mult = (((torch.rand((T, T), generator=gen) < 0.88).float() / 0.88).to(dev, dtype)
            if drop else None)
    return q, k, v, g, mask, mult


def close(a, b, tol) -> bool:
    return bool(((a - b).abs() <= tol["atol"] + tol["rtol"] * b.abs()).all())


def within(got, want) -> bool:
    """bf16: within 2⁻⁶ of the plain output's largest magnitude."""
    want = want.float()
    return float((got.float() - want).abs().max()) <= BF16_REL * float(want.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(SETUPS), default="bf16")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", help="time only these (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    variants, shapes, heads, head_dim = SETUPS[args.dtype]
    if args.variants:
        variants = {name: variants[name] for name in args.variants}
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    libs = {name: library(name, subs) for name, subs in variants.items()}

    def build(item):
        try:
            item[1].load()
            return None
        except RuntimeError as e:  # a variant that does not build is reported and left out
            return f"{item[0]}: build failed\n{str(e)[-3000:]}"

    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per variant, together
        failed = [f for f in pool.map(build, libs.items()) if f]
    for f in failed:
        print(f)
        libs.pop(f.split(":")[0])
    kernels = {}
    for name, lib in libs.items():
        fwd, bwd = attn.AttentionFwdKernel(dtype), attn.AttentionBwdKernel(dtype)
        fwd.library = bwd.library = lib
        kernels[name] = (fwd, bwd)
        report = [ln.strip() for ln in lib.build_log.splitlines()
                  if ("registers" in ln or "spill" in ln or "wgmma" in ln)]
        print(f"{name}: {' | '.join(report)}")
    for label, (B, T, drop) in shapes.items():
        q, k, v, g, mask, mult = case(B, T, drop, heads, head_dim, dtype)
        want = attn.fused_attention_plain(q, k, v, mask, mult)
        want_grads = attn.fused_attention_bwd_plain(q, k, v, mask, mult, g)
        times = {name: [] for name in kernels}
        for r in range(args.rounds):
            order = list(kernels) if r % 2 == 0 else list(reversed(kernels))
            for name in order:
                fwd, bwd = kernels[name]
                if dtype == torch.bfloat16:
                    out, saved, rmax, rsum = fwd(q, k, v, mask, mult, fp32_out=True)
                else:
                    out, rmax, rsum = fwd(q, k, v, mask, mult)
                    saved = out
                grads = bwd(q, k, v, saved, g, rmax, rsum, mask, mult)
                if r == 0:
                    if dtype == torch.bfloat16:
                        ok = within(out, want) and all(within(a, b) for a, b in zip(grads, want_grads))
                    else:
                        ok = close(out, want, FWD_TOL) and all(
                            close(a, b, GRAD_TOL) for a, b in zip(grads, want_grads))
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(grads, want_grads))
                    out_err = float((out.float() - want.float()).abs().max())
                    times[name].append(("within" if ok else "OUTSIDE")
                                       + f" tolerance, out {out_err:.2e}, grads {err:.2e}")
                row = (cuda_ms(lambda: fwd(q, k, v, mask, mult)),
                       cuda_ms(lambda: bwd(q, k, v, saved, g, rmax, rsum, mask, mult)))
                if dtype == torch.bfloat16:
                    row += (cuda_ms(lambda: fwd(q, k, v, mask, mult, fp32_out=True)),)
                times[name].append(row)
        for name, rows in times.items():
            ms = rows[1:]
            train = (f", forward (training call) {' / '.join(f'{x[2]:.4f}' for x in ms)} ms"
                     if dtype == torch.bfloat16 else "")
            print(f"[{args.dtype} {label} B={B} T'={T}{' mult' if drop else ''}] {name}: {rows[0]}; "
                  f"forward {' / '.join(f'{x[0]:.4f}' for x in ms)} ms, backward "
                  f"{' / '.join(f'{x[1]:.4f}' for x in ms)} ms{train}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
