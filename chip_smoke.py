#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds every kernel of the
path from ``ssd_tpu_torch/csrc`` itself. Imports nothing of JAX or of the
JAX package. Phases, each failing loudly:

1. build   — compile ``csrc/logmel.cu`` for sm_90a; print the build time,
             the card's name and power limit, and the TF32 settings.
2. kernel  — the log-mel kernel against its plain PyTorch version at the
             serving buckets (B ∈ {1, 8}, 8 channels, 4 000–12 000 valid
             samples in a 12 800-sample bucket): normalized features within
             atol = rtol = 1e-4; kernel, plain and ``torch.stft`` times.
3. engine  — the full-width ``configs/tpu_fast_plus.yaml`` model (random
             flax-style weights from a seed) saved in the port's checkpoint
             format, loaded with ``InferenceEngine.from_checkpoint(...,
             device="cuda")``, transcribing batches of 1, 4 and 8 requests
             with greedy and beam-50 decoding.
4. server  — ``ssd_tpu_torch.serving.server`` in-process on a free port:
             three ``/transcribe`` requests, ``/stream/start`` → 501.
   Launch counts are zeroed before phase 3 and read after phase 4: the
   kernel must have launched exactly once per ``transcribe``. Then the
   card's log-probs are held against the same engine on the CPU, and the
   card's greedy / beam text against the CPU decoders on the same log-probs.
5. latency — p50 per-utterance latency at B = 1 and B = 8, greedy and beam-50.

The last three lines of standard output are the kernel JSON, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without the last line.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.models.conformer import init_flax_style
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops import featurizer as feat
from ssd_tpu_torch.ops import mel as melmod
from ssd_tpu_torch.serving.engine import InferenceEngine
from ssd_tpu_torch.serving.server import encode_npy, serve
from ssd_tpu_torch.training.checkpoint import save_checkpoint

SEED = 0
CHANNELS = 8
BUCKET = 12800  # largest serving bucket exercised: 5 × SAMPLE_BUCKET
# configs/tpu_fast_plus.yaml:15-21 and :26-37, inlined (no yaml on the card)
FEATURES = {"emg": {"sample_rate": 1000, "n_fft": 320, "hop_length": 10,
                    "n_mels": 80, "normalize": "per_file"}}
MODEL = {
    "encoder": {"d_model": 288, "num_layers": 6, "num_heads": 6, "ffn_dim": 1152,
                "depthwise_conv_kernel_size": 15, "dropout": 0.12,
                "subsample_factor": 2, "input_dim": 640},
    "projection_dim": 768,
    "ctc_dropout": 0.12,
}
DECODING = {"type": "beam", "beam_width": 50, "alpha": 0.4, "beta": 0.0,
            "beam_prune_logp": -10.0, "lm_path": None}

FEAT_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_featurizer.py::test_fused_matches_xla
# card vs CPU log-probs, full fp32 on both (TF32 off): summation order only,
# through 6 blocks and a ×10 CTC head
LOGPROB_TOL = dict(atol=2e-3, rtol=1e-4)
H100_FP32_FLOPS = 67e12  # non-tensor-core fp32, SXM, 700 W
H100_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` warm launches."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def requests(rng: np.random.Generator, n: int) -> list:
    lengths = rng.integers(4000, 12001, size=n)
    return [rng.normal(size=(int(k), CHANNELS)).astype(np.float32) for k in lengths]


# ---------------------------------------------------------------- phases


def phase_build() -> str:
    t0 = time.perf_counter()
    lib = feat.LOGMEL.library
    lib.load()
    how = f"nvcc {lib.build_seconds:.2f} s" if lib.build_log else "reused the built library"
    print(f"[build] logmel.cu ready in {time.perf_counter() - t0:.2f} s ({how}: "
          f"{lib.library_path().name})")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")
    card = card_line()
    print(f"[build] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[build] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return card


def stft_logmel(emg: torch.Tensor, cfg: feat.FeaturizerConfig, window, mel_t) -> torch.Tensor:
    """Library yardstick: the same function through ``torch.stft`` (timed
    only; the port never calls it)."""
    B, L, C = emg.shape
    spec = torch.stft(emg.permute(0, 2, 1).reshape(B * C, L), cfg.n_fft, cfg.hop_length,
                      window=window, center=False, return_complex=True)
    power = spec.abs().square().transpose(1, 2)
    return 10.0 * torch.log10(torch.clamp(power @ mel_t, min=1e-10))


def phase_kernel(rng: np.random.Generator) -> dict:
    cfg = feat.FeaturizerConfig(**FEATURES["emg"])
    dev = torch.device("cuda")
    window = torch.hann_window(cfg.n_fft, periodic=True, device=dev)
    mel_t = torch.from_numpy(np.ascontiguousarray(
        melmod.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels).T)).to(dev)
    entry = {}
    for B in (1, 8):
        lengths = rng.integers(4000, 12001, size=B)
        emg = np.zeros((B, BUCKET, CHANNELS), np.float32)
        for i, n in enumerate(lengths):
            emg[i, :n] = rng.normal(size=(n, CHANNELS))
        x = torch.from_numpy(emg).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        got = feat.normalize_logmels(feat.LOGMEL(x, cfg), lens, cfg)[0]
        want = feat.normalize_logmels(feat.logmel_core_plain(x, cfg), lens, cfg)[0]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"kernel features not finite at B={B}")
        check(close(got, want, **FEAT_TOL),
              f"kernel vs plain features at B={B}: max abs err {err} > {FEAT_TOL}")
        ms = cuda_ms(lambda: feat.LOGMEL(x, cfg))
        plain_ms = cuda_ms(lambda: feat.logmel_core_plain(x, cfg))
        library_ms = cuda_ms(lambda: stft_logmel(x, cfg, window, mel_t))
        T = cfg.frame_count(BUCKET)
        rows_frames = B * CHANNELS * T
        flops = rows_frames * (4 * cfg.n_fft * cfg.n_bins + 3 * cfg.n_bins
                               + 2 * cfg.n_bins * cfg.n_mels)
        nbytes = 4 * (B * BUCKET * CHANNELS + rows_frames * cfg.n_mels
                      + 2 * cfg.n_fft * cfg.n_bins + cfg.n_bins * cfg.n_mels + cfg.n_fft)
        t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        print(f"[kernel] B={B} rows={B * CHANNELS} frames={T}: max_abs_err={err:.3e} "
              f"(tol {FEAT_TOL}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.stft {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
        entry = {
            "name": "logmel", "route": "cuda", "source": "ssd_tpu_torch/csrc/logmel.cu",
            "replaces": "ssd_tpu/ops/featurizer.py:239",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
        }
    return entry  # the B=8 (largest bucket) entry


def build_run_dir(run_dir: Path) -> Path:
    vocab_path = run_dir / "vocab.json"
    default_vocab().to_json(vocab_path)
    cfg = {"data": {"vocab": str(vocab_path)}, "features": FEATURES, "model": MODEL,
           "decoding": DECODING}
    model = build_model(cfg, input_dim=MODEL["encoder"]["input_dim"], vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # ×10 CTC head: peaked log-probs, so text comparisons are not decided
        # by fp32 rounding between near-tied tokens
        model.ctc_head.fc.weight.mul_(10.0)
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(run_dir, model.state_dict(), cfg)
    print(f"[engine] tpu_fast_plus model: {n_params / 1e6:.2f} M params, "
          f"checkpoint {run_dir / 'last'}")
    return run_dir / "last"


def post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def phase_main_path(ckpt: Path, rng: np.random.Generator):
    """Phases 3 and 4, the counted run of the main path."""
    engines = {d: InferenceEngine.from_checkpoint(ckpt, decoder=d, device="cuda")
               for d in ("greedy", "beam")}
    batches = {B: requests(rng, B) for B in (1, 4, 8)}
    server_reqs = requests(rng, 3)

    feat.LOGMEL.launches = 0
    texts = {}
    for B, reqs in batches.items():
        for d, eng in engines.items():
            before = feat.LOGMEL.launches
            texts[B, d] = eng.transcribe(reqs)
            check(feat.LOGMEL.launches == before + 1,
                  f"{d} transcribe at B={B}: kernel launches {before} → {feat.LOGMEL.launches}")
            check(len(texts[B, d]) == B, f"{d} B={B}: {len(texts[B, d])} hypotheses")
        print(f"[engine] B={B}: greedy {texts[B, 'greedy'][0][:40]!r} | "
              f"beam-50 {texts[B, 'beam'][0][:40]!r}")

    server = serve(ckpt, port=0, host="127.0.0.1", warmup=False, max_wait_ms=5.0,
                   device="cuda")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            check(json.load(r)["status"] == "ok", "/healthz")
        served = [post(port, "/transcribe", {"emg": encode_npy(a)})["hypotheses"][0]
                  for a in server_reqs]
        try:
            post(port, "/stream/start", {})
            raise SmokeFailure("/stream/start answered 200, expected 501")
        except urllib.error.HTTPError as e:
            check(e.code == 501, f"/stream/start answered {e.code}, expected 501")
    finally:
        server.shutdown()
        server.batcher.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    launches = feat.LOGMEL.launches
    n_calls = 2 * len(batches) + len(server_reqs)
    check(launches == n_calls, f"kernel launched {launches} times in {n_calls} transcribes")
    print(f"[server] 3 /transcribe answered, /stream/start → 501; "
          f"main path launched logmel {launches} times in {n_calls} transcribe calls")
    direct = [engines["greedy"].transcribe([a])[0] for a in server_reqs]
    check(served == direct, f"server {served} != engine {direct}")
    return engines, batches, launches


def phase_parity(ckpt: Path, engines: dict, batches: dict) -> None:
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    for B, reqs in batches.items():
        lp, ol = engines["greedy"].forward(reqs)
        lp_cpu, ol_cpu = cpu.forward(reqs)
        check(tuple(lp.shape) == tuple(lp_cpu.shape) and lp.shape[-1] == 48,
              f"log-prob shapes {tuple(lp.shape)} vs {tuple(lp_cpu.shape)}")
        check(bool(torch.isfinite(lp).all()), f"non-finite log-probs at B={B}")
        check(torch.equal(ol.cpu(), ol_cpu), f"out lengths differ at B={B}")
        lp_host = lp.cpu()
        err = float((lp_host - lp_cpu).abs().max())
        check(close(lp_host, lp_cpu, **LOGPROB_TOL),
              f"card vs CPU log-probs at B={B}: max abs err {err} > {LOGPROB_TOL}")
        for d in ("greedy", "beam"):
            card = engines[d].decode(lp, ol)[:B]
            host = cpu.decode(lp_host, ol.cpu(), decoder=d)[:B]
            check(card == host, f"{d} text differs card vs CPU at B={B}: {card} vs {host}")
        print(f"[parity] B={B}: log-probs {tuple(lp.shape)} max abs err card vs CPU {err:.3e} "
              f"(tol {LOGPROB_TOL}); greedy and beam-50 text equal to the CPU decoders")


def phase_latency(engines: dict, rng: np.random.Generator) -> None:
    for d, eng in engines.items():
        for B in (1, 8):
            reqs = [rng.normal(size=(12000, CHANNELS)).astype(np.float32) for _ in range(B)]
            eng.transcribe(reqs)  # warm
            iters = 20 if d == "greedy" else 5
            per_utt = []
            for _ in range(iters):
                t0 = time.perf_counter()
                eng.transcribe(reqs)
                per_utt.append((time.perf_counter() - t0) / B)
            print(f"[latency] {d}{'-50' if d == 'beam' else ''} B={B} 12 000 samples: "
                  f"p50 {np.percentile(per_utt, 50) * 1e3:.3f} ms/utterance "
                  f"({iters} runs, host clock, transcribe end to end)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    rng = np.random.default_rng(SEED)
    card = phase_build()
    entry = phase_kernel(rng)
    run_dir = Path(tempfile.mkdtemp(prefix="ssd_chip_smoke_"))
    try:
        ckpt = build_run_dir(run_dir)
        engines, batches, launches = phase_main_path(ckpt, rng)
        entry["launches"] = launches
        phase_parity(ckpt, engines, batches)
        phase_latency(engines, rng)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
