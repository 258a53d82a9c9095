#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds every kernel of the
paths from ``ssd_tpu_torch/csrc`` itself (one nvcc per source, started
together). Imports nothing of JAX or of the JAX package. Phases, each
failing loudly:

1. build   — compile ``csrc/logmel.cu`` and ``csrc/ctc.cu`` for sm_90a;
             print the build times, ptxas's register report, the card's
             name and power limit, and the TF32 settings (off for matmuls
             and cuDNN for the whole run: the parity phases need fp32).
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
6. ctc kernels — the CTC α and β kernels against their plain versions on
             the card, at the config shape (B = 5, T' = 640, S = 160) and the
             flagship bench shape (B = 32, T' = 384, S = 128), each with an
             empty target, an impossible row and a row of repeated labels:
             α / β where finite within rtol 1e-5, per-sample loss rtol 1e-5,
             logits gradients atol 1e-5; values and logits gradients against
             ``F.ctc_loss`` too. Kernel, plain and ``F.ctc_loss`` times.
7. train   — a synthetic corpus (20 voiced utterances, cached features from
             the port's featurizer, WavLM-width teacher features, a JSONL
             index, a JSON config inlining ``configs/tpu_fast_plus.yaml``)
             trained by ``train_from_config(..., device="cuda")`` for one
             epoch of 2 overfit batches, from cached features and from raw
             EMG; then resumed for epoch 2; then served. Launch counts are
             zeroed before each run and read after it: α once per train and
             eval step, β once per train step, log-mel once per step in raw
             mode.
8. train parity — one full-width train step at B = 5 on the card and on the
             CPU from the same weights and batch (dropout 0, no
             augmentation): losses, every gradient and the updated batch
             statistics; then 20 steps on one batch must lower the loss.
9. train rate — step time p50 over 10 warm steps, split into forward +
             loss, backward and optimizer, utterances/s, and the CTC
             kernels' share of the step, at B = 5 (config) and B = 32.

The last three lines of standard output are the kernel JSON, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without the last line.
"""

from __future__ import annotations

import contextlib
import copy
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

import torch.nn.functional as F

from ssd_tpu_torch.data.index_dataset import save_index
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.models.conformer import init_flax_style
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops import ctc_loss as ctc
from ssd_tpu_torch.ops import featurizer as feat
from ssd_tpu_torch.ops import mel as melmod
from ssd_tpu_torch.serving.engine import InferenceEngine
from ssd_tpu_torch.serving.server import encode_npy, serve
from ssd_tpu_torch.training import train as trainer
from ssd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from ssd_tpu_torch.training.schedules import build_optimizer
from ssd_tpu_torch.utils.config import load_config

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
    from concurrent.futures import ThreadPoolExecutor

    libs = {"logmel.cu": feat.LOGMEL.library, "ctc.cu": ctc.CTC_ALPHA.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, together
        list(pool.map(lambda lib: lib.load(), libs.values()))
    print(f"[build] {len(libs)} kernel sources ready in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        how = f"nvcc {lib.build_seconds:.2f} s" if lib.build_log else "reused the built library"
        print(f"[build] {name}: {how} ({lib.library_path().name})")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas {name}: {line.strip()}")
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


# ------------------------------------------------------- training phases

# configs/tpu_fast_plus.yaml, inlined as JSON (no yaml on the card); the
# data paths are filled in by make_corpus
TRAIN_CONFIG = {
    "data": {"train_splits": ["voiced_parallel_data"], "val_splits": ["voiced_parallel_data"],
             "train_subsets": ["train"], "val_subsets": ["val"]},
    "features": {**FEATURES, "teacher": {"model_name": "microsoft/wavlm-base-plus", "layer": 9,
                                         "sample_rate": 16000, "dim": 768}},
    "model": MODEL,
    "loss": {"lambda_distill": 0.35, "lambda_ctc": 0.65, "distill_warmup_epochs": 2},
    "optim": {"batch_size": 5, "grad_accum": 1, "lr": 3e-4, "weight_decay": 1e-2,
              "max_epochs": 50, "clip_grad_norm": 5.0, "num_workers": 4, "prefetch_factor": 2,
              "pin_memory": True, "scheduler": {"name": "warmup_hold", "warmup_steps": 800},
              "early_stopping": {"patience": 5, "min_delta": 0.0}},
    "augmentation": {"specaugment": {"time_masks": 2, "time_mask_width": 0.05, "freq_masks": 2,
                                     "freq_mask_width": 8, "p": 0.3}},
    "decoding": DECODING,
    "logging": {"seed": 42, "run_name": "tpu_fast_plus", "log_interval": 10},
    "parallel": {"data": "auto", "model": 1},
}
TEACHER_DIM = 768
LAMBDAS = (0.65, 0.35)
BLANK = 1  # default_vocab's blank id
CTC_SHAPES = {"config": (5, 640, 160), "flagship": (32, 384, 128)}  # (B, T', S)
CTC_REC_RTOL = 1e-5  # α / β where finite, and the per-sample loss
CTC_GRAD_ATOL = 1e-5  # logits gradients, kernels vs plain
# against float64 F.ctc_loss: values as tests/test_ctc_loss.py holds the JAX
# loss to torch's; gradients rtol 1e-3 and an atol of 8 fp32 ulps of the
# largest |log-likelihood|, because the posterior exp(α + β − ll) takes the
# rounding of log values that large (at T' = 640 |ll| reaches ~4 600: the
# JAX loss is 2.9e-3 off float64 there, bit for bit like the port, and
# fp32 F.ctc_loss 4.0e-3 — CPU runs of the same inputs)
TORCH_CTC_TOL = dict(rtol=1e-4, atol=1e-4)
TORCH_CTC_GRAD_RTOL, TORCH_CTC_GRAD_ULPS = 1e-3, 8
CTC_OPS_PER_STATE = 12  # per state and step: 10 flops + 2 transcendentals (the Pallas cost estimate)
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, fp32 both, TF32 off
TRAIN_GRAD_REL = 1e-3  # max abs err ≤ this × the tensor's max-abs gradient, or …
TRAIN_GRAD_FLOOR = 1e-6  # … this: the attention key bias and the depthwise-conv bias
# have a true gradient of 0 (softmax shift / batch-mean invariance), so both
# devices return rounding noise for them
TRAIN_STAT_ATOL = 1e-5


def reset_counts() -> None:
    feat.LOGMEL.launches = ctc.CTC_ALPHA.launches = ctc.CTC_BETA.launches = 0


def counts() -> dict:
    return {"logmel": feat.LOGMEL.launches, "ctc_alpha": ctc.CTC_ALPHA.launches,
            "ctc_beta": ctc.CTC_BETA.launches}


@contextlib.contextmanager
def plain_recursions():
    """Route the loss's α / β through the plain versions (the reference run
    on the card); the main path never does this."""
    fa, fb = ctc.forward_alphas, ctc.betas
    ctc.forward_alphas, ctc.betas = ctc.forward_alphas_plain, ctc.betas_plain
    try:
        yield
    finally:
        ctc.forward_alphas, ctc.betas = fa, fb


def ctc_case(rng: np.random.Generator, B: int, T: int, S: int):
    """Logits and targets at (B, T, S): random lengths, plus an empty
    target, an impossible row and a row of one repeated label."""
    logits = rng.normal(size=(B, T, 48)).astype(np.float32) * 3
    ll = rng.integers(T // 2, T + 1, size=B)
    tl = rng.integers(S // 2, S + 1, size=B)
    tg = rng.integers(3, 48, size=(B, S))
    ll[0] = T
    tl[1] = 0
    ll[2], tl[2] = S // 2, S  # fewer frames than labels
    ll[3], tg[3, :] = T, 7
    dev = torch.device("cuda")
    return (torch.from_numpy(logits).to(dev), torch.from_numpy(ll.astype(np.int32)).to(dev),
            torch.from_numpy(tg.astype(np.int32)).to(dev), torch.from_numpy(tl.astype(np.int32)).to(dev))


def loss_and_grad(logits, ll, tg, tl):
    x = logits.detach().requires_grad_(True)
    loss = ctc.ctc_loss(torch.log_softmax(x, -1), ll, tg, tl, BLANK)
    loss.sum().backward()
    return loss.detach(), x.grad


def finite_close(got: torch.Tensor, want: torch.Tensor, rtol: float):
    """(max abs err, ok) over the states the reference holds finite."""
    fin = want > -1e29
    if not torch.equal(got > -1e29, fin):
        return float("inf"), False
    err = (got - want).abs()[fin]
    return float(err.max()), bool((err <= rtol * want.abs()[fin] + 1e-6).all())


def phase_ctc(rng: np.random.Generator) -> dict:
    entries, times = {}, {}
    for label, (B, T, S) in CTC_SHAPES.items():
        logits, ll, tg, tl = ctc_case(rng, B, T, S)
        lp = torch.log_softmax(logits, -1)
        ext, skip = ctc._topology(tg, BLANK)
        lp_ext = ctc._emissions(lp, ext)
        S2 = ext.shape[1]
        skipf = skip.float()
        bfinal = ctc._final_states(tl, S2)
        skip_from = F.pad(skip[:, 2:], (0, 2), value=False)
        skip_from_f, ll32 = skip_from.float(), ll.to(torch.int32)
        a_err, a_ok = finite_close(ctc.CTC_ALPHA(lp_ext, skipf), ctc.forward_alphas_plain(lp_ext, skip),
                                   CTC_REC_RTOL)
        b_err, b_ok = finite_close(ctc.CTC_BETA(lp_ext, skip_from_f, bfinal, ll32),
                                   ctc.betas_plain(lp_ext, ll, bfinal, skip_from), CTC_REC_RTOL)
        check(a_ok, f"α kernel vs plain at {label}: max abs err {a_err}")
        check(b_ok, f"β kernel vs plain at {label}: max abs err {b_err}")
        loss, grad = loss_and_grad(logits, ll, tg, tl)
        with plain_recursions():
            loss_p, grad_p = loss_and_grad(logits, ll, tg, tl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss).all() and torch.isfinite(grad).all()), f"non-finite CTC at {label}")
        check(float(loss[2]) == 0.0 and bool((grad[2] == 0).all()), f"impossible row not zeroed at {label}")
        check(close(loss, loss_p, atol=1e-6, rtol=CTC_REC_RTOL),
              f"loss kernels vs plain at {label}: {float((loss - loss_p).abs().max())}")
        g_err = float((grad - grad_p).abs().max())
        check(g_err <= CTC_GRAD_ATOL, f"logits grads kernels vs plain at {label}: {g_err}")
        # F.ctc_loss in float64 is the judge; the fp32 run's own gradient
        # error against it is printed beside
        ref = {}
        for dtype in (torch.float64, torch.float32):
            xt = logits.detach().to(dtype).requires_grad_(True)
            want = F.ctc_loss(torch.log_softmax(xt, -1).transpose(0, 1), tg.long(), ll.long(),
                              tl.long(), blank=BLANK, reduction="none", zero_infinity=True)
            want.sum().backward()
            ref[dtype] = (want.detach().float(), xt.grad.float())
        want, want_grad = ref[torch.float64]
        t_err, tg_err = float((loss - want).abs().max()), float((grad - want_grad).abs().max())
        lib_err = float((ref[torch.float32][1] - want_grad).abs().max())
        check(close(loss, want, **TORCH_CTC_TOL), f"loss vs F.ctc_loss (f64) at {label}: {t_err}")
        grad_atol = max(1e-4, TORCH_CTC_GRAD_ULPS * 2.0**-23 * float(want.abs().max()))
        check(close(grad, want_grad, atol=grad_atol, rtol=TORCH_CTC_GRAD_RTOL),
              f"grads vs F.ctc_loss (f64) at {label}: {tg_err} > atol {grad_atol}")

        lp_t = lp.transpose(0, 1).contiguous()

        def torch_fwd_bwd():
            x = lp_t.detach().requires_grad_(True)
            F.ctc_loss(x, tg, ll, tl, blank=BLANK, reduction="none", zero_infinity=True).sum().backward()

        def port_fwd_bwd():
            x = lp.detach().requires_grad_(True)
            ctc.ctc_loss(x, ll, tg, tl, BLANK).sum().backward()

        t = {
            "alpha": cuda_ms(lambda: ctc.CTC_ALPHA(lp_ext, skipf)),
            "beta": cuda_ms(lambda: ctc.CTC_BETA(lp_ext, skip_from_f, bfinal, ll32)),
            "alpha_plain": cuda_ms(lambda: ctc.forward_alphas_plain(lp_ext, skip), iters=3, warmup=1),
            "beta_plain": cuda_ms(lambda: ctc.betas_plain(lp_ext, ll, bfinal, skip_from), iters=3, warmup=1),
            "torch_fwd": cuda_ms(lambda: F.ctc_loss(lp_t, tg, ll, tl, blank=BLANK, reduction="none",
                                                    zero_infinity=True)),
            "torch_fwd_bwd": cuda_ms(torch_fwd_bwd),
            "port_fwd": cuda_ms(lambda: ctc.ctc_loss(lp, ll, tg, tl, BLANK)),
            "port_fwd_bwd": cuda_ms(port_fwd_bwd),
        }
        times[label] = t
        n = T * B * S2
        for name, err, extra in (("alpha", a_err, 4 * B * S2), ("beta", b_err, 8 * B * S2 + 4 * B)):
            nbytes = 4 * 2 * n + extra
            t_ops, t_bytes = CTC_OPS_PER_STATE * n / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            ms = t[name]
            print(f"[ctc] {label} B={B} T'={T} S={S} (S2={S2}) {name}: max_abs_err {err:.3e} "
                  f"(rtol {CTC_REC_RTOL} where finite); kernel {ms:.4f} ms, plain {t[name + '_plain']:.4f} ms, "
                  f"bound {bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
                  f"{nbytes / 1e6:.3f} MB), {nbytes / ms / 1e6:.2f} GB/s achieved")
            if label == "config":
                entries[name] = {
                    "name": f"ctc_{name}", "route": "cuda", "source": "ssd_tpu_torch/csrc/ctc.cu",
                    "replaces": "ssd_tpu/ops/ctc_loss.py:159" if name == "alpha"
                    else "ssd_tpu/ops/ctc_loss.py:211",
                    "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": t[name + "_plain"],
                    "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": t["torch_fwd"] if name == "alpha" else t["torch_fwd_bwd"],
                }
        print(f"[ctc] {label}: loss vs plain {float((loss - loss_p).abs().max()):.3e}, logits grads vs "
              f"plain {g_err:.3e} (atol {CTC_GRAD_ATOL}); vs float64 F.ctc_loss loss {t_err:.3e}, grads "
              f"{tg_err:.3e} (atol {grad_atol:.3e}; fp32 F.ctc_loss's grads: {lib_err:.3e}); whole loss fwd {t['port_fwd']:.4f} ms / fwd+bwd {t['port_fwd_bwd']:.4f} ms, "
              f"F.ctc_loss fwd {t['torch_fwd']:.4f} ms / fwd+bwd {t['torch_fwd_bwd']:.4f} ms")
    return {"entries": entries, "times": times}


def make_corpus(root: Path, rng: np.random.Generator) -> Path:
    """20 voiced utterances (16 train, 4 val) → features, teacher, JSONL
    index, vocab and a JSON config; returns the config's path."""
    vocab_path = root / "vocab.json"
    default_vocab().to_json(vocab_path)
    fcfg = feat.FeaturizerConfig(**FEATURES["emg"])
    chars = list("abcdefghijklmnopqrstuvwxyz") + [" "] * 6 + list("',.?")
    rows = []
    for i in range(20):
        uid = f"voiced_parallel_data/s1/{i}_0"
        n = int(rng.integers(4000, 12001))
        raw = rng.normal(size=(n, CHANNELS)).astype(np.float32)
        raw_path = root / "raw" / f"{i}_0_emg.npy"
        raw_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(raw_path, raw)
        feats, n_frames, _, _ = feat.logmel_batch(
            torch.from_numpy(raw[None]).cuda(), torch.tensor([n], device="cuda"), fcfg)
        for kind, arr in (("emg", feats[0, : int(n_frames[0])].cpu().numpy()),
                          ("teacher", rng.normal(size=(n // 20, TEACHER_DIM)).astype(np.float32))):
            path = root / "features" / kind / f"{uid}.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, arr)
        text = "".join(rng.choice(chars, size=int(rng.integers(30, 151))))
        rows.append(dict(utterance_id=uid, split="voiced_parallel_data",
                         subset="train" if i < 16 else "val", speaker="s1", stem=f"{i}_0",
                         emg_path=str(raw_path), audio_path=None, transcript=text,
                         sentence_index=i, book="", has_audio=False, metadata_json="{}"))
    save_index(rows, root / "index.jsonl")
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["data"].update(index=str(root / "index.jsonl"), features_root=str(root / "features"),
                       vocab=str(vocab_path))
    path = root / "config.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def check_epoch(h: dict, what: str) -> tuple:
    for part in ("train", "val"):
        for k in ("total", "ctc", "distill"):
            check(np.isfinite(h[part][k]), f"{what}: {part} {k} loss {h[part][k]} not finite")
    return h["train"]["batches"], h["val"]["batches"]


def phase_train(root: Path, rng: np.random.Generator) -> dict:
    base = load_config(make_corpus(root, rng))
    total = {"logmel": 0, "ctc_alpha": 0, "ctc_beta": 0}
    for mode in ("cached", "raw"):
        cfg = copy.deepcopy(base)
        cfg["data"]["train_from_raw"] = mode == "raw"
        cfg["optim"]["max_epochs"] = 1
        t0 = time.perf_counter()
        reset_counts()
        summary = trainer.train_from_config(cfg, root / f"run_{mode}", overfit_batches=2, device="cuda")
        c = counts()
        check(len(summary["history"]) == 1, f"{mode}: {len(summary['history'])} epochs ran")
        n_train, n_eval = check_epoch(summary["history"][0], mode)
        check(n_train == 2 and n_eval == 2, f"{mode}: {n_train} train / {n_eval} eval steps")
        check(c["ctc_alpha"] == n_train + n_eval, f"{mode}: α launched {c['ctc_alpha']} times")
        check(c["ctc_beta"] == n_train, f"{mode}: β launched {c['ctc_beta']} times")
        check(c["logmel"] == (n_train + n_eval if mode == "raw" else 0),
              f"{mode}: log-mel launched {c['logmel']} times")
        for d in ("last", "best"):
            check((root / f"run_{mode}" / d / "model.pt").exists(), f"{mode}: no {d}/ checkpoint")
        for k in total:
            total[k] += c[k]
        h = summary["history"][0]
        print(f"[train] {mode}: 1 epoch, {n_train} train + {n_eval} eval steps in "
              f"{time.perf_counter() - t0:.2f} s; train total {h['train']['total']:.4f} "
              f"(ctc {h['train']['ctc']:.4f}, distill {h['train']['distill']:.4f}), val total "
              f"{h['val']['total']:.4f}; launches {c}")

    run = root / "run_cached"
    before = load_checkpoint(run / "last")
    cfg = copy.deepcopy(base)
    cfg["optim"]["max_epochs"] = 2
    reset_counts()
    summary = trainer.train_from_config(cfg, run, overfit_batches=2, resume=True, device="cuda")
    c = counts()
    check([h["epoch"] for h in summary["history"]] == [2], f"resume ran epochs {summary['history']}")
    n_train, n_eval = check_epoch(summary["history"][0], "resume")
    after = load_checkpoint(run / "last")
    check(after["epoch"] == 2 and after["step"] == before["step"] + n_train
          and after["optimizer"]["update_count"] == before["optimizer"]["update_count"] + n_train,
          f"resume: epoch {after['epoch']} step {after['step']} (before {before['step']})")
    check(c["ctc_alpha"] == n_train + n_eval and c["ctc_beta"] == n_train, f"resume launches {c}")
    for k in total:
        total[k] += c[k]
    print(f"[train] resumed at epoch 2 from step {before['step']} → {after['step']}; "
          f"val total {summary['history'][0]['val']['total']:.4f}; launches {c}")

    engine = InferenceEngine.from_checkpoint(run / "last", device="cuda")
    hyps = engine.transcribe(requests(rng, 2))
    check(len(hyps) == 2 and all(isinstance(h, str) for h in hyps), f"served {hyps}")
    print(f"[train] trained checkpoint served: {[h[:30] for h in hyps]}; training launches {total}")
    return total


def train_batch(rng: np.random.Generator, B: int, frames: int, S: int) -> dict:
    """A cached-feature batch at the loader's bucketed shapes."""
    lengths = rng.integers(int(frames * 0.6), frames + 1, size=B)
    lengths[0] = frames
    emg = rng.normal(size=(B, frames, MODEL["encoder"]["input_dim"])).astype(np.float32)
    tok_len = rng.integers(S // 2, S + 1, size=B)
    tokens = np.zeros((B, S), np.int32)
    for i in range(B):
        emg[i, lengths[i]:] = 0.0
        tokens[i, : tok_len[i]] = rng.integers(3, 48, size=tok_len[i])
    return {"emg": emg, "emg_lengths": lengths.astype(np.int32), "tokens": tokens,
            "token_lengths": tok_len.astype(np.int32), "weight": np.ones(B, np.float32),
            "teacher": rng.normal(size=(B, frames // 2, TEACHER_DIM)).astype(np.float32),
            "teacher_lengths": (lengths // 2).astype(np.int32)}


def model_cfg(dropout: float) -> dict:
    m = copy.deepcopy(MODEL)
    m["encoder"]["dropout"] = m["ctc_dropout"] = dropout
    return {"model": m}


def phase_train_parity(rng: np.random.Generator) -> None:
    cfg = model_cfg(0.0)
    cpu_model = build_model(cfg, input_dim=MODEL["encoder"]["input_dim"], vocab_size=48)
    init_flax_style(cpu_model, torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    batch = train_batch(rng, 5, 1280, 160)
    out = {}
    for name, model, dev in (("card", gpu_model, torch.device("cuda")), ("cpu", cpu_model, torch.device("cpu"))):
        t0 = time.perf_counter()
        total, losses = trainer._losses(model, trainer.to_device(batch, dev), LAMBDAS, BLANK, False, True, None)
        total.backward()
        out[name] = {k: float(v.detach()) for k, v in losses.items()}
        print(f"[parity-train] {name}: one full-width step at B=5, 1280 frames in "
              f"{time.perf_counter() - t0:.2f} s (host clock, first call)")
    for k in ("total", "ctc", "distill"):
        check(abs(out["card"][k] - out["cpu"][k]) <= TRAIN_LOSS_RTOL * abs(out["cpu"][k]),
              f"{k} loss card {out['card'][k]} vs CPU {out['cpu'][k]}")
    worst = (0.0, "")
    gpu_params = dict(gpu_model.named_parameters())
    for name, p in cpu_model.named_parameters():
        g_cpu, g_gpu = p.grad, gpu_params[name].grad.cpu()
        err = float((g_gpu - g_cpu).abs().max())
        bound = max(TRAIN_GRAD_REL * float(g_cpu.abs().max()), TRAIN_GRAD_FLOOR)
        check(err <= bound, f"grad {name}: card vs CPU max abs err {err} > {bound}")
        if bound > TRAIN_GRAD_FLOOR:  # the tensors held to the relative limit
            worst = max(worst, (err / float(g_cpu.abs().max()), name))
    gpu_bufs = dict(gpu_model.named_buffers())
    stat_err = max(float((gpu_bufs[n].cpu() - b).abs().max()) for n, b in cpu_model.named_buffers())
    check(stat_err <= TRAIN_STAT_ATOL, f"batch stats card vs CPU max abs err {stat_err}")
    print(f"[parity-train] losses card {out['card']} vs CPU {out['cpu']} (rtol {TRAIN_LOSS_RTOL}); "
          f"worst gradient error {worst[0]:.3e} of the tensor's max ({worst[1]}; limit "
          f"{TRAIN_GRAD_REL}); batch stats max abs err {stat_err:.3e} (atol {TRAIN_STAT_ATOL})")

    overfit = {"optim": {"lr": 1e-3, "weight_decay": 1e-2, "clip_grad_norm": 5.0}}
    model = build_model(cfg, input_dim=MODEL["encoder"]["input_dim"], vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    model.cuda()
    opt, _ = build_optimizer(overfit, model.parameters(), 20)
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(BLANK, False)
    dbatch = trainer.to_device(batch, torch.device("cuda"))
    totals = [float(step(state, dbatch, LAMBDAS, None)[1]["total"]) for _ in range(20)]
    check(all(np.isfinite(totals)) and totals[-1] < totals[0], f"overfit totals {totals}")
    print(f"[parity-train] 20 steps at lr 1e-3 on one batch: total {totals[0]:.4f} → {totals[-1]:.4f}")


def profile_step(step, step_ms: float, label: str, top: int = 6) -> None:
    """Device time by kernel over one train step (``torch.profiler``), and
    the device's busy share of the unprofiled p50 step."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first profiled run pays the tracer's start-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[rate] {label} profiler: device busy {dev_ms:.3f} ms = {100 * dev_ms / step_ms:.1f} % of "
          f"the p50 step; {sum(e.count for e in events)} device events; largest:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[rate]   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:80]}")


def phase_train_rate(rng: np.random.Generator, ctc_times: dict) -> None:
    for label, (B, frames, S) in (("config", (5, 1280, 160)), ("flagship", (32, 768, 128))):
        model = build_model(model_cfg(MODEL["encoder"]["dropout"]),
                            input_dim=MODEL["encoder"]["input_dim"], vocab_size=48)
        init_flax_style(model, torch.Generator().manual_seed(SEED))
        model.cuda()
        opt, _ = build_optimizer(TRAIN_CONFIG, model.parameters(), 1000)
        batch = trainer.to_device(train_batch(rng, B, frames, S), torch.device("cuda"))
        gen = torch.Generator("cuda").manual_seed(SEED + 1)

        def timed_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            total, _ = trainer._losses(model, batch, LAMBDAS, BLANK, False, True, gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            total.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            return t1 - t0, t2 - t1, time.perf_counter() - t2

        for _ in range(3):
            timed_step()
        split = np.asarray([timed_step() for _ in range(10)]) * 1e3
        step_ms = float(np.percentile(split.sum(axis=1), 50))
        fwd, bwd, upd = (float(np.percentile(split[:, i], 50)) for i in range(3))
        t = ctc_times[label]
        share = (t["alpha"] + t["beta"]) / step_ms
        print(f"[rate] {label} B={B} {frames} frames (T'={frames // 2}, S={S}): step p50 {step_ms:.3f} ms "
              f"(forward + loss {fwd:.3f}, backward {bwd:.3f}, optimizer {upd:.3f}; 10 warm steps, "
              f"host clock with a sync around each part) = {B / step_ms * 1e3:.2f} utterances/s; "
              f"CTC kernels α {t['alpha']:.4f} + β {t['beta']:.4f} ms = {share * 100:.2f} % of the step "
              f"(CUDA events, same shapes); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_step(timed_step, step_ms, label)
        del model, opt, batch
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    rng = np.random.default_rng(SEED)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[time] {name}: {seconds[name]:.2f} s")
        return out

    card = timed("build", phase_build)
    entry = timed("kernel", phase_kernel, rng)
    run_dir = Path(tempfile.mkdtemp(prefix="ssd_chip_smoke_"))
    try:
        ckpt = build_run_dir(run_dir)
        reset_counts()
        engines, batches, launches = timed("engine+server", phase_main_path, ckpt, rng)
        entry["launches"] = launches
        timed("parity", phase_parity, ckpt, engines, batches)
        timed("latency", phase_latency, engines, rng)
        del engines
        ctc_out = timed("ctc kernels", phase_ctc, rng)
        train_dir = run_dir / "train"
        train_dir.mkdir()
        train_counts = timed("train", phase_train, train_dir, rng)
        timed("train parity", phase_train_parity, rng)
        timed("train rate", phase_train_rate, rng, ctc_out["times"])
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    kernels = [entry]
    for name in ("alpha", "beta"):
        e = ctc_out["entries"][name]
        e["launches"] = train_counts[f"ctc_{name}"]
        kernels.append(e)
    print(f"[time] total {sum(seconds.values()):.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
