"""Evaluation CLI: load a checkpoint, decode, compute WER / CER (PyTorch
port of ``ssd_tpu/evaluation/evaluate.py``).

  python -m ssd_tpu_torch.evaluation.evaluate --checkpoint results/checkpoints/run/best \\
      --decoder beam --beam-width 50 [--lm-path LM.arpa [--lm-backend device|host]] \\
      [--splits …] [--subsets …] [--device cuda|cpu]

Same surface as the JAX CLI:

* the config comes from the ``config.json`` stored next to the checkpoint;
* knob precedence: CLI > the checkpoint config's ``decoding`` block >
  defaults (greedy: width 0 / α 0; beam: width 50 / α 0.6 / β 0 / prune −10);
* artifacts: ``metrics.json`` (wer / cer, the error breakdown, decode-latency
  percentiles, and the ``decoder``, ``data`` and ``run_name`` blocks),
  ``predictions.jsonl`` and ``config_used.json``, in ``--output`` or
  ``results/eval/<run_name>``; every option string of the JAX CLI parses.

The forward runs on the card unless ``--device cpu`` is given: the
Conformer, and in ``data.train_from_raw`` mode the CUDA log-mel kernel; with
``attention_impl: fused`` / ``depthwise_impl: pallas`` the attention and
depthwise CUDA kernels. Decoding runs on the same device
(:mod:`ssd_tpu_torch.decoding.ctc`); ``--lm-path`` (or the config's
``decoding.lm_path``) fuses an ARPA LM into the beam, on the device or, with
``--lm-backend host``, in the host search; a path that does not exist is
logged and the beam decodes without it. ``--quantize int8|int8_prequant``
(or a checkpoint's ``encoder.quantize``) evaluates the int8 forward
(``ops/quant.py``). A missing card raises. ``--data-parallel`` replicates
the model on every visible card and splits each batch's rows across them
(``parallel/replicas.py``; pad rows a valid length, their results cut off);
with one card it warns and runs on it, as the JAX CLI does.
``--compile-cache DIR`` (else ``$SSD_COMPILE_CACHE``, else
``ssd_tpu_torch/_build/``) is where the CUDA kernels and the host library
are built, so a re-run reuses them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ssd_tpu_torch.data.dataset import make_dataloader, prefetch
from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.decoding.ctc import build_decoder
from ssd_tpu_torch.evaluation.metrics import compute_error_breakdown, compute_metrics
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig, logmel_batch
from ssd_tpu_torch.ops.quant import maybe_prequantize
from ssd_tpu_torch.parallel.replicas import data_parallel_replicas
from ssd_tpu_torch.training.checkpoint import load_checkpoint, load_config_for
from ssd_tpu_torch.utils.cuda_build import enable_compile_cache
from ssd_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def make_forward(model, featurize_cfg: Optional[FeaturizerConfig] = None):
    """Eval forward ``(emg, lengths) → (log_probs, out_lengths)`` on the
    model's device; ``featurize_cfg`` adds the log-mel featurizer so raw
    (samples, channels) batches evaluate (``data.train_from_raw``)."""

    @torch.inference_mode()
    def forward(emg: torch.Tensor, lengths: torch.Tensor):
        if featurize_cfg is not None:
            feats, lengths, _, _ = logmel_batch(emg, lengths, featurize_cfg)
            B, T, C, M = feats.shape
            emg = feats.reshape(B, T, C * M)
        return model.ctc_log_probs(emg, lengths)

    return forward


def evaluate_checkpoint(
    ckpt_path: Path,
    cfg: Dict[str, Any],
    vocab: Vocab,
    splits,
    subsets,
    decoder_fn,
    batch_size: int = 4,
    index_path: Optional[Path] = None,
    features_root: Optional[Path] = None,
    data_parallel: bool = False,
    device: str | torch.device = "cuda",
    devices: Optional[List[str | torch.device]] = None,
) -> Dict[str, Any]:
    """Decode the eval set; returns ``{"metrics", "records"}``, the metrics
    with ``decode_latency_sec`` (p50 / p90 / mean seconds an utterance of
    ``decoder_fn``, timed after the forward has finished on the device).

    Checkpoints trained with ``data.train_from_raw`` evaluate from the raw
    signals: the loader runs in raw mode and the forward featurizes on the
    device with the config's ``features.emg`` block, as the trainer did.

    ``data_parallel`` splits each batch's rows over a replica a device
    (``devices``, default every visible card).
    """
    dev = resolve_device(device)
    data_cfg = cfg["data"]
    index_path = index_path or Path(data_cfg["index"])
    features_root = features_root or Path(data_cfg["features_root"])
    train_from_raw = bool(data_cfg.get("train_from_raw", False))
    feat_cfg = FeaturizerConfig.from_config(cfg) if train_from_raw else None

    loader = make_dataloader(
        index_path=index_path,
        features_root=features_root,
        splits=splits,
        subsets=subsets,
        vocab=vocab,
        batch_size=batch_size,
        shuffle=False,
        include_teacher=False,
        raw=train_from_raw,
        raw_hop_length=(feat_cfg.hop_length if feat_cfg else 10),
    )
    if len(loader) == 0:
        raise ValueError(
            f"No samples for splits {splits} subsets {subsets}. Voiced uses "
            "train/val/test; silent uses the same MD5 subsets."
        )

    # input_dim: config if present, else probe the first item
    enc_cfg = cfg["model"]["encoder"]
    input_dim = enc_cfg.get("input_dim")
    if input_dim is None:
        input_dim = loader.dataset.get(0)["emg"].shape[1]
        if train_from_raw:
            input_dim *= feat_cfg.n_mels
        enc_cfg["input_dim"] = int(input_dim)

    model = build_model(cfg, input_dim=int(input_dim), vocab_size=vocab.size)
    # int8_prequant: the eligible weights converted once, at load
    model.load_state_dict(maybe_prequantize(load_checkpoint(ckpt_path)["state_dict"],
                                            model.encoder_cfg))
    model = model.to(dev).eval()
    forward = make_forward(model, featurize_cfg=feat_cfg)
    replicas = (data_parallel_replicas(model, dev, devices, "--data-parallel")
                if data_parallel else None)
    # pad rows of the split: one STFT window of zeros in raw mode, a few
    # zero frames otherwise (an all-masked attention row is NaN)
    pad_length = feat_cfg.n_fft if feat_cfg is not None else 8

    refs: List[str] = []
    hyps: List[str] = []
    records: List[Dict] = []
    decode_latencies: List[float] = []
    with contextlib.closing(prefetch(loader)) as batches:
        for batch in batches:
            emg = torch.from_numpy(np.ascontiguousarray(batch.emg)).to(dev)
            lengths = torch.from_numpy(batch.emg_lengths).to(dev)
            if replicas is not None:
                log_probs, out_lengths = replicas.split(
                    lambda m, e, n: make_forward(m, featurize_cfg=feat_cfg)(e, n),
                    emg, lengths, pad_length)
            else:
                log_probs, out_lengths = forward(emg, lengths)
            if dev.type == "cuda":
                # the forward runs asynchronously: the decode clock starts after it
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            batch_hyps = decoder_fn(log_probs, out_lengths)
            decode_latencies.append((time.perf_counter() - t0) / batch.size)
            for uid, ref, hyp in zip(batch.utterance_ids, batch.transcripts, batch_hyps):
                refs.append(ref)
                hyps.append(hyp)
                records.append({"utterance_id": uid, "ref": ref, "hyp": hyp})

    metrics: Dict[str, Any] = compute_metrics(refs, hyps)
    metrics["error_breakdown"] = compute_error_breakdown(refs, hyps)
    lat = np.asarray(decode_latencies)
    metrics["decode_latency_sec"] = {
        "p50": float(np.percentile(lat, 50)),
        "p90": float(np.percentile(lat, 90)),
        "mean": float(lat.mean()),
    }
    return {"metrics": metrics, "records": records}


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's options; ``--device`` also takes ``cuda`` / ``cuda:N``."""
    p = argparse.ArgumentParser(description="Evaluate a trained checkpoint (PyTorch port).")
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--index", type=Path)
    p.add_argument("--features-root", type=Path)
    p.add_argument("--splits", nargs="+", default=None)
    p.add_argument("--subsets", nargs="+", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument(
        "--device",
        default="cuda",
        help="cuda (default; raises without a card), cuda:N or cpu; tpu, the JAX "
        "CLI's word for the attached accelerator, means the card.",
    )
    p.add_argument("--output", type=Path)
    p.add_argument("--run-name", type=str)
    p.add_argument("--decoder", choices=["greedy", "beam"], default=None)
    p.add_argument("--lm-path", type=Path, help="ARPA LM for beam-search fusion.")
    p.add_argument("--beam-width", type=int)
    p.add_argument("--alpha", type=float)
    p.add_argument("--beta", type=float)
    p.add_argument("--beam-prune-logp", type=float)
    p.add_argument("--blank-bias", type=float, default=0.0)
    p.add_argument(
        "--token-top-k",
        type=int,
        help="Per-frame candidate preselection for the beam search (exact when "
        "≤k tokens pass token_min_logp; 0/unset = exact sort).",
    )
    p.add_argument(
        "--compile-cache", type=Path, default=None,
        help="Build the CUDA kernels and the host library into this directory and reuse "
        "what was built there before (default: $SSD_COMPILE_CACHE, else "
        "ssd_tpu_torch/_build/).",
    )
    p.add_argument(
        "--quantize",
        choices=["none", "int8", "int8_prequant"],
        help="Inference-time dense quantization (ops/quant.py): int8 quantizes the FFN "
        "and pointwise products on the fly, int8_prequant converts their weights once. "
        "Default: the checkpoint config's encoder.quantize.",
    )
    p.add_argument(
        "--lm-backend", choices=["device", "host"], default="device",
        help="LM-fused decoding backend: the search on the log-probs' device (default) "
        "or the host prefix search, the oracle.",
    )
    p.add_argument(
        "--data-parallel", action="store_true",
        help="Replicate the model on every visible card and split each batch's rows "
        "across them (one card: a warning, then one device).",
    )
    return p


def main(argv: Optional[List[str]] = None) -> None:
    from ssd_tpu_torch.utils.config import setup_cli_logging

    setup_cli_logging()
    args = build_parser().parse_args(argv)
    device = resolve_device("cuda" if args.device == "tpu" else args.device)
    enable_compile_cache(args.compile_cache)
    ckpt_path = args.checkpoint
    cfg = load_config_for(ckpt_path)
    if args.quantize is not None:
        cfg["model"]["encoder"]["quantize"] = args.quantize
    data_cfg = cfg["data"]

    splits = args.splits or data_cfg.get("val_splits", ["voiced_parallel_data"])
    default_subsets = data_cfg.get("eval_subsets") or data_cfg.get("val_subsets") or ["val"]
    subsets = args.subsets if args.subsets is not None else default_subsets

    vocab = Vocab.from_json(Path(data_cfg["vocab"]))

    decoding_cfg = cfg.get("decoding", {}) or {}
    decoder_type = args.decoder or decoding_cfg.get("type", "greedy")
    lm_path = args.lm_path or decoding_cfg.get("lm_path")
    beam_width = args.beam_width if args.beam_width is not None else decoding_cfg.get("beam_width")
    if beam_width is None:
        beam_width = 0 if decoder_type == "greedy" else 50
    alpha = args.alpha if args.alpha is not None else decoding_cfg.get("alpha")
    beta = args.beta if args.beta is not None else decoding_cfg.get("beta")
    if alpha is None:
        alpha = 0.0 if decoder_type == "greedy" else 0.6
    if beta is None:
        beta = 0.0
    prune = (
        args.beam_prune_logp
        if args.beam_prune_logp is not None
        else decoding_cfg.get("beam_prune_logp")
    )
    if prune is None:
        prune = -10.0
    blank_bias = float(args.blank_bias)
    token_top_k = (
        args.token_top_k if args.token_top_k is not None else decoding_cfg.get("token_top_k")
    )
    token_top_k = int(token_top_k) if token_top_k else None

    decoder_fn = build_decoder(
        method=decoder_type,
        vocab=vocab,
        lm_path=Path(lm_path) if lm_path else None,
        beam_width=int(beam_width),
        alpha=float(alpha),
        beta=float(beta),
        beam_prune_logp=float(prune),
        blank_bias=blank_bias,
        token_top_k=token_top_k,
        host_lm=args.lm_backend == "host",
    )
    logger.info(
        "Decoder: %s | LM: %s | width %s | α %.2f β %.2f | prune %.1f | blank_bias %.2f | top_k %s"
        " | device %s",
        decoder_type, lm_path or "none", beam_width, alpha, beta, prune, blank_bias,
        token_top_k or "exact", device,
    )

    out = evaluate_checkpoint(
        ckpt_path,
        cfg,
        vocab,
        splits,
        subsets,
        decoder_fn,
        batch_size=args.batch_size,
        index_path=args.index,
        features_root=args.features_root,
        data_parallel=args.data_parallel,
        device=device,
    )
    metrics, records = out["metrics"], out["records"]
    metrics["decoder"] = {
        "type": decoder_type,
        "beam_width": beam_width if decoder_type == "beam" else None,
        "alpha": alpha if decoder_type == "beam" else None,
        "beta": beta if decoder_type == "beam" else None,
        "beam_prune_logp": prune if decoder_type == "beam" else None,
        "blank_bias": blank_bias,
        "token_top_k": token_top_k if decoder_type == "beam" else None,
        "lm_path": str(lm_path) if lm_path else None,
    }
    metrics["data"] = {
        "splits": list(splits),
        "subsets": list(subsets) if subsets else None,
        "num_samples": len(records),
    }
    run_name = args.run_name or cfg.get("logging", {}).get("run_name", "eval_run")
    metrics["run_name"] = run_name
    out_dir = args.output or Path("results/eval") / run_name
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config_used.json").write_text(json.dumps(cfg, indent=2))
    (out_dir / "metrics.json").write_text(json.dumps(metrics, indent=2))
    with (out_dir / "predictions.jsonl").open("w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    logger.info("WER %.4f | CER %.4f | outputs: %s", metrics["wer"], metrics["cer"], out_dir)


if __name__ == "__main__":
    main()
