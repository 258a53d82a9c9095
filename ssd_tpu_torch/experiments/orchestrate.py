"""Two-stage experiment orchestrator (probes → full runs), the port's copy
of ``ssd_tpu/experiments/orchestrate.py``.

Stage-1 voiced probes → pick best by (CER, WER, deletion rate) → stage-2
voiced (baseline anchor + probe-adapted) → best voiced checkpoint seeds
stage-1 silent probes → stage-2 silent. Training and evaluation run as
**subprocesses** of the port's CLIs (``ssd_tpu_torch.training.train``,
``ssd_tpu_torch.evaluation.evaluate``), each given ``--device`` (default
``cuda``: a child raises without a card, and the sweep stops there).
Artifact-existence idempotency is what makes ``--resume`` work: checkpoints
skip when ``results/checkpoints/<run>/best`` exists, evals when
``metrics.json`` exists. Each run's config is written as
``results/experiments/configs/<run>.yaml`` by the port's YAML writer.
Writes ``summary.json`` plus a flat ``summary.csv``.

Usage::

    python -m ssd_tpu_torch.experiments.orchestrate [--stage all|stage1|stage2]
        [--probe-batches 48] [--probe-batches-silent 24] [--resume]
        [--dry-run] [--device cuda|cuda:N|cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ssd_tpu_torch.experiments.config_builder import (
    DecoderSetting,
    RunSpec,
    VOICED_BASE_CONFIG,
    build_silent_probe_configs,
    build_silent_stage2_configs,
    build_voiced_probe_configs,
    build_voiced_stage2_configs,
)
from ssd_tpu_torch.utils.config import load_config, save_config

LOG = logging.getLogger(__name__)
CONFIG_OUT_DIR = Path("results/experiments/configs")
SUMMARY_JSON = Path("results/experiments/summary.json")
SUMMARY_CSV = Path("results/experiments/summary.csv")

# (record key, path into the nested config dict) — drives _config_features
_FEATURE_PATHS = [
    ("specaugment_p", ("augmentation", "specaugment", "p")),
    ("specaugment_time_masks", ("augmentation", "specaugment", "time_masks")),
    ("specaugment_freq_masks", ("augmentation", "specaugment", "freq_masks")),
    ("specaugment_time_width", ("augmentation", "specaugment", "time_mask_width")),
    ("specaugment_freq_width", ("augmentation", "specaugment", "freq_mask_width")),
    ("channel_dropout_p", ("augmentation", "channel_dropout", "p")),
    ("channel_dropout_max", ("augmentation", "channel_dropout", "max_channels")),
    ("lambda_ctc", ("loss", "lambda_ctc")),
    ("lambda_distill", ("loss", "lambda_distill")),
    ("distill_warmup_epochs", ("loss", "distill_warmup_epochs")),
    ("subsample_factor", ("model", "encoder", "subsample_factor")),
    ("dropout", ("model", "encoder", "dropout")),
    ("batch_size", ("optim", "batch_size")),
    ("max_epochs", ("optim", "max_epochs")),
    ("lr", ("optim", "lr")),
    ("weight_decay", ("optim", "weight_decay")),
]

CSV_FIELDS = [
    "stage", "dataset", "train_run", "run_name", "decoder_name", "decoder_type",
    "wer", "cer", "insertion_rate", "deletion_rate", "substitution_rate",
    "beam_width", "alpha", "beta", "beam_prune_logp", "blank_bias", "lm_used",
    "specaugment_p", "channel_dropout_p", "subsample_factor", "lambda_ctc",
    "lambda_distill", "scheduler", "tags", "overfit_batches", "init_checkpoint",
    "config_path", "checkpoint_path", "eval_dir",
]


def _dig(cfg: Dict, path, default=None):
    node = cfg
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    return node


def _config_features(cfg: Dict) -> Dict:
    feats = {key: _dig(cfg, path) for key, path in _FEATURE_PATHS}
    feats["specaugment_p"] = feats["specaugment_p"] or 0.0
    feats["channel_dropout_p"] = feats["channel_dropout_p"] or 0.0
    sched = _dig(cfg, ("optim", "scheduler"))
    feats["scheduler"] = (
        (sched.get("name") or sched.get("type")) if isinstance(sched, dict) else sched
    )
    feats["scheduler_cfg"] = sched
    feats["decoding_default"] = cfg.get("decoding", {}) or {}
    exp = cfg.get("experiment", {})
    feats["experiment_tags"] = exp.get("tags", [])
    feats["experiment_description"] = exp.get("description", "")
    feats["probe_batches"] = exp.get("probe_batches")
    return feats


def run_command(cmd: List[str], dry_run: bool) -> None:
    LOG.info("Running: %s", " ".join(str(x) for x in cmd))
    if dry_run:
        LOG.info("[dry-run] skipping execution")
        return
    subprocess.run(cmd, check=True)


def write_config(spec: RunSpec, out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{spec.name}.yaml"
    save_config(spec.config, path)
    return path


@dataclass
class ExperimentRunner:
    """Executes RunSpecs with artifact-existence idempotency."""

    dry_run: bool = False
    force_train: bool = False
    force_eval: bool = False
    eval_batch_size: int = 4
    lm_available: bool = True
    summary_path: Optional[Path] = None
    records: List[Dict] = None  # type: ignore[assignment]
    device: str = "cuda"

    def __post_init__(self):
        if self.records is None:
            self.records = []

    # ------------------------------------------------------------- stages
    def train(self, spec: RunSpec, config_path: Path) -> Optional[Path]:
        ckpt = Path("results/checkpoints") / spec.name / "best"
        if ckpt.exists() and not self.force_train:
            LOG.info("Checkpoint exists for %s; skipping train.", spec.name)
            return ckpt
        cmd = [
            sys.executable, "-m", "ssd_tpu_torch.training.train",
            "--config", str(config_path), "--run-dir", str(ckpt.parent),
            "--device", self.device,
        ]
        if spec.init_checkpoint:
            cmd += ["--init-checkpoint", str(spec.init_checkpoint)]
        if spec.overfit_batches:
            cmd += ["--overfit-batches", str(spec.overfit_batches)]
        run_command(cmd, self.dry_run)
        return ckpt if ckpt.exists() or self.dry_run else None

    def evaluate(
        self, spec: RunSpec, decoder: DecoderSetting, ckpt: Path
    ) -> Optional[Path]:
        eval_name = f"{spec.name}__{decoder.name}"
        eval_dir = Path("results/eval") / eval_name
        if decoder.use_lm and not self.lm_available:
            LOG.info("Skipping %s for %s (LM unavailable).", decoder.name, spec.name)
            return None
        if (eval_dir / "metrics.json").exists() and not self.force_eval:
            LOG.info("Eval exists for %s (%s); skipping.", spec.name, decoder.name)
            return eval_dir
        batch = self.eval_batch_size
        cfg_batch = spec.config.get("optim", {}).get("batch_size")
        if cfg_batch is not None:
            batch = min(batch, max(1, cfg_batch))
        cmd = [
            sys.executable, "-m", "ssd_tpu_torch.evaluation.evaluate",
            "--checkpoint", str(ckpt), "--run-name", eval_name,
            "--batch-size", str(batch), "--decoder", decoder.method,
            "--device", self.device,
        ]
        if decoder.method == "beam":
            cmd += ["--beam-width", str(decoder.beam_width or 50)]
            for flag, value in (
                ("--alpha", decoder.alpha),
                ("--beta", decoder.beta),
                ("--beam-prune-logp", decoder.beam_prune_logp),
            ):
                if value is not None:
                    cmd += [flag, str(value)]
        if decoder.blank_bias:
            cmd += ["--blank-bias", str(decoder.blank_bias)]
        if decoder.use_lm and decoder.lm_path:
            cmd += ["--lm-path", str(decoder.lm_path)]
        run_command(cmd, self.dry_run)
        return eval_dir if eval_dir.exists() or self.dry_run else None

    # ------------------------------------------------------------ summary
    def record(
        self, spec: RunSpec, decoder: DecoderSetting, config_path: Path,
        ckpt: Path, eval_dir: Path, duration_sec: Optional[float] = None,
    ) -> Dict:
        metrics_file = eval_dir / "metrics.json"
        if not metrics_file.exists():
            raise FileNotFoundError(metrics_file)
        metrics = json.loads(metrics_file.read_text())
        cfg = load_config(config_path)
        breakdown = metrics.get("error_breakdown", {})
        lm_exists = (
            decoder.use_lm and decoder.lm_path is not None and Path(decoder.lm_path).exists()
        )
        rec = {
            "stage": spec.stage,
            "dataset": spec.dataset,
            "train_run": spec.name,
            "decoder_name": decoder.name,
            "decoder_type": decoder.method,
            "beam_width": decoder.beam_width,
            "alpha": decoder.alpha,
            "beta": decoder.beta,
            "beam_prune_logp": decoder.beam_prune_logp,
            "blank_bias": decoder.blank_bias,
            "lm_used": lm_exists,
            "lm_path": str(decoder.lm_path) if decoder.lm_path else None,
            "metrics": metrics,
            "wer": metrics.get("wer"),
            "cer": metrics.get("cer"),
            "num_samples": metrics.get("data", {}).get("num_samples"),
            "config_path": str(config_path),
            "checkpoint_path": str(ckpt),
            "eval_dir": str(eval_dir),
            "features": _config_features(cfg),
            "tags": spec.tags,
            "description": spec.description,
            "overfit_batches": spec.overfit_batches,
            "init_checkpoint": str(spec.init_checkpoint) if spec.init_checkpoint else None,
            "eval_duration_sec": duration_sec,
            "config_decoder_default": cfg.get("decoding", {}) or {},
            "run_name": metrics.get("run_name", eval_dir.name),
        }
        for k in ("insertions", "deletions", "substitutions"):
            rec[k] = breakdown.get(k)
        for k in ("insertion_rate", "deletion_rate", "substitution_rate"):
            rec[k] = breakdown.get(k)
        return rec

    # ---------------------------------------------------------------- run
    def run(self, specs: Sequence[RunSpec]) -> List[Dict]:
        existing = {(r.get("train_run"), r.get("decoder_name")) for r in self.records}
        new_records: List[Dict] = []
        CONFIG_OUT_DIR.mkdir(parents=True, exist_ok=True)
        for spec in specs:
            LOG.info("=== %s (%s/%s) ===", spec.name, spec.stage, spec.dataset)
            config_path = write_config(spec, CONFIG_OUT_DIR)
            ckpt = self.train(spec, config_path)
            if ckpt is None and not self.dry_run:
                LOG.warning("No checkpoint for %s; skipping evals.", spec.name)
                continue
            for decoder in spec.decoder_grid:
                if (spec.name, decoder.name) in existing and not self.force_eval:
                    LOG.info("Record exists for %s (%s); skipping.", spec.name, decoder.name)
                    continue
                eval_dir = self.evaluate(spec, decoder, ckpt or Path("missing"))
                if eval_dir is None or self.dry_run:
                    continue
                try:
                    rec = self.record(spec, decoder, config_path, ckpt, eval_dir)
                except FileNotFoundError as exc:
                    LOG.warning("Summarize failed for %s (%s): %s", spec.name, decoder.name, exc)
                    continue
                new_records.append(rec)
                self.records.append(rec)
                if self.summary_path:
                    write_summary(
                        self.records, self.summary_path, self.summary_path.with_suffix(".csv")
                    )
        return new_records


def run_specs(
    specs: Sequence[RunSpec],
    dry_run: bool,
    force_train: bool,
    force_eval: bool,
    eval_batch_size: int,
    existing_records: Optional[Sequence[Dict]] = None,
    lm_available: bool = True,
    summary_path: Optional[Path] = None,
    device: str = "cuda",
) -> List[Dict]:
    """:class:`ExperimentRunner` in one call."""
    runner = ExperimentRunner(
        dry_run=dry_run,
        force_train=force_train,
        force_eval=force_eval,
        eval_batch_size=eval_batch_size,
        lm_available=lm_available,
        summary_path=summary_path,
        records=list(existing_records or []),
        device=device,
    )
    return runner.run(specs)


def pick_best(records: Sequence[Dict], dataset: str, stage: Optional[str] = None) -> Optional[Dict]:
    """Best record by (CER, WER, deletion_rate) — emphasizes insertion
    control/blank tuning for silent EMG while keeping overall correctness."""
    pool = [
        r for r in records
        if r.get("dataset") == dataset
        and (stage is None or r.get("stage") == stage)
        and r.get("cer") is not None
    ]
    if not pool:
        return None
    return min(
        pool,
        key=lambda r: (r.get("cer", 1e6), r.get("wer", 1e6), r.get("deletion_rate") or 0.0),
    )


def write_summary(records: List[Dict], json_path: Path, csv_path: Path) -> None:
    json_path.parent.mkdir(parents=True, exist_ok=True)
    json_path.write_text(json.dumps(records, indent=2))
    with csv_path.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        writer.writeheader()
        for rec in records:
            feats = rec.get("features", {})
            row = {k: rec.get(k) for k in CSV_FIELDS}
            for k in ("specaugment_p", "channel_dropout_p", "subsample_factor",
                      "lambda_ctc", "lambda_distill", "scheduler"):
                row[k] = feats.get(k)
            row["tags"] = ",".join(rec.get("tags", []))
            writer.writerow(row)


_KNOB_KEYS_FROM_FEATURES = [
    "specaugment_p", "specaugment_time_masks", "specaugment_freq_masks",
    "specaugment_time_width", "specaugment_freq_width",
    "channel_dropout_p", "channel_dropout_max",
    "lambda_ctc", "lambda_distill", "distill_warmup_epochs",
    "subsample_factor", "scheduler", "scheduler_cfg", "dropout",
]
_KNOB_KEYS_FROM_RECORD = [
    "decoder_type", "beam_width", "alpha", "beta", "beam_prune_logp",
    "blank_bias", "lm_path",
]


def best_probe_to_knobs(record: Dict) -> Dict:
    feats = record.get("features", {})
    knobs = {k: feats.get(k) for k in _KNOB_KEYS_FROM_FEATURES}
    knobs.update({k: record.get(k) for k in _KNOB_KEYS_FROM_RECORD})
    return knobs


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Two-stage experiment orchestrator (PyTorch port).")
    p.add_argument("--probe-batches", type=int, default=48)
    p.add_argument("--probe-batches-silent", type=int, default=24)
    p.add_argument("--eval-batch-size", type=int, default=4)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--force-train", action="store_true")
    p.add_argument("--force-eval", action="store_true")
    p.add_argument("--stage", choices=["all", "stage1", "stage2"], default="all")
    p.add_argument("--summary-json", type=Path, default=SUMMARY_JSON)
    p.add_argument("--summary-csv", type=Path, default=SUMMARY_CSV)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--preflight-overfit", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="Passed to every training and eval child: cuda (default; a child raises "
        "without a card), cuda:N or cpu.",
    )
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ssd_tpu_torch.utils.config import setup_cli_logging

    setup_cli_logging()
    args = parse_args(argv)

    records: List[Dict] = []
    if args.resume and args.summary_json.exists():
        try:
            records = json.loads(args.summary_json.read_text())
            LOG.info("Resuming with %d existing records.", len(records))
        except Exception as exc:  # pragma: no cover - defensive
            LOG.warning("Could not load summary for resume: %s", exc)

    runner = ExperimentRunner(
        dry_run=args.dry_run,
        force_train=args.force_train,
        force_eval=args.force_eval,
        eval_batch_size=args.eval_batch_size,
        lm_available=Path("results/lm/char_5gram.arpa").exists(),
        summary_path=args.summary_json,
        records=records,
        device=args.device,
    )

    if args.preflight_overfit and args.stage in {"all", "stage1"}:
        LOG.info("Preflight single-batch overfit check.")
        run_command(
            [
                sys.executable, "-m", "ssd_tpu_torch.training.train",
                "--config", str(VOICED_BASE_CONFIG),
                "--run-dir", str(Path("results/checkpoints") / "preflight_overfit"),
                "--overfit-batches", "1", "--dry-run", "--device", args.device,
            ],
            args.dry_run,
        )

    if args.stage in {"all", "stage1"}:
        runner.run(build_voiced_probe_configs(args.probe_batches))

    if args.stage in {"stage2", "all"}:
        best_probe = pick_best(runner.records, "voiced", "stage1")
        if best_probe is None:
            LOG.info("No stage-1 voiced results; running probes to seed stage 2.")
            runner.run(build_voiced_probe_configs(args.probe_batches))
            best_probe = pick_best(runner.records, "voiced", "stage1")
        if best_probe is None:
            LOG.warning("No best voiced probe; aborting stage 2.")
        else:
            runner.run(build_voiced_stage2_configs(best_probe_to_knobs(best_probe)))
            best_full = pick_best(runner.records, "voiced", "stage2")
            if best_full is None:
                LOG.warning("No stage-2 voiced run for silent fine-tune.")
            else:
                voiced_ckpt = Path(best_full["checkpoint_path"])
                runner.run(
                    build_silent_probe_configs(
                        args.probe_batches_silent or args.probe_batches, voiced_ckpt
                    )
                )
                best_silent = pick_best(runner.records, "silent", "stage1")
                if best_silent is None:
                    LOG.warning("Silent probes produced no metrics.")
                else:
                    runner.run(
                        build_silent_stage2_configs(
                            best_probe_to_knobs(best_silent), voiced_ckpt
                        )
                    )

    write_summary(runner.records, args.summary_json, args.summary_csv)
    LOG.info("Summary → %s / %s", args.summary_json, args.summary_csv)


if __name__ == "__main__":
    main()
