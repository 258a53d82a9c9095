"""The port's orchestrator executed for real (no ``--dry-run``) on the CPU:
the two-stage sweep — voiced probes → pick_best → stage-2 voiced → the best
voiced checkpoint seeds the silent probes → stage-2 silent — through the
port's trainer and eval CLI as subprocesses (``--device cpu``), on a tiny
corpus and model written with the port's own YAML writer. It checks the
summary's structure, the init-checkpoint chain, the skipped LM entry, and
that ``--resume`` starts no child; metric values on random data are not
pinned."""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ssd_tpu.experiments.orchestrate import CSV_FIELDS as JAX_CSV_FIELDS
from ssd_tpu_torch.data.index_dataset import save_index
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.experiments.orchestrate import CSV_FIELDS, pick_best
from ssd_tpu_torch.utils.yaml_subset import write_yaml
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

REPO = Path(__file__).resolve().parents[1]

TINY_MODEL = {
    "encoder": {
        "d_model": 16, "num_layers": 1, "num_heads": 2, "ffn_dim": 32,
        "depthwise_conv_kernel_size": 7, "dropout": 0.05, "subsample_factor": 2,
        "input_dim": 16,
    },
    "projection_dim": 8,
    "ctc_dropout": 0.05,
}


def _write_corpus(wd: Path) -> None:
    rng = np.random.default_rng(0)
    rows = []
    texts = ["hello world", "go go", "a cat sat", "silent speech here", "hi there"]
    for split, n in (("voiced_parallel_data", 10), ("silent_parallel_data", 8)):
        d = wd / "results/features/emg" / split / "s1"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            t = int(rng.integers(40, 90))
            np.save(d / f"{i}_0.npy", rng.normal(size=(t, 2, 8)).astype(np.float32))
            rows.append(dict(
                utterance_id=f"{split}/s1/{i}_0", split=split,
                subset=["train", "train", "train", "val", "test"][i % 5],
                speaker="s1", stem=f"{i}_0", emg_path="x", audio_path=None,
                transcript=texts[i % len(texts)], sentence_index=i, book="",
                has_audio=split == "voiced_parallel_data", metadata_json="{}",
            ))
    save_index(rows, wd / "results/index.jsonl")


def _write_configs(wd: Path) -> None:
    (wd / "configs/experiments").mkdir(parents=True, exist_ok=True)
    default_vocab().to_json(wd / "configs/vocab.json")

    def base_cfg(split):
        return {
            "data": {
                "index": "results/index.jsonl",
                "features_root": "results/features",
                "train_splits": [split], "train_subsets": ["train"],
                "val_splits": [split], "val_subsets": ["val"],
                "vocab": "configs/vocab.json",
                "include_teacher": False, "teacher_strict": False,
            },
            "features": {"teacher": {"dim": 8}},
            "model": TINY_MODEL,
            "loss": {"lambda_distill": 0.0, "lambda_ctc": 1.0},
            "optim": {
                "batch_size": 4, "grad_accum": 1, "lr": 2e-3,
                "weight_decay": 1e-3, "max_epochs": 2, "clip_grad_norm": 5.0,
                "scheduler": {"name": "warmup_hold", "warmup_steps": 4},
                "early_stopping": {"patience": 1, "min_delta": 0.0},
            },
            "decoding": {"type": "beam", "beam_width": 8},
            "logging": {"seed": 0, "run_name": "base", "log_interval": 50},
        }

    configs = {
        "tpu_fast_plus.yaml": base_cfg("voiced_parallel_data"),
        "tpu_silent_finetune_plus.yaml": base_cfg("silent_parallel_data"),
        "experiments/voiced_probes.yaml": {
            "base_overrides": {"optim": {"max_epochs": 1}},
            "variants": [{"name": "probe_v_base", "overrides": {},
                          "tags": ["baseline"], "description": "tiny probe"}],
        },
        "experiments/silent_probes.yaml": {
            "base_overrides": {"optim": {"max_epochs": 1}},
            "variants": [{"name": "probe_s_base", "overrides": {},
                          "tags": ["baseline"], "description": "tiny silent probe"}],
        },
        # slim decoder grids; one use_lm entry exercises the LM-missing skip
        "experiments/decoder_grids.yaml": {
            "probe_voiced": [
                {"name": "beam8", "method": "beam", "beam_width": 8, "alpha": 0.45},
            ],
            "probe_silent": [{"name": "greedy", "method": "greedy"}],
            "full_voiced": [
                {"name": "greedy", "method": "greedy"},
                {"name": "beam8_lm", "method": "beam", "beam_width": 8,
                 "alpha": 0.5, "use_lm": True, "lm_path": "results/lm/char_5gram.arpa"},
            ],
            "full_silent": [{"name": "greedy", "method": "greedy"}],
        },
    }
    for name, cfg in configs.items():
        (wd / "configs" / name).write_text(write_yaml(cfg))


def _run_orchestrate(wd: Path, *extra: str) -> subprocess.CompletedProcess:
    # one thread a child: the sweep's processes run one after another beside
    # the rest of the suite. The children see no tensorboardX, as on the card
    # (the trainer's JSONL scalar writer; importing it is ~3.6 s a child here)
    hide = wd / "card_site" / "tensorboardX"
    hide.mkdir(parents=True, exist_ok=True)
    (hide / "__init__.py").write_text('raise ImportError("tensorboardX is not installed")\n')
    env = dict(os.environ, PYTHONPATH=f"{hide.parent}{os.pathsep}{REPO}", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "ssd_tpu_torch.experiments.orchestrate",
         "--probe-batches", "1", "--probe-batches-silent", "1",
         "--eval-batch-size", "4", "--device", "cpu", *extra],
        cwd=wd, env=env, capture_output=True, text=True, timeout=600,
    )


def _children(proc: subprocess.CompletedProcess) -> list:
    return [line.split("Running: ", 1)[1] for line in proc.stderr.splitlines()
            if "Running: " in line]


def test_orchestrate_two_stage_real_run(tmp_path):
    wd = tmp_path
    _write_corpus(wd)
    _write_configs(wd)

    proc = _run_orchestrate(wd)
    assert proc.returncode == 0, proc.stderr[-4000:]
    children = _children(proc)
    # 4 probe / stage-2 cells: 6 trainings, 6 evals (the LM entry skipped)
    assert sum("ssd_tpu_torch.training.train" in c for c in children) == 6, children
    assert sum("ssd_tpu_torch.evaluation.evaluate" in c for c in children) == 6, children
    assert all(c.endswith("--device cpu") or "--device cpu " in c for c in children), children

    summary_json = wd / "results/experiments/summary.json"
    summary_csv = wd / "results/experiments/summary.csv"
    records = json.loads(summary_json.read_text())
    assert len(records) == 6

    cells = {(r["stage"], r["dataset"]) for r in records}
    assert cells == {("stage1", "voiced"), ("stage2", "voiced"),
                     ("stage1", "silent"), ("stage2", "silent")}, cells

    for r in records:
        assert r["cer"] is not None and 0.0 <= r["cer"] <= 2.0
        assert r["wer"] is not None and 0.0 <= r["wer"] <= 2.0
        assert (wd / r["checkpoint_path"] / "model.pt").exists()
        assert (wd / r["checkpoint_path"]).parent.joinpath("tb", "scalars.jsonl").exists()
        assert (wd / r["eval_dir"] / "metrics.json").exists()
        assert r["config_path"].endswith(f"{r['train_run']}.yaml")

    # every silent record warm-started from the best stage-2 voiced checkpoint
    best_voiced = pick_best(records, "voiced", "stage2")
    assert best_voiced is not None
    for r in records:
        if r["dataset"] == "silent":
            assert r["init_checkpoint"] == best_voiced["checkpoint_path"], r["train_run"]
    silent_trains = [c for c in children
                     if "training.train" in c and ("probe_s" in c or "stage2_silent" in c)]
    assert len(silent_trains) == 3
    assert all(f"--init-checkpoint {best_voiced['checkpoint_path']}" in c for c in silent_trains)

    # the LM decoder was skipped (no ARPA present)
    assert not any(r.get("lm_used") for r in records)
    assert not any(r["decoder_name"] == "beam8_lm" for r in records)
    assert "beam8_lm" in proc.stderr and "LM unavailable" in proc.stderr

    with summary_csv.open() as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    assert header == CSV_FIELDS == JAX_CSV_FIELDS
    assert len(rows) == len(records)

    # idempotent --resume: no child starts, the records stay as they were
    before = summary_json.read_text()
    proc2 = _run_orchestrate(wd, "--resume")
    assert proc2.returncode == 0, proc2.stderr[-4000:]
    assert _children(proc2) == []
    assert "skipping" in proc2.stderr.lower()
    assert json.loads(summary_json.read_text()) == json.loads(before)
