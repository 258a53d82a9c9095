"""Experiment config factories — data-driven (the port's own copy of
``ssd_tpu/experiments/config_builder.py``, read through the port's YAML
reader).

The probe variants and decoder grids live as YAML *data* under
``configs/experiments/``. This module turns that data into :class:`RunSpec`
objects:

* stage-1 probes — deep-merge each variant's overrides onto the voiced /
  silent base config, cap epochs, stamp ``experiment`` metadata;
* stage-2 — a baseline anchor plus a config adapted from the winning
  probe's knobs (augmentation, λs, scheduler, subsample factor, decoder).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from ssd_tpu_torch.utils.config import deep_update, load_config

CONFIG_ROOT = Path("configs")
VOICED_BASE_CONFIG = CONFIG_ROOT / "tpu_fast_plus.yaml"
SILENT_BASE_CONFIG = CONFIG_ROOT / "tpu_silent_finetune_plus.yaml"
EXPERIMENTS_DIR = CONFIG_ROOT / "experiments"
_REPO_ROOT = Path(__file__).resolve().parents[2]


def _resolve(path: Path) -> Path:
    """cwd-relative first (experiment workdirs), repo-relative fallback, so
    the shipped ``configs/`` are found from any working directory."""
    if path.exists():
        return path
    fallback = _REPO_ROOT / path
    return fallback if fallback.exists() else path


@dataclass
class DecoderSetting:
    name: str
    method: str = "greedy"
    beam_width: Optional[int] = None
    alpha: Optional[float] = None
    beta: Optional[float] = None
    beam_prune_logp: Optional[float] = None
    blank_bias: float = 0.0
    use_lm: bool = False
    lm_path: Optional[Path] = None


@dataclass
class RunSpec:
    name: str
    stage: str
    dataset: str
    config: Dict
    decoder_grid: List[DecoderSetting]
    overfit_batches: Optional[int] = None
    init_checkpoint: Optional[Path] = None
    tags: List[str] = field(default_factory=list)
    description: str = ""


def _load_grid(key: str) -> List[DecoderSetting]:
    grids = load_config(_resolve(EXPERIMENTS_DIR / "decoder_grids.yaml"))
    out = []
    for entry in grids[key]:
        entry = dict(entry)
        if "lm_path" in entry:
            entry["lm_path"] = Path(entry["lm_path"])
        out.append(DecoderSetting(**entry))
    return out


# the grids as module attributes, read anew at each access
def __getattr__(name: str):
    mapping = {
        "PROBE_DECODERS_VOICED": "probe_voiced",
        "PROBE_DECODERS_SILENT": "probe_silent",
        "FULL_DECODERS_VOICED": "full_voiced",
        "FULL_DECODERS_SILENT": "full_silent",
    }
    if name in mapping:
        return _load_grid(mapping[name])
    raise AttributeError(name)


def _stamp(cfg: Dict, *, name: str, stage: str, dataset: str, tags: List[str],
           description: str, probe_batches: Optional[int]) -> Dict:
    cfg = copy.deepcopy(cfg)
    cfg.setdefault("logging", {})["run_name"] = name
    cfg["experiment"] = {
        "stage": stage,
        "dataset": dataset,
        "tags": tags,
        "description": description,
        "probe_batches": probe_batches,
    }
    return cfg


def _probe_specs(
    spec_file: str,
    base_config: Path,
    dataset: str,
    grid_key: str,
    probe_batches: int,
    init_checkpoint: Optional[Path] = None,
) -> List[RunSpec]:
    data = load_config(_resolve(EXPERIMENTS_DIR / spec_file))
    base = deep_update(load_config(_resolve(base_config)), data.get("base_overrides", {}))
    grid = _load_grid(grid_key)
    specs = []
    for variant in data["variants"]:
        cfg = deep_update(base, variant.get("overrides", {}))
        cfg = _stamp(
            cfg,
            name=variant["name"],
            stage="stage1",
            dataset=dataset,
            tags=variant.get("tags", []),
            description=variant.get("description", ""),
            probe_batches=probe_batches,
        )
        specs.append(
            RunSpec(
                name=variant["name"],
                stage="stage1",
                dataset=dataset,
                config=cfg,
                decoder_grid=grid,
                overfit_batches=probe_batches,
                init_checkpoint=init_checkpoint,
                tags=variant.get("tags", []),
                description=variant.get("description", ""),
            )
        )
    return specs


def build_voiced_probe_configs(probe_batches: int) -> List[RunSpec]:
    return _probe_specs(
        "voiced_probes.yaml", VOICED_BASE_CONFIG, "voiced", "probe_voiced", probe_batches
    )


def build_silent_probe_configs(
    probe_batches: int, init_checkpoint: Optional[Path]
) -> List[RunSpec]:
    return _probe_specs(
        "silent_probes.yaml",
        SILENT_BASE_CONFIG,
        "silent",
        "probe_silent",
        probe_batches,
        init_checkpoint=init_checkpoint,
    )


# --------------------------------------------------------------------------
# Stage 2: baseline anchor + adaptation from the winning probe's knobs
# --------------------------------------------------------------------------


def _decoding_overrides(best: Dict, default_alpha: float) -> Dict[str, Any]:
    if not best.get("decoder_type"):
        return {}
    block = {
        "type": best.get("decoder_type", "beam"),
        "beam_width": best.get("beam_width", 50),
        "alpha": best.get("alpha", default_alpha),
        "beta": best.get("beta", 0.0),
        "beam_prune_logp": best.get("beam_prune_logp", -10.0),
        "lm_path": best.get("lm_path"),
    }
    if best.get("blank_bias") is not None:
        block["blank_bias"] = best["blank_bias"]
    return {"decoding": block}


def _channel_dropout_overrides(best: Dict) -> Dict[str, Any]:
    if (best.get("channel_dropout_p") or 0.0) <= 0.0:
        return {}
    return {
        "augmentation": {
            "channel_dropout": {
                "p": best.get("channel_dropout_p", 0.1),
                "max_channels": best.get("channel_dropout_max", 2),
            }
        }
    }


def _anchor_spec(base_cfg: Dict, name: str, dataset: str, grid, description: str,
                 init_checkpoint: Optional[Path] = None) -> RunSpec:
    cfg = _stamp(
        base_cfg, name=name, stage="stage2", dataset=dataset,
        tags=["baseline"], description=description, probe_batches=None,
    )
    return RunSpec(
        name=name, stage="stage2", dataset=dataset, config=cfg,
        decoder_grid=grid, init_checkpoint=init_checkpoint,
        tags=["baseline"], description=description,
    )


def _knob(best_probe: Dict, key: str, default):
    """Probe-knob lookup where a recorded None (knob absent from the probe
    config) falls back to the stage-2 default — best_probe.get() would
    propagate the None into the generated config (crashes the trainer)."""
    value = best_probe.get(key)
    return default if value is None else value


def build_voiced_stage2_configs(best_probe: Dict, include_baseline: bool = True) -> List[RunSpec]:
    base_cfg = load_config(_resolve(VOICED_BASE_CONFIG))
    grid = _load_grid("full_voiced")
    specs: List[RunSpec] = []
    if include_baseline:
        specs.append(
            _anchor_spec(
                base_cfg, "stage2_voiced_baseline", "voiced", grid,
                "Baseline voiced run (anchor) without Stage 1 changes.",
            )
        )

    overrides: Dict[str, Any] = {
        "augmentation": {
            "specaugment": {
                "p": max(best_probe.get("specaugment_p") or 0.25, 0.15),
                "time_masks": _knob(best_probe, "specaugment_time_masks", 2),
                "freq_masks": _knob(best_probe, "specaugment_freq_masks", 2),
                "time_mask_width": _knob(best_probe, "specaugment_time_width", 0.06),
                "freq_mask_width": _knob(best_probe, "specaugment_freq_width", 8),
            }
        },
        "loss": {
            "lambda_ctc": _knob(best_probe, "lambda_ctc", 0.65),
            "lambda_distill": _knob(best_probe, "lambda_distill", 0.35),
            "distill_warmup_epochs": _knob(best_probe, "distill_warmup_epochs", 2),
        },
        "optim": {
            "scheduler": best_probe.get("scheduler_cfg")
            or {"name": _knob(best_probe, "scheduler", "warmup_hold"), "warmup_steps": 600},
            "max_epochs": 50,
            "early_stopping": {"patience": 5, "min_delta": 0.0},
        },
        "model": {"encoder": {"dropout": _knob(best_probe, "dropout", 0.12)}},
    }
    adapted = deep_update(base_cfg, overrides)
    adapted = deep_update(adapted, _channel_dropout_overrides(best_probe))
    adapted = deep_update(adapted, _decoding_overrides(best_probe, default_alpha=0.45))
    adapted = _stamp(
        adapted, name="stage2_voiced_adapted", stage="stage2", dataset="voiced",
        tags=["stage1_guided"],
        description="Stage 2 voiced config derived from best Stage 1 probe.",
        probe_batches=None,
    )
    specs.append(
        RunSpec(
            name="stage2_voiced_adapted", stage="stage2", dataset="voiced",
            config=adapted, decoder_grid=grid, tags=["stage1_guided"],
            description="Stage 2 voiced config derived from best Stage 1 probe.",
        )
    )
    return specs


def build_silent_stage2_configs(
    best_probe: Dict, init_checkpoint: Path, include_baseline: bool = True
) -> List[RunSpec]:
    base_cfg = load_config(_resolve(SILENT_BASE_CONFIG))
    grid = _load_grid("full_silent")
    specs: List[RunSpec] = []
    if include_baseline:
        specs.append(
            _anchor_spec(
                base_cfg, "stage2_silent_baseline", "silent", grid,
                "Baseline silent fine-tune (anchor) from best voiced.",
                init_checkpoint=init_checkpoint,
            )
        )

    spec_defaults = base_cfg.get("augmentation", {}).get("specaugment", {})
    overrides: Dict[str, Any] = {
        "model": {"encoder": {"subsample_factor": _knob(best_probe, "subsample_factor", 2)}},
        "augmentation": {
            "specaugment": {
                "p": _knob(best_probe, "specaugment_p", spec_defaults.get("p", 0.05)),
                "time_masks": _knob(best_probe, "specaugment_time_masks", 1),
                "freq_masks": _knob(best_probe, "specaugment_freq_masks", 1),
                "time_mask_width": _knob(best_probe, "specaugment_time_width", 0.05),
                "freq_mask_width": _knob(best_probe, "specaugment_freq_width", 6),
            }
        },
        "optim": {"max_epochs": 32, "early_stopping": {"patience": 5, "min_delta": 0.0}},
    }
    adapted = deep_update(base_cfg, overrides)
    adapted = deep_update(adapted, _channel_dropout_overrides(best_probe))
    adapted = deep_update(adapted, _decoding_overrides(best_probe, default_alpha=0.5))
    adapted = _stamp(
        adapted, name="stage2_silent_adapted", stage="stage2", dataset="silent",
        tags=["stage1_guided"],
        description="Silent fine-tune derived from best Stage 1 silent probe.",
        probe_batches=None,
    )
    specs.append(
        RunSpec(
            name="stage2_silent_adapted", stage="stage2", dataset="silent",
            config=adapted, decoder_grid=grid, init_checkpoint=init_checkpoint,
            tags=["stage1_guided"],
            description="Silent fine-tune derived from best Stage 1 silent probe.",
        )
    )
    return specs
