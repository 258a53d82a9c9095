"""The port's experiment layer (``ssd_tpu_torch/experiments/``) and its YAML
writer against the JAX package: the four config factories on the shipped
``configs/experiments/*.yaml``, the decoder grids, ``_config_features``,
``pick_best``, ``best_probe_to_knobs``, ``write_summary``'s bytes, the
dry-run command lines and written configs, ``write_yaml`` round trips
through ``yaml.safe_load`` and ``read_yaml``, and ``--device cuda`` refused
where there is no card."""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from ssd_tpu.experiments import config_builder as jcb
from ssd_tpu.experiments import orchestrate as jorch
from ssd_tpu.utils.config import deep_update as jax_deep_update
from ssd_tpu_torch.experiments import config_builder as pcb
from ssd_tpu_torch.experiments import orchestrate as porch
from ssd_tpu_torch.utils.config import deep_update, load_config, save_config
from ssd_tpu_torch.utils.yaml_subset import read_yaml, write_yaml
from .test_torch_logging import restored_logging
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CKPT = Path("results/checkpoints/stage2_voiced_adapted/best")

# best-probe knob dicts for the stage-2 factories: none at all, a full
# record's knobs with a scheduler_cfg, every knob recorded as None (a probe
# config without those keys), and silent-stage knobs with an LM decoder
BEST_PROBES = [
    {},
    {
        "specaugment_p": 0.28, "lambda_ctc": 0.62, "lambda_distill": 0.38,
        "channel_dropout_p": 0.15, "channel_dropout_max": 2, "decoder_type": "beam",
        "beam_width": 20, "alpha": 0.45, "blank_bias": 0.12,
        "scheduler_cfg": {"name": "warmup_hold", "warmup_steps": 340}, "dropout": 0.12,
    },
    dict.fromkeys(jorch._KNOB_KEYS_FROM_FEATURES + jorch._KNOB_KEYS_FROM_RECORD),
    {
        "subsample_factor": 4, "specaugment_p": 0.05, "specaugment_time_masks": 1,
        "channel_dropout_p": 0.12, "channel_dropout_max": None, "decoder_type": "beam",
        "beam_width": 50, "alpha": None, "beta": 0.05, "beam_prune_logp": -12.0,
        "blank_bias": None, "lm_path": "results/lm/char_5gram.arpa", "scheduler": "cosine",
        "scheduler_cfg": None,
    },
]


def _specs(mod):
    out = {
        "voiced_probes": mod.build_voiced_probe_configs(48),
        "silent_probes": mod.build_silent_probe_configs(24, CKPT),
        "silent_probes_no_init": mod.build_silent_probe_configs(3, None),
    }
    for i, best in enumerate(BEST_PROBES):
        out[f"voiced_stage2_{i}"] = mod.build_voiced_stage2_configs(dict(best))
        out[f"silent_stage2_{i}"] = mod.build_silent_stage2_configs(dict(best), CKPT)
    out["voiced_stage2_no_baseline"] = mod.build_voiced_stage2_configs(
        dict(BEST_PROBES[1]), include_baseline=False)
    out["silent_stage2_no_baseline"] = mod.build_silent_stage2_configs(
        dict(BEST_PROBES[3]), CKPT, include_baseline=False)
    return out


SPEC_NAMES = list(_specs(jcb))


@pytest.fixture(scope="module")
def built():
    return _specs(jcb), _specs(pcb)


@pytest.mark.parametrize("cls", ["DecoderSetting", "RunSpec"])
def test_dataclasses_have_the_jax_fields_and_defaults(cls):
    def shape(c):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(c)]

    assert shape(getattr(pcb, cls)) == shape(getattr(jcb, cls))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_factories_equal_jax_field_by_field(built, name):
    jax_specs, port_specs = built[0][name], built[1][name]
    assert len(port_specs) == len(jax_specs) > 0
    for p, j in zip(port_specs, jax_specs):
        assert type(p).__name__ == "RunSpec"
        assert dataclasses.asdict(p) == dataclasses.asdict(j)


def test_shipped_variants_are_all_built(built):
    port = built[1]
    assert [s.name for s in port["voiced_probes"]] == [
        v["name"] for v in yaml.safe_load((REPO / "configs/experiments/voiced_probes.yaml")
                                          .read_text())["variants"]]
    assert len(port["voiced_probes"]) == 5 and len(port["silent_probes"]) == 4
    assert all(s.init_checkpoint == CKPT for s in port["silent_probes"])


def test_factories_find_the_shipped_configs_from_any_cwd(built, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    elsewhere = _specs(pcb)
    for name, specs in built[0].items():
        assert [dataclasses.asdict(s) for s in elsewhere[name]] == [
            dataclasses.asdict(s) for s in specs], name


@pytest.mark.parametrize(
    "attr", ["PROBE_DECODERS_VOICED", "PROBE_DECODERS_SILENT", "FULL_DECODERS_VOICED",
             "FULL_DECODERS_SILENT"])
def test_grid_attributes_equal_jax(attr):
    port, jax_grid = getattr(pcb, attr), getattr(jcb, attr)
    assert [dataclasses.asdict(d) for d in port] == [dataclasses.asdict(d) for d in jax_grid]
    assert all(isinstance(d, pcb.DecoderSetting) for d in port)


def test_unknown_module_attribute_raises():
    with pytest.raises(AttributeError):
        pcb.NO_SUCH_GRID  # noqa: B018


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_config_features_equal_jax(built, name):
    for spec in built[1][name]:
        assert porch._config_features(spec.config) == jorch._config_features(spec.config)


def _records():
    """Summary records as ``ExperimentRunner.record`` builds them, over the
    built configs and grids, with ties in (CER, WER, deletion rate)."""
    recs = []
    rows = [(0.5, 0.9, 0.1), (0.4, 0.95, 0.3), (0.4, 0.95, 0.3), (0.4, 0.95, None),
            (0.3, 0.9, 0.1), (0.3, 0.8, 0.2), (None, None, None), (0.3, 0.8, 0.2)]
    specs = [s for v in _specs(pcb).values() for s in v]
    for i, (spec, (cer, wer, dele)) in enumerate(zip(specs[::3], rows * 4)):
        dec = spec.decoder_grid[i % len(spec.decoder_grid)]
        metrics = {"wer": wer, "cer": cer, "run_name": f"{spec.name}__{dec.name}",
                   "data": {"num_samples": 4},
                   "error_breakdown": {"insertions": 1, "deletions": 2, "substitutions": 3,
                                       "insertion_rate": 0.01, "deletion_rate": dele,
                                       "substitution_rate": 0.03}}
        rec = {
            "stage": spec.stage, "dataset": spec.dataset, "train_run": f"{spec.name}_{i}",
            "decoder_name": dec.name, "decoder_type": dec.method, "beam_width": dec.beam_width,
            "alpha": dec.alpha, "beta": dec.beta, "beam_prune_logp": dec.beam_prune_logp,
            "blank_bias": dec.blank_bias, "lm_used": False,
            "lm_path": str(dec.lm_path) if dec.lm_path else None, "metrics": metrics,
            "wer": wer, "cer": cer, "num_samples": 4,
            "config_path": f"results/experiments/configs/{spec.name}.yaml",
            "checkpoint_path": f"results/checkpoints/{spec.name}/best",
            "eval_dir": f"results/eval/{spec.name}__{dec.name}",
            "features": porch._config_features(spec.config), "tags": spec.tags,
            "description": spec.description, "overfit_batches": spec.overfit_batches,
            "init_checkpoint": str(spec.init_checkpoint) if spec.init_checkpoint else None,
            "eval_duration_sec": None,
            "config_decoder_default": spec.config.get("decoding", {}) or {},
            "run_name": metrics["run_name"],
        }
        for k in ("insertions", "deletions", "substitutions", "insertion_rate",
                  "deletion_rate", "substitution_rate"):
            rec[k] = metrics["error_breakdown"][k]
        recs.append(rec)
    return recs


def test_pick_best_equals_jax_including_ties():
    recs = _records()
    assert {r["dataset"] for r in recs} == {"voiced", "silent"}
    for dataset in ("voiced", "silent", "closed"):
        for stage in (None, "stage1", "stage2", "stage3"):
            got, want = porch.pick_best(recs, dataset, stage), jorch.pick_best(recs, dataset, stage)
            assert got is want, (dataset, stage)
    tied = [dict(r, dataset="voiced", stage="stage1", cer=0.2, wer=0.5, deletion_rate=0.1,
                 train_run=f"tie{i}") for i, r in enumerate(recs[:3])]
    assert porch.pick_best(tied, "voiced", "stage1") is jorch.pick_best(tied, "voiced",
                                                                         "stage1") is tied[0]


def test_best_probe_to_knobs_equals_jax():
    for rec in _records():
        assert porch.best_probe_to_knobs(rec) == jorch.best_probe_to_knobs(rec)
    assert porch.best_probe_to_knobs({}) == jorch.best_probe_to_knobs({})


def test_write_summary_bytes_equal_jax(tmp_path):
    recs = _records()
    recs[0]["tags"] = ["a,b", "ü"]
    recs[1]["description"] = 'quote " and, comma'
    paths = {}
    for name, mod in (("jax", jorch), ("port", porch)):
        jp, cp = tmp_path / name / "summary.json", tmp_path / name / "summary.csv"
        mod.write_summary(recs, jp, cp)
        paths[name] = (jp.read_bytes(), cp.read_bytes())
    assert paths["port"] == paths["jax"]
    assert porch.CSV_FIELDS == jorch.CSV_FIELDS
    assert json.loads(paths["port"][0]) == recs


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_write_yaml_round_trips_every_built_config(built, name, tmp_path):
    for spec in built[1][name]:
        text = write_yaml(spec.config)
        assert yaml.safe_load(text) == spec.config
        assert read_yaml(text) == spec.config
        path = tmp_path / f"{spec.name}.yaml"
        save_config(spec.config, path)
        assert load_config(path) == spec.config


HARD = [
    None, True, False, 0, -5, 2 ** 40, 3.0e-5, 1e-300, 1e16, -0.0, 0.1, 12345678.9,
    float("inf"), float("-inf"), [], {}, "", " lead", "trail ", "yes", "No", "ON", "off",
    "~", "null", "NULL", "true", "1", "1.0", "3e-4", "3.0e-5", "1.5e+3", ".5", ".inf", ".NaN",
    "0x1F", "0b11", "010", "1_000", "1:30", "2024-01-02", "2024-1-2 10:00", "<<", "=",
    "a: b", "a:b", "x:", "a #b", "a#b", "#x", "- x", "-", "-x", "it's", "'q'", '"dq"', "[x]",
    "{x}", "a, b", "*a", "&a", "!t", "|", ">", "%x", "@x", "`x", "?", "ü", "tcp://h:1",
    "results/lm/char_5gram.arpa", "Sub2 with mid-strength SpecAugment; checks.",
    [{"a": [{"b": []}], "c": {}}, [[1, [2, {}]]], {"d": None}],
    {"nested": {"deeper": {"list": [[], [{}], [None, "null"]]}}},
]


@pytest.mark.parametrize("value", HARD, ids=range(len(HARD)))
def test_write_yaml_round_trips_hard_values(value):
    data = {"k": value, "seq": [value, value], "map": {"k": value}, "tags": [], "base_overrides": {}}
    text = write_yaml(data)
    assert yaml.safe_load(text) == data
    assert read_yaml(text) == data
    for top in ([value], value):
        assert yaml.safe_load(write_yaml(top)) == top == read_yaml(write_yaml(top))


def test_write_yaml_nan_path_and_tuple():
    text = write_yaml({"x": float("nan"), "p": Path("results/lm/a.arpa"), "t": (1, (2, 3))})
    for got in (yaml.safe_load(text), read_yaml(text)):
        assert math.isnan(got["x"])
        assert got["p"] == "results/lm/a.arpa" and got["t"] == [1, [2, 3]]
    # the JAX package puts lm_path in a config as the record's string: pyyaml
    # gives that string back, and a Path is written as the same string
    jax_cfg = jcb._decoding_overrides({"decoder_type": "beam", "lm_path": "results/lm/a.arpa"}, 0.5)
    port_cfg = pcb._decoding_overrides({"decoder_type": "beam", "lm_path": Path("results/lm/a.arpa")},
                                       0.5)
    assert read_yaml(write_yaml(port_cfg)) == yaml.safe_load(yaml.safe_dump(jax_cfg, sort_keys=False))


@pytest.mark.parametrize("bad,exc", [("a\nb", ValueError), ("tab\there", ValueError),
                                     (object(), TypeError), ({1, 2}, TypeError)])
def test_write_yaml_refuses_what_it_cannot_write(bad, exc):
    with pytest.raises(exc):
        write_yaml({"k": bad})


def test_write_yaml_lays_out_as_safe_dump():
    data = {"a": 3.0e-5, "b": [{"x": 1, "y": [1, 2]}, [1, [2, 3]]], "c": {}, "d": [], "e": None,
            "f": "yes", "g": {"h": {"i": 1.0e16}}}
    assert write_yaml(data) == yaml.safe_dump(data, sort_keys=False)


def test_deep_update_equals_jax_and_copies():
    base = {"a": {"b": 1, "c": [1, 2], "d": {"e": None}}, "f": 2}
    over = {"a": {"c": [3], "d": {"g": 4}}, "f": {"h": 5}, "i": [6]}
    got = deep_update(base, over)
    assert got == jax_deep_update(base, over)
    got["a"]["c"].append(9)
    got["i"].append(9)
    assert base["a"]["c"] == [1, 2] and over["i"] == [6] and over["a"]["c"] == [3]


def test_save_config_json_and_yaml(tmp_path):
    cfg = _specs(pcb)["voiced_stage2_1"][1].config
    save_config(cfg, tmp_path / "c.json")
    assert (tmp_path / "c.json").read_text() == json.dumps(cfg, indent=2)
    save_config(cfg, tmp_path / "c.yaml")
    assert load_config(tmp_path / "c.yaml") == cfg == load_config(tmp_path / "c.json")


# ------------------------------------------------------------- dry runs


def _to_jax(cmd):
    """A port command line as the JAX orchestrator writes it: the module
    prefix back, ``--device`` and its value out."""
    cmd = list(cmd)
    i = cmd.index("--device")
    device = cmd[i + 1]
    del cmd[i:i + 2]
    return [c.replace("ssd_tpu_torch.", "ssd_tpu.") if c.startswith("ssd_tpu_torch.") else c
            for c in cmd], device


def _recorded(mod, monkeypatch):
    seen = []
    monkeypatch.setattr(mod, "run_command", lambda cmd, dry_run: seen.append(list(cmd)))
    return seen


def test_dry_run_command_lines_and_configs_equal_jax(tmp_path, monkeypatch):
    argv = ["--dry-run", "--preflight-overfit", "--probe-batches", "3",
            "--probe-batches-silent", "2", "--eval-batch-size", "3"]
    cmds = {}
    for name, mod in (("jax", jorch), ("port", porch)):
        wd = tmp_path / name
        wd.mkdir()
        monkeypatch.chdir(wd)
        seen = _recorded(mod, monkeypatch)
        with restored_logging():
            if name == "jax":
                monkeypatch.setattr(sys, "argv", ["orchestrate", *argv])
                mod.main()
            else:
                mod.main([*argv, "--device", "cuda:1"])
        # stage 2 and the silent stages from a best probe's knobs, dry
        knobs = dict(BEST_PROBES[3])
        cb = jcb if name == "jax" else pcb
        specs = (cb.build_voiced_stage2_configs(knobs) + cb.build_silent_probe_configs(2, CKPT)
                 + cb.build_silent_stage2_configs(knobs, CKPT))
        extra = {} if name == "jax" else {"device": "cpu"}
        assert mod.run_specs(specs, dry_run=True, force_train=False, force_eval=False,
                             eval_batch_size=4, **extra) == []
        cmds[name] = seen
    monkeypatch.chdir(tmp_path)
    assert len(cmds["port"]) == len(cmds["jax"]) > 20
    devices = set()
    for p, j in zip(cmds["port"], cmds["jax"]):
        got, device = _to_jax(p)
        devices.add(device)
        assert got == j
    assert devices == {"cuda:1", "cpu"}
    written = sorted(p.name for p in (tmp_path / "port/results/experiments/configs").iterdir())
    assert written == sorted(p.name for p in (tmp_path / "jax/results/experiments/configs").iterdir())
    assert len(written) == 5 + 2 + 4 + 2
    for fname in written:
        port_file = tmp_path / "port/results/experiments/configs" / fname
        want = yaml.safe_load((tmp_path / "jax/results/experiments/configs" / fname).read_text())
        assert load_config(port_file) == want == yaml.safe_load(port_file.read_text())


def _help_flags(capsys, call):
    with pytest.raises(SystemExit):
        call()
    return {w.rstrip(",") for w in capsys.readouterr().out.split() if w.startswith("--")} - {
        "--help"}


def test_cli_flags_are_the_jax_flags_and_device(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["orchestrate", "--help"])
    jax_flags = _help_flags(capsys, jorch.parse_args)
    port_flags = _help_flags(capsys, lambda: porch.parse_args(["--help"]))
    assert port_flags == jax_flags | {"--device"}
    assert len(jax_flags) == 11


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a CUDA card")
def test_device_cuda_without_a_card_fails(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ssd_tpu_torch.experiments.orchestrate", "--stage", "stage1",
         "--probe-batches", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode != 0, out[-4000:]
    assert "CUDA is not available" in out and "--device cuda" in out, out[-4000:]
    assert not (tmp_path / "results/experiments/summary.json").exists()
    assert not (tmp_path / "results/checkpoints/probe_voiced_hold_lightaug/last").exists()
