"""The port's feature visualizer (``ssd_tpu_torch.evaluation.visualize``):
twins of ``tests/test_visualize.py`` (the plots written, the CLI's three
files, ``load_features``), its helpers equal to the JAX package's, its flags
the JAX CLI's, and matplotlib imported only when a plot is drawn."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("matplotlib")  # the JAX module below imports it at import time

from ssd_tpu.evaluation import visualize as jvis  # noqa: E402
from ssd_tpu_torch.evaluation import visualize as tvis  # noqa: E402
from ssd_tpu_torch.evaluation.visualize import (  # noqa: E402
    load_features,
    plot_emg,
    plot_emg_vs_teacher,
    plot_projection,
)

from .torch_procs import no_stray_processes  # noqa: E402, F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

REPO = Path(__file__).resolve().parents[1]


def test_plots_written(tmp_path):
    rng = np.random.default_rng(0)
    emg = rng.normal(size=(40, 4, 16)).astype(np.float32)
    teacher = rng.normal(size=(20, 12)).astype(np.float32)

    plot_emg(emg, tmp_path / "emg.png")
    plot_emg_vs_teacher(emg, teacher, tmp_path / "both.png")
    plot_projection(teacher, tmp_path / "proj.png")
    for name in ("emg.png", "both.png", "proj.png"):
        assert (tmp_path / name).stat().st_size > 0


def _features(tmp_path, utt="split/spk/utt0"):
    rng = np.random.default_rng(1)
    emg_dir = tmp_path / "features" / "emg" / "split" / "spk"
    tch_dir = tmp_path / "features" / "teacher" / "split" / "spk"
    emg_dir.mkdir(parents=True)
    tch_dir.mkdir(parents=True)
    np.save(emg_dir / "utt0.npy", rng.normal(size=(30, 8, 10)).astype(np.float32))
    np.save(tch_dir / "utt0.npy", rng.normal(size=(15, 12)).astype(np.float32))
    (emg_dir / "utt0.json").write_text(json.dumps({"hop_length": 10, "sample_rate": 1000}))
    (tch_dir / "utt0.json").write_text(json.dumps({"frame_stride_sec": 0.02}))
    return utt


@pytest.mark.parametrize("how", ["sys.argv", "argv"])
def test_cli_main_writes_all_artifacts(tmp_path, monkeypatch, how):
    """End-to-end main(): EMG+teacher caches with metadata sidecars → 3 PNGs."""
    utt = _features(tmp_path)
    out_dir = tmp_path / "plots"
    argv = ["--features-root", str(tmp_path / "features"), "--utterance-id", utt,
            "--out-dir", str(out_dir), "--umap"]
    if how == "sys.argv":
        monkeypatch.setattr(sys, "argv", ["visualize", *argv])
        tvis.main()
    else:
        tvis.main(argv)
    safe = utt.replace("/", "_")
    for suffix in ("emg", "emg_teacher", "teacher_umap"):
        assert (out_dir / f"{safe}_{suffix}.png").stat().st_size > 0


def test_load_features(tmp_path):
    d = tmp_path / "emg" / "split" / "s"
    d.mkdir(parents=True)
    np.save(d / "u.npy", np.zeros((5, 2, 3), np.float32))
    emg, teacher = load_features(tmp_path, "split/s/u")
    assert emg.shape == (5, 2, 3)
    assert teacher is None
    with pytest.raises(FileNotFoundError):
        load_features(tmp_path, "split/s/missing")


def test_helpers_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    for shape in ((15, 12), (64, 96), (2, 5), (1, 3)):
        frames = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(tvis._pca_2d(frames), jvis._pca_2d(frames))
    for x in (rng.normal(size=(30, 8, 10)), np.zeros((4, 3)), np.full(7, 2.5)):
        assert tvis._robust_limits(x) == jvis._robust_limits(x)
    for meta, default in (({"frame_stride_sec": 0.02}, None), ({"hop_length": 10}, None),
                          ({"hop_length": 16, "sample_rate": 2000}, None), ({}, 0.02), ({}, None),
                          ({"hop_length": 0}, 0.5)):
        assert tvis._frame_seconds(meta, default) == jvis._frame_seconds(meta, default)
    utt = _features(tmp_path)
    for kind in ("emg", "teacher", "missing"):
        assert tvis._load_meta(tmp_path / "features", kind, utt) == jvis._load_meta(
            tmp_path / "features", kind, utt)


def test_cli_flags_equal_jax(capsys, monkeypatch):
    def flags(call):
        with pytest.raises(SystemExit):
            call()
        return {w.rstrip(",") for w in capsys.readouterr().out.split() if w.startswith("--")}

    monkeypatch.setattr(sys, "argv", ["visualize", "--help"])
    assert flags(lambda: tvis._parse_args(["--help"])) == flags(jvis._parse_args)


def test_import_leaves_matplotlib_unloaded():
    probe = ("import sys, ssd_tpu_torch.evaluation.visualize as v; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'umap')))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
