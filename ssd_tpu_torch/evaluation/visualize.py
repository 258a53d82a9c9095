"""Qualitative plots of cached features (the port's copy of
``ssd_tpu/evaluation/visualize.py``: the same flags, file names and plots).

Per-channel images of the cached EMG log-mel tensor, an EMG-vs-teacher
comparison, and an optional 2-D projection of the teacher embedding
sequence:

* channels are laid out on a two-column grid with one shared, robust
  (percentile-clipped) color scale and a single colorbar, so channels are
  visually comparable;
* axes are labeled in seconds when the ``.json`` metadata sidecar written by
  ``ssd_tpu_torch.data.preprocessing`` is available (frame hop for EMG, 20 ms stride
  for the teacher), falling back to frame indices;
* the projection view shows the embedding *trajectory* through time (PCA via
  an eigendecomposition of the frame covariance, or UMAP when installed),
  drawing the path as well as time-colored points.

matplotlib (and umap) are imported only when a plot is drawn, so the module
imports where they are not installed; the tool reads ``.npy`` files and
never touches a device.

Usage::

    python -m ssd_tpu_torch.evaluation.visualize --features-root results/features \
        --utterance-id voiced_parallel_data/s1/0_0 [--umap]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CMAP = "magma"
_SAVE_DPI = 150


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_features(
    features_root: Path, utterance_id: str
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load the cached ``(T, C, M)`` EMG tensor and, if present, the teacher."""
    emg_path = features_root / "emg" / f"{utterance_id}.npy"
    if not emg_path.exists():
        raise FileNotFoundError(emg_path)
    emg = np.load(emg_path)
    teacher_path = features_root / "teacher" / f"{utterance_id}.npy"
    teacher = np.load(teacher_path) if teacher_path.exists() else None
    return emg, teacher


def _load_meta(features_root: Path, kind: str, utterance_id: str) -> dict:
    meta_path = features_root / kind / f"{utterance_id}.json"
    if meta_path.exists():
        try:
            return json.loads(meta_path.read_text())
        except (OSError, json.JSONDecodeError):
            pass
    return {}


def _frame_seconds(meta: dict, default: Optional[float] = None) -> Optional[float]:
    """Seconds per feature frame from a metadata sidecar, if derivable."""
    if "frame_stride_sec" in meta:
        return float(meta["frame_stride_sec"])
    hop = meta.get("hop_length")
    sr = meta.get("sample_rate", 1000)
    if hop:
        return float(hop) / float(sr)
    return default


def _robust_limits(x: np.ndarray) -> Tuple[float, float]:
    """Percentile color limits so a few hot frames don't wash out the image."""
    lo, hi = np.percentile(x, [2.0, 98.0])
    if hi <= lo:
        hi = lo + 1.0
    return float(lo), float(hi)


def _heat(ax, img_tc: np.ndarray, extent_t: float, vmin: float, vmax: float):
    """Draw a (T, bins) sequence as time-on-x heat image; returns the image."""
    return ax.imshow(
        img_tc.T,
        origin="lower",
        aspect="auto",
        interpolation="nearest",
        cmap=_CMAP,
        vmin=vmin,
        vmax=vmax,
        extent=(0.0, extent_t, 0.0, img_tc.shape[1]),
    )


def plot_emg(
    emg: np.ndarray,
    out_path: Path,
    title: str = "EMG log-mel",
    frame_sec: Optional[float] = None,
) -> None:
    """Channel grid of the (T, C, M) EMG tensor with one shared color scale."""
    n_frames, n_channels, _ = emg.shape
    vmin, vmax = _robust_limits(emg)
    extent_t = n_frames * frame_sec if frame_sec else float(n_frames)
    x_label = "Time (s)" if frame_sec else "Frame"

    n_cols = 2 if n_channels > 1 else 1
    n_rows = (n_channels + n_cols - 1) // n_cols
    plt = _pyplot()
    fig, axes = plt.subplots(
        n_rows,
        n_cols,
        figsize=(4.5 * n_cols + 1.2, 1.6 * n_rows + 0.8),
        sharex=True,
        sharey=True,
        squeeze=False,
    )
    im = None
    for ch in range(n_rows * n_cols):
        ax = axes[ch // n_cols][ch % n_cols]
        if ch >= n_channels:
            ax.axis("off")
            continue
        im = _heat(ax, emg[:, ch, :], extent_t, vmin, vmax)
        ax.text(
            0.02,
            0.85,
            f"ch {ch}",
            transform=ax.transAxes,
            color="white",
            fontsize=9,
            fontweight="bold",
        )
        if ch // n_cols == n_rows - 1:
            ax.set_xlabel(x_label)
        if ch % n_cols == 0:
            ax.set_ylabel("mel")
    fig.suptitle(title)
    fig.colorbar(im, ax=axes, shrink=0.85, label="dB (z-normed)")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=_SAVE_DPI, bbox_inches="tight")
    plt.close(fig)


def plot_emg_vs_teacher(
    emg: np.ndarray,
    teacher: np.ndarray,
    out_path: Path,
    emg_frame_sec: Optional[float] = None,
    teacher_frame_sec: Optional[float] = None,
) -> None:
    """EMG energy (summed over channels) above the teacher embedding sequence.

    Each panel gets its own robust color scale and colorbar; when frame rates
    are known both panels share a seconds axis so alignment is visible.
    """
    emg_img = emg.sum(axis=1)  # (T, M) total log-energy across channels
    seconds_known = bool(emg_frame_sec and teacher_frame_sec)
    emg_t = emg.shape[0] * emg_frame_sec if seconds_known else float(emg.shape[0])
    tch_t = (
        teacher.shape[0] * teacher_frame_sec if seconds_known else float(teacher.shape[0])
    )

    plt = _pyplot()
    fig, (ax_e, ax_t) = plt.subplots(
        2, 1, figsize=(11, 5.5), sharex=seconds_known, constrained_layout=True
    )
    lo, hi = _robust_limits(emg_img)
    im_e = _heat(ax_e, emg_img, emg_t, lo, hi)
    ax_e.set_title(f"EMG log-mel, channel sum ({emg.shape[0]} frames)")
    ax_e.set_ylabel("mel")
    fig.colorbar(im_e, ax=ax_e, pad=0.01)

    lo, hi = _robust_limits(teacher)
    im_t = _heat(ax_t, teacher, tch_t, lo, hi)
    ax_t.set_title(f"Teacher hidden states ({teacher.shape[0]} frames)")
    ax_t.set_ylabel("feature dim")
    fig.colorbar(im_t, ax=ax_t, pad=0.01)

    x_label = "Time (s)" if seconds_known else "Frame"
    ax_t.set_xlabel(x_label)
    if not seconds_known:
        ax_e.set_xlabel(x_label)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=_SAVE_DPI, bbox_inches="tight")
    plt.close(fig)


def _pca_2d(frames: np.ndarray) -> np.ndarray:
    """Project (T, D) frames onto their top-2 principal axes.

    Uses an eigendecomposition of the D×D covariance (D=768 is small), which
    avoids materialising the T×D factorisation for long utterances.
    """
    centered = frames - frames.mean(axis=0, keepdims=True)
    cov = centered.T @ centered / max(len(frames) - 1, 1)
    eigvals, eigvecs = np.linalg.eigh(cov)
    top2 = eigvecs[:, np.argsort(eigvals)[::-1][:2]]
    return centered @ top2


def plot_projection(
    teacher: np.ndarray, out_path: Path, prefer_umap: bool = True
) -> None:
    """Time-colored 2-D trajectory of the teacher embedding sequence."""
    coords = None
    method = "PCA"
    if prefer_umap:
        try:
            import umap  # type: ignore

            coords = umap.UMAP(n_components=2).fit_transform(teacher)
            method = "UMAP"
        except Exception:
            coords = None
    if coords is None:
        coords = _pca_2d(teacher)

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6.5, 5.5))
    # Faint path line first, then time-colored points on top.
    ax.plot(coords[:, 0], coords[:, 1], color="0.8", linewidth=0.7, zorder=1)
    time_frac = np.arange(len(coords)) / max(len(coords) - 1, 1)
    sc = ax.scatter(
        coords[:, 0], coords[:, 1], c=time_frac, cmap="plasma", s=14, zorder=2
    )
    fig.colorbar(sc, ax=ax, label="utterance position (0→1)")
    ax.set_title(f"Teacher embedding trajectory ({method})")
    ax.set_xlabel(f"{method} component 1")
    ax.set_ylabel(f"{method} component 2")
    ax.set_aspect("equal", adjustable="datalim")
    fig.tight_layout()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=_SAVE_DPI)
    plt.close(fig)


def _parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Visualize cached EMG/teacher features.")
    p.add_argument("--features-root", type=Path, required=True)
    p.add_argument("--utterance-id", type=str, required=True)
    p.add_argument("--out-dir", type=Path, default=Path("results/plots"))
    p.add_argument("--umap", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = _parse_args(argv)
    emg, teacher = load_features(args.features_root, args.utterance_id)
    emg_meta = _load_meta(args.features_root, "emg", args.utterance_id)
    emg_frame_sec = _frame_seconds(emg_meta)
    safe = args.utterance_id.replace("/", "_")
    plot_emg(emg, args.out_dir / f"{safe}_emg.png", frame_sec=emg_frame_sec)
    if teacher is not None:
        teacher_meta = _load_meta(args.features_root, "teacher", args.utterance_id)
        plot_emg_vs_teacher(
            emg,
            teacher,
            args.out_dir / f"{safe}_emg_teacher.png",
            emg_frame_sec=emg_frame_sec,
            teacher_frame_sec=_frame_seconds(teacher_meta, default=0.02),
        )
        if args.umap:
            plot_projection(teacher, args.out_dir / f"{safe}_teacher_umap.png")


if __name__ == "__main__":
    main()
