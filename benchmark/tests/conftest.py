"""Shared pieces of the benchmark's CPU tests: the manifest, and the cells
cut to a size the CPU runs in seconds (every width but the model's own
kept in proportion; the widths themselves cut, as only these tests do)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def manifest(held_back: bool = False) -> dict:
    """``BENCHMARK.json``; with ``held_back``, together with the entries of
    the cells held back from it (``held_back.json``: their files stay
    working, so that a later change adds them back as data alone)."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    if held_back:
        extra = json.loads((Path(__file__).parent / "held_back.json").read_text())
        for group, entries in extra.items():
            have = {e["name"]: e for e in m[group]}
            for e in entries:
                if e["name"] in have:
                    have[e["name"]]["workloads"] += e["workloads"]
                else:
                    m[group].append(copy.deepcopy(e))
    return m


def config_of(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def tiny_config(name: str) -> dict:
    """A configuration's run config at a CPU test's size."""
    cfg = copy.deepcopy(config_of(name)["config"])
    cfg["model"]["encoder"].update(d_model=64, num_layers=2, num_heads=2, ffn_dim=128,
                                   depthwise_conv_kernel_size=5, input_dim=8 * 8)
    cfg["model"]["projection_dim"] = 16
    cfg["features"]["emg"]["n_mels"] = 8
    cfg["features"]["teacher"]["dim"] = 16
    return cfg


TINY_TRAIN = dict(batch_size=4, ring_batches=4, min_samples=1000, max_samples=2500,
                  total_updates=100, trace_steps=1, label_steps=1)
TINY_SERVE = dict(rate_per_s=20.0, min_samples=800, max_samples=3000, pool=8, clients=4,
                  check_requests=6, trace_seconds=0.3, label_seconds=0.3)


@pytest.fixture
def cpu():
    torch.manual_seed(0)
    return torch.device("cpu")
