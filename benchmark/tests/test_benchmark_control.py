"""The control comes out not correct: the reference put in the program's
place one precision below the configuration's (fp8 for bf16, TF32 for
fp32; for serving the engine's own int8 path) fails a number of the cell.
On the CPU at a tiny size (TF32 exists only on the card); on the card at
the cell's own size (``pytest -m cuda benchmark/tests``)."""

from __future__ import annotations

import importlib
import time

import pytest
import torch
from conftest import TINY_TRAIN, manifest, tiny_config

from benchmark import run as br

CELLS = {w["name"]: w["config"] for w in manifest(held_back=True)["workloads"]}


def control(cell: str, seed: int, device, tiny: bool):
    spec = br.load_json(br.REPO / "benchmark" / "workloads" / f"{cell}.json")
    cfg = br.load_json(br.REPO / "benchmark" / "configs" / f"{CELLS[cell]}.json")["config"]
    if tiny:  # four blocks: the fp8 error grows with depth toward the cell's twelve
        spec.update(TINY_TRAIN)
        cfg = tiny_config(CELLS[cell])
        cfg["model"]["encoder"]["num_layers"] = 4
    driver = importlib.import_module(f"benchmark.drivers.{spec['driver']}")
    ctx = br.Ctx(spec, cfg, seed, 10.0, False, device, None, time.perf_counter())
    got = driver.reading_control(ctx)
    return {k: v for k, v in got.items() if k in spec["limits"]}, spec["limits"]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fp8_control_fails_at_a_tiny_size(seed):
    got, limits = control("large_train", seed, torch.device("cpu"), tiny=True)
    assert any(v > limits[k] for k, v in got.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(w["name"] for w in manifest()["workloads"]))
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_control_fails_at_the_cells_size(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    br.fixed_caches()
    got, limits = control(cell, seed, torch.device("cuda:0"), tiny=False)
    assert any(v > limits[k] for k, v in got.items()), got
