"""A run with the timed path broken underneath comes out not correct: the
whole of a run but the look for a card, at a tiny size on the CPU, against
the limits the cells hold. One test a fault the cell can have (one card, so
no exchange between cards to leave out)."""

from __future__ import annotations

import time

import pytest
import torch
from conftest import TINY_SERVE, TINY_TRAIN, manifest, tiny_config

from benchmark import run as br
from benchmark.drivers import train as dt
from benchmark.tools.calibrate import half_rows
from ssd_tpu_torch.serving.engine import InferenceEngine
from ssd_tpu_torch.training.schedules import Optimizer

CPU = torch.device("cpu")
TRAIN = [("large_train", "scaled_large_fused"), ("fast_train", "fast_plus")]


def run(cell, config, tiny):
    return br.execute(cell, 2**34 + 9, 1.0, False, CPU, manifest(held_back=True),
                      t_start=time.perf_counter(),
                      overrides={"cell": tiny, "config": tiny_config(config)})


@pytest.mark.parametrize("cell,config", TRAIN)
def test_sound_training_run_is_correct(cell, config):
    out = run(cell, config, TINY_TRAIN)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,config", TRAIN)
def test_step_that_leaves_its_state_unchanged(cell, config, monkeypatch):
    monkeypatch.setattr(Optimizer, "step", lambda self: False)
    out = run(cell, config, TINY_TRAIN)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell,config", TRAIN)
def test_half_the_batch_left_out(cell, config, monkeypatch):
    monkeypatch.setattr(dt, "to_device", half_rows(dt.to_device))
    out = run(cell, config, TINY_TRAIN)
    assert not out["correct"], out["checks"]


def test_sound_serving_run_is_correct():
    out = run("large_serve", "scaled_large_fused", TINY_SERVE)
    assert out["correct"], out["checks"]


def test_half_the_served_batch_left_out(monkeypatch):
    real = InferenceEngine.transcribe

    def half(self, arrays):
        return real(self, arrays[: (len(arrays) + 1) // 2])

    monkeypatch.setattr(InferenceEngine, "transcribe", half)
    out = run("large_serve", "scaled_large_fused", dict(TINY_SERVE, rate_per_s=40.0))
    assert not out["correct"] and out["failed"] > 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    real = InferenceEngine.decode

    def altered(self, log_probs, out_lengths, decoder=None):
        return [t + "q" for t in real(self, log_probs, out_lengths, decoder)]

    monkeypatch.setattr(InferenceEngine, "decode", altered)
    out = run("large_serve", "scaled_large_fused", TINY_SERVE)
    assert not out["correct"] and out["checks"]["text_mismatch"]["value"] > 0


def test_a_bias_left_out_where_the_answer_is_produced(monkeypatch):
    """The seeded biases are not 0, so a served path that drops one (here
    the CTC head's) reads apart from the reference."""
    from torch.nn import functional as F

    from ssd_tpu_torch.models.heads import CTCHead

    def no_bias(self, x, train=False, generator=None):
        return F.log_softmax(self.fc(x, bias=False).float(), dim=-1)

    monkeypatch.setattr(CTCHead, "forward", no_bias)
    out = run("large_serve", "scaled_large_fused", TINY_SERVE)
    lp = out["checks"]["lp_mean"]
    assert not out["correct"] and lp["value"] > lp["limit"], out["checks"]
