"""The plain reference against the program at a tiny size on the CPU: the
same features, the same served log-probs, the same first training steps."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from conftest import TINY_TRAIN, tiny_config

from benchmark import run as br
from benchmark.drivers import train as dt
from benchmark.harness import traffic, weights
from benchmark.reference import features as ref_feat
from benchmark.reference import model as ref_model
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig, logmel_batch

CPU = torch.device("cpu")


def test_logmel_matches_the_programs_featurizer():
    g = torch.Generator().manual_seed(0)
    emg = torch.randn(3, 2560, 8, generator=g)
    lens = torch.tensor([2560, 2000, 1234])
    emg[1, 2000:] = 0
    emg[2, 1234:] = 0
    cfg = FeaturizerConfig(n_mels=80)
    want, frames, _, _ = logmel_batch(emg, lens, cfg)
    got, got_frames = ref_feat.logmel(emg, lens, 1000, 320, 10, 80)
    assert torch.equal(got_frames.to(frames.dtype), frames)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape).numpy(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("name,tol", [("fast_plus", 2e-5), ("scaled_large_fused", 3e-2)])
def test_served_log_probs_match_the_programs_model(name, tol):
    cfg = tiny_config(name)
    vocab = len(cfg["vocab"]["tokens"])
    w = weights.make(ref_model.param_layout(cfg, vocab), 3, CPU)
    model = build_model(cfg, input_dim=cfg["model"]["encoder"]["input_dim"], vocab_size=vocab)
    model.load_state_dict(w)
    model.eval()
    g = torch.Generator().manual_seed(4)
    feats = torch.randn(2, 90, cfg["model"]["encoder"]["input_dim"], generator=g)
    lens = torch.tensor([90, 61])
    with torch.no_grad():
        want, want_lens = model.ctc_log_probs(feats, lens)
        got, got_lens = ref_model.log_probs(cfg, w, feats, lens)
    assert torch.equal(got_lens, want_lens.to(got_lens.dtype))
    for b in range(2):
        n = int(got_lens[b])
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n].numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("cell,name,tol", [("fast_train", "fast_plus", 1e-4),
                                           ("large_train", "scaled_large_fused", 5e-2)])
def test_first_steps_match_the_programs_trainer(cell, name, tol):
    spec = br.load_json(br.REPO / "benchmark" / "workloads" / f"{cell}.json")
    spec.update(TINY_TRAIN)
    ctx = br.Ctx(spec, tiny_config(name), 2**35 + 1, 1.0, False, CPU, None, time.perf_counter())
    setup = dt.Setup(ctx)
    prog = setup.first_pass()
    want = dt.reference_readings(setup, prog["order"])
    gaps = dt.compare(prog, want, setup.names)
    assert gaps["loss_gap"] < tol / 10 and gaps["grad_gap"] < tol, gaps
    assert np.all(np.isfinite(want["grad_norm"])) and max(want["change_norm"]) > 0


def test_the_collate_rule_matches_the_programs():
    cfg = tiny_config("fast_plus")
    spec = dict(TINY_TRAIN, channels=8, chars_per_s=[12, 16], teacher_fps=50)
    items = traffic.train_items(spec, cfg, cfg["vocab"]["tokens"], 4, CPU)[:4]
    from ssd_tpu_torch.data.augment import SpecAugmentConfig
    from ssd_tpu_torch.data.dataset import collate
    from ssd_tpu_torch.data.vocab import Vocab

    aug = cfg["augmentation"]["specaugment"]
    prog = collate(items, Vocab(tokens=cfg["vocab"]["tokens"]),
                   spec_augment_cfg=SpecAugmentConfig(**aug), rng=traffic.rng(1, 2))
    ref = ref_feat.pad_batch(items, 0, 128, aug, traffic.rng(1, 2))
    for k in ("emg", "emg_lengths", "tokens", "token_lengths", "teacher", "teacher_lengths"):
        np.testing.assert_array_equal(getattr(prog, k), ref[k])
