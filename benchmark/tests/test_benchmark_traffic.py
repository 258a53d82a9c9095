"""The traffic made from the seed: the same twice, the same work for every
seed, and batched by the loader's rule."""

from __future__ import annotations

import numpy as np
import torch
from conftest import TINY_SERVE, TINY_TRAIN, tiny_config

from benchmark.harness import traffic
from ssd_tpu_torch.data.dataset import DataLoader

CPU = torch.device("cpu")
CELL = dict(TINY_TRAIN, channels=8, chars_per_s=[12, 16], teacher_fps=50)


def items(seed, cfg_name="scaled_large_fused"):
    cfg = tiny_config(cfg_name)
    return traffic.train_items(CELL, cfg, cfg["vocab"]["tokens"], seed, CPU)


def test_train_items_repeat_from_the_seed():
    a, b = items(2**40 + 3), items(2**40 + 3)
    for x, y in zip(a, b):
        assert x["transcript"] == y["transcript"]
        for k in ("emg", "teacher", "tokens"):
            np.testing.assert_array_equal(x[k], y[k])


def test_every_seed_gets_the_same_sizes():
    a, b = items(1), items(2)
    assert sorted(len(x["emg"]) for x in a) == sorted(len(x["emg"]) for x in b)
    assert [x["transcript"] for x in a] != [x["transcript"] for x in b]
    due1, _ = traffic.arrivals(50.0, 4.0, 8, 1)
    due2, _ = traffic.arrivals(50.0, 4.0, 8, 2)
    assert len(due1) == len(due2)
    # the same gaps in another order: all but the one after the last arrival
    assert np.isin(np.round(np.diff(due1), 12), np.round(np.diff(due2), 12)).sum() >= len(due1) - 2


def test_cached_items_are_feature_frames_and_transcripts_fit():
    cfg = tiny_config("fast_plus")
    its = items(5, "fast_plus")
    femg = cfg["features"]["emg"]
    for it in its:
        assert it["emg"].shape[1] == 8 * femg["n_mels"]
        frames = len(it["emg"])
        # 12–16 characters a second of EMG; CTC needs fewer labels than frames
        assert 0 < len(it["tokens"]) < frames // 2
        assert it["transcript"] == it["transcript"].strip()


def test_arrivals_keep_their_rate_and_window():
    due, picks = traffic.arrivals(300.0, 10.0, 256, 11)
    assert due[0] == 0.0 and due[-1] < 10.0
    assert abs(len(due) / 10.0 - 300.0) < 3.0
    assert set(picks.tolist()) <= set(range(256))


class _Lengths:
    def __init__(self, lengths):
        self.lengths = lengths

    def __len__(self):
        return len(self.lengths)

    def feature_length(self, i):
        return self.lengths[i]


def test_ring_shapes_follow_the_loaders_rule():
    lengths = [int(x) for x in traffic.stratified(481, 993, 512, traffic.rng(3))]
    ours = traffic.ring_groups(lengths, 32, 128, traffic.rng(4))
    loader = DataLoader(_Lengths(lengths), batch_size=32, shuffle=True, time_bucket=128)
    theirs = loader._epoch_batches(np.random.default_rng(5))

    def shapes(groups):
        return sorted(traffic.round_up(max(lengths[i] for i in g), 128) for g in groups)

    assert shapes(ours) == shapes(theirs)
    assert sorted(i for g in ours for i in g) == list(range(512))


def test_serve_pool_spans_the_cell_lengths():
    pool = traffic.serve_pool(dict(TINY_SERVE, channels=8), 9, CPU)
    lens = sorted(len(a) for a in pool)
    assert TINY_SERVE["min_samples"] <= lens[0] and lens[-1] <= TINY_SERVE["max_samples"]
    assert all(a.shape[1] == 8 and a.dtype == np.float32 for a in pool)
