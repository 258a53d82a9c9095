"""Port parity: the port's data modules (index, loader, augmentation, text
normalizer) against ``ssd_tpu.data`` on the CPU."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.data import augment as jaug
from ssd_tpu.data import dataset as jds
from ssd_tpu.data.text_normalizer import normalize_transcript as j_normalize
from ssd_tpu.data.vocab import default_vocab as j_vocab
from ssd_tpu_torch.data import augment as taug
from ssd_tpu_torch.data import dataset as tds
from ssd_tpu_torch.data.index_dataset import COLUMNS, load_index, save_index
from ssd_tpu_torch.data.text_normalizer import normalize_transcript
from ssd_tpu_torch.data.vocab import default_vocab

torch.set_num_threads(1)

TEXTS = ["Hello, World!", "I. The “quick” brown fox — jumps", "  a b  ", "42. numbers 7", "¿¡"]


def _rows(root, n=11, teacher_dim=6):
    """A JSONL corpus: cached features (T, 2, 4), teacher (T/2, D), raw EMG."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        uid = f"voiced/s1/{i}_0"
        t = int(rng.integers(20, 300))
        for kind, arr in (
            ("emg", rng.normal(size=(t, 2, 4))),
            ("teacher", rng.normal(size=(t // 2, teacher_dim))),
        ):
            p = root / "features" / kind / f"{uid}.npy"
            p.parent.mkdir(parents=True, exist_ok=True)
            np.save(p, arr.astype(np.float32))
        raw = root / "raw" / f"{i}.npy"
        raw.parent.mkdir(parents=True, exist_ok=True)
        np.save(raw, rng.normal(size=(t * 10 + 22, 2)).astype(np.float32))
        rows.append(dict(
            utterance_id=uid, split="voiced", subset="val" if i % 5 == 4 else "train",
            speaker="s1", stem=f"{i}_0", emg_path=str(raw), audio_path=None,
            transcript=TEXTS[i % len(TEXTS)] if i != 3 else "¿¡",  # one row normalizes to ""
            sentence_index=i, book="", has_audio=False, metadata_json="{}",
        ))
    save_index(rows, root / "index.jsonl")
    return rows


def test_normalize_transcript_matches_jax():
    for s in TEXTS + [None, "II. Chapter two", "tab\tand\nnewline"]:
        assert normalize_transcript(s) == j_normalize(s)


def test_jsonl_index_round_trip_without_pandas(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)  # any import of it now raises
    rows = _rows(tmp_path)
    assert list(rows[0]) == list(COLUMNS)
    assert load_index(tmp_path / "index.jsonl") == rows
    with pytest.raises(RuntimeError, match=r"\.jsonl"):
        save_index(rows, tmp_path / "index.parquet")


def _loaders(root, raw, **kw):
    common = dict(
        index_path=root / "index.jsonl", features_root=root / "features",
        splits=["voiced"], subsets=["train"], batch_size=3, shuffle=True, seed=5,
        include_teacher=True, raw=raw, **kw,
    )
    return (
        jds.make_dataloader(vocab=j_vocab(), **common),
        tds.make_dataloader(vocab=default_vocab(), **common),
    )


def _assert_same_batches(jl, tl, epochs):
    for _ in range(epochs):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl) > 1
        for a, b in zip(jb, tb):
            assert a.utterance_ids == b.utterance_ids
            assert a.transcripts == b.transcripts
            for f in ("emg", "emg_lengths", "tokens", "token_lengths", "teacher", "teacher_lengths"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)


def test_loader_batches_bit_equal_to_jax_with_host_augment(tmp_path):
    _rows(tmp_path)
    jl, tl = _loaders(
        tmp_path, raw=False,
        spec_augment_cfg=jaug.SpecAugmentConfig(p=0.7, time_mask_width=0.1),
        channel_dropout_cfg=jaug.ChannelDropoutConfig(p=0.7),
    )
    # the port's configs are its own classes; same fields
    tl.spec_augment_cfg = taug.SpecAugmentConfig(p=0.7, time_mask_width=0.1)
    tl.dataset.channel_dropout_cfg = taug.ChannelDropoutConfig(p=0.7)
    assert len(tl.dataset) == len(jl.dataset) == 8  # val rows and the empty transcript dropped
    _assert_same_batches(jl, tl, epochs=2)
    # and the epochs differ from each other
    a, b = list(tl), list(tl)
    assert [x.utterance_ids for x in a] != [x.utterance_ids for x in b]


def test_raw_loader_batches_bit_equal_to_jax(tmp_path):
    _rows(tmp_path)
    jl, tl = _loaders(tmp_path, raw=True, raw_hop_length=10)
    _assert_same_batches(jl, tl, epochs=1)
    with pytest.raises(ValueError, match="raw mode"):
        tds.make_dataloader(
            index_path=tmp_path / "index.jsonl", features_root=tmp_path / "features",
            splits=["voiced"], subsets=None, vocab=default_vocab(), batch_size=2, raw=True,
            spec_augment_cfg=taug.SpecAugmentConfig(p=0.5),
        )


def test_prefetch_yields_the_loader_batches(tmp_path):
    _rows(tmp_path)
    _, tl = _loaders(tmp_path, raw=False)
    direct = [b.utterance_ids for b in tl]
    tl.epoch = 0
    assert [b.utterance_ids for b in tds.prefetch(tl)] == direct


def test_spec_augment_equals_jax_given_its_draws():
    B, T, F = 6, 40, 16
    feats = np.random.default_rng(1).normal(size=(B, T, F)).astype(np.float32)
    lengths = np.asarray([40, 33, 20, 9, 40, 1], np.int32)
    cfg = jaug.SpecAugmentConfig(p=0.8, time_masks=2, time_mask_width=0.2, freq_masks=2, freq_mask_width=5)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jaug.spec_augment_jax(jnp.asarray(feats), jnp.asarray(lengths), cfg, key))
    k_apply, k_t, k_f = jax.random.split(key, 3)
    draws = [
        torch.from_numpy(np.array(jax.random.uniform(k, shape)))
        for k, shape in ((k_apply, (B,)), (k_t, (B, 2)), (k_f, (B, 2)))
    ]
    tcfg = taug.SpecAugmentConfig(**cfg.__dict__)
    got = taug._spec_augment_from_uniforms(torch.from_numpy(feats), torch.from_numpy(lengths), tcfg, *draws)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()
    # the generator-driven version masks at the configured rate
    out = taug.spec_augment(torch.ones(400, T, F), torch.full((400,), T), tcfg, torch.Generator().manual_seed(0))
    frac = float((out == 0).flatten(1).any(1).float().mean())
    assert 0.7 < frac < 0.9


def test_channel_dropout_equals_jax_given_its_draws():
    B, T, C, M = 8, 5, 6, 3
    feats = np.random.default_rng(2).normal(size=(B, T, C, M)).astype(np.float32)
    cfg = jaug.ChannelDropoutConfig(p=0.75, max_channels=3)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jaug.channel_dropout_jax(jnp.asarray(feats), cfg, key))
    k_apply, k_n, k_perm = jax.random.split(key, 3)
    u_apply = torch.from_numpy(np.array(jax.random.uniform(k_apply, (B,))))
    drop_n = torch.from_numpy(np.array(jax.random.randint(k_n, (B,), 1, 4)))
    scores = torch.from_numpy(np.array(jax.random.uniform(k_perm, (B, C))))
    tcfg = taug.ChannelDropoutConfig(**cfg.__dict__)
    got = taug._channel_dropout_from_uniforms(torch.from_numpy(feats), tcfg, u_apply, drop_n, scores)
    np.testing.assert_array_equal(got.numpy(), want)
    out = taug.channel_dropout(torch.ones(200, 2, C, M), tcfg, torch.Generator().manual_seed(1))
    dropped = (out == 0).all(dim=(1, 3)).sum(dim=1)  # channels zeroed per sample
    assert int(dropped.max()) <= 3 and 0.6 < float((dropped > 0).float().mean()) < 0.9
