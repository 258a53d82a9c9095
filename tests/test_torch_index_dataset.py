"""The port's indexing CLI (``ssd_tpu_torch/data/index_dataset.py``) against
the JAX package's on ``tests/test_index_dataset.py``'s fake corpus layout:
the same rows, subsets, summaries and ``--stats --durations`` text, the MD5
split, and a JSONL manifest read and written without pandas."""

import hashlib
import json
import sys

import pytest

from ssd_tpu.data import index_dataset as jidx
from ssd_tpu_torch.data import index_dataset as tidx

from .test_index_dataset import _write_sample, fake_root  # noqa: F401  (fixture)
from .test_torch_logging import restored_logging

ALL_SPLITS = list(tidx.SPLIT_PATHS)


def _jax_rows(df):
    rows = df.to_dict("records")
    for r in rows:  # pandas turns a missing audio path into None or NaN
        if not isinstance(r["audio_path"], str):
            r["audio_path"] = None
    return rows


@pytest.mark.parametrize("splits", [tidx.DEFAULT_SPLITS, ALL_SPLITS, ["voiced_parallel_data"]],
                         ids=["default", "all", "voiced"])
def test_build_index_matches_jax(fake_root, splits):  # noqa: F811
    got = tidx.build_index(fake_root, splits)
    want = _jax_rows(jidx.build_index(fake_root, splits))
    assert got == want
    assert [list(r) for r in got] == [list(tidx.COLUMNS)] * len(got)
    assert {r["stem"] for r in got} >= {"0_0", "0_1"}
    assert next(r for r in got if r["stem"] == "0_0")["audio_path"].endswith("_audio_clean.flac")


def test_assign_subset_md5_parity():
    for split in ("voiced_parallel_data", "silent_parallel_data"):
        for i in range(200):
            uid = f"{split}/s{i % 7}/{i}_{i}"
            h = int(hashlib.md5(uid.encode()).hexdigest(), 16) % 100
            expected = "train" if h < 80 else ("val" if h < 90 else "test")
            assert tidx.assign_subset(split, uid) == expected == jidx.assign_subset(split, uid)
    for split in ("closed_vocab_voiced", "closed_vocab_silent", "nonparallel_data"):
        assert tidx.assign_subset(split, "x") == jidx.assign_subset(split, "x")


@pytest.mark.parametrize("durations", [False, True])
def test_summary_matches_jax(fake_root, durations):  # noqa: F811
    got = tidx.summarize_index(tidx.build_index(fake_root, ALL_SPLITS), fake_root, durations)
    want = jidx.summarize_index(jidx.build_index(fake_root, ALL_SPLITS), fake_root, durations)
    assert got == want
    assert tidx._format_summary(got) == jidx._format_summary(want)
    if durations:
        assert got["voiced_parallel_data"]["mean_duration_sec"] == pytest.approx(2.0)


def test_cli_stats_text_matches_jax(fake_root, tmp_path, monkeypatch, capsys):  # noqa: F811
    """``--root --out --stats --durations``: the manifest and the printed
    text equal the JAX CLI's; an existing output needs ``--overwrite``;
    ``--index --stats`` reads it back."""
    monkeypatch.setattr("ssd_tpu.utils.config.setup_cli_logging", lambda: None)
    argv = ["--root", str(fake_root), "--stats", "--durations", "--splits"] + ALL_SPLITS
    monkeypatch.setattr(sys, "argv", ["index", "--out", str(tmp_path / "jax.jsonl")] + argv)
    with restored_logging():
        jidx.main()
    want = capsys.readouterr().out
    with restored_logging():
        tidx.main(["--out", str(tmp_path / "torch.jsonl")] + argv)
    got = capsys.readouterr().out
    assert got == want and "voiced_parallel_data: 2 utterances (2 with audio)" in got
    assert tidx.load_index(tmp_path / "torch.jsonl") == tidx.load_index(tmp_path / "jax.jsonl")
    with pytest.raises(SystemExit, match="overwrite"), restored_logging():
        tidx.main(["--out", str(tmp_path / "torch.jsonl")] + argv)
    with restored_logging():
        tidx.main(["--index", str(tmp_path / "torch.jsonl"), "--stats"])
    assert capsys.readouterr().out.splitlines()[0].startswith("closed_vocab_voiced: 1 utterances")
    with pytest.raises(SystemExit, match="Nothing to do"), restored_logging():
        tidx.main([])
    with pytest.raises(SystemExit, match="zero entries"), restored_logging():
        tidx.main(["--root", str(tmp_path / "empty"), "--out", str(tmp_path / "e.jsonl")])


def test_jsonl_round_trip_without_pandas(fake_root, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setitem(sys.modules, "pandas", None)  # import pandas raises
    rows = tidx.build_index(fake_root, ALL_SPLITS)
    tidx.save_index(rows, tmp_path / "idx.jsonl")
    assert tidx.load_index(tmp_path / "idx.jsonl") == rows
    lines = (tmp_path / "idx.jsonl").read_text().splitlines()
    assert [json.loads(line)["utterance_id"] for line in lines] == [r["utterance_id"] for r in rows]
    with pytest.raises(RuntimeError, match="jsonl"):
        tidx.save_index(rows, tmp_path / "idx.parquet")


def test_parquet_written_by_jax_reads_back(fake_root, tmp_path):  # noqa: F811
    jidx.save_index(jidx.build_index(fake_root, ALL_SPLITS), tmp_path / "idx.parquet")
    got = tidx.load_index(tmp_path / "idx.parquet")
    for r in got:
        if not isinstance(r["audio_path"], str):
            r["audio_path"] = None
    assert got == tidx.build_index(fake_root, ALL_SPLITS)


def test_build_index_empty_and_unknown_split(tmp_path):
    assert tidx.build_index(tmp_path, ["voiced_parallel_data"]) == []
    with pytest.raises(ValueError, match="Unknown split"):
        tidx.build_index(tmp_path, ["nope"])
    _write_sample(tmp_path / "nonparallel_data", "s2", "9_9")
    (row,) = tidx.build_index(tmp_path, ["nonparallel_data"])
    assert row["subset"] == "unused"
