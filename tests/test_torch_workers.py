"""The port's loader worker pool (``ssd_tpu_torch/data/dataset.py`` with
``num_workers > 0``, ``data/shm_slots.py``) on the CPU: batches bit-equal
to the in-process loader's and to the JAX loader's over two epochs (host
augmentation, raw EMG, bf16 teacher and EMG, a sharded loader with an empty
shard), the slots' lifetime, an abandoned iteration and ``close()``, what a
worker process imports, and a short ``train_from_config`` whose losses and
weights are bit-equal at ``num_workers: 2`` and ``0``."""

import gc
import json
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from ssd_tpu.data import augment as jaug
from ssd_tpu.data import dataset as jds
from ssd_tpu.data.vocab import default_vocab as j_vocab
from ssd_tpu_torch.data import augment as taug
from ssd_tpu_torch.data import dataset as tds
from ssd_tpu_torch.data.shm_slots import SlotPool, SlotWriter
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.training import train as ttrain
from ssd_tpu_torch.training.checkpoint import load_checkpoint

from .test_torch_data import _rows
from .test_torch_training import _corpus
from .torch_procs import no_stray_processes, stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

FIELDS = ("emg", "emg_lengths", "tokens", "token_lengths", "teacher", "teacher_lengths")

# name → (port keywords, JAX keywords), both on top of _common()
CASES = {
    "host_augment": (
        dict(spec_augment_cfg=taug.SpecAugmentConfig(p=0.7, time_mask_width=0.1),
             channel_dropout_cfg=taug.ChannelDropoutConfig(p=0.7)),
        dict(spec_augment_cfg=jaug.SpecAugmentConfig(p=0.7, time_mask_width=0.1),
             channel_dropout_cfg=jaug.ChannelDropoutConfig(p=0.7)),
    ),
    "raw": (dict(raw=True, raw_hop_length=10), dict(raw=True, raw_hop_length=10)),
    "bf16": (dict(teacher_dtype="bfloat16", emg_dtype="bfloat16"),
             dict(teacher_dtype=ml_dtypes.bfloat16, emg_dtype=ml_dtypes.bfloat16)),
    # 8 rows in global batches of 6: shard 1 of the last one is empty
    "empty_shard": (dict(num_shards=2, shard_index=1), dict(num_shards=2, shard_index=1)),
}


def _common(root):
    return dict(index_path=root / "index.jsonl", features_root=root / "features",
                splits=["voiced"], subsets=["train"], batch_size=3, shuffle=True, seed=5,
                include_teacher=True)


def _bits(a):
    """The port's transfer bits of an array: bf16 as its uint16 pattern."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _epoch(loader):
    """One epoch's batches, copied out (the worker views recycle their
    slots when dropped)."""
    out = []
    for b in loader:
        arrays = {f: None if getattr(b, f) is None else _bits(getattr(b, f)).copy()
                  for f in FIELDS}
        out.append((list(b.utterance_ids), list(b.transcripts), arrays))
    return out


def _assert_epochs_equal(a, b):
    assert len(a) == len(b) > 1
    for (ids_a, tx_a, ar_a), (ids_b, tx_b, ar_b) in zip(a, b):
        assert ids_a == ids_b and tx_a == tx_b
        for f in FIELDS:
            x, y = ar_a[f], ar_b[f]
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("case", list(CASES))
def test_worker_batches_bit_equal_to_in_process_and_to_jax(tmp_path, case):
    """Two epochs at ``num_workers: 2`` equal ``num_workers: 0`` and the
    JAX loader's, bit for bit: the shuffles differ by epoch, and every
    batch's augmentation comes from its own (seed, epoch, batch) RNG."""
    _rows(tmp_path)
    tkw, jkw = CASES[case]
    serial = tds.make_dataloader(vocab=default_vocab(), **_common(tmp_path), **tkw)
    workers = tds.make_dataloader(vocab=default_vocab(), num_workers=2, **_common(tmp_path),
                                  **tkw)
    jax_loader = jds.make_dataloader(vocab=j_vocab(), **_common(tmp_path), **jkw)
    try:
        epochs = []
        for _ in range(2):
            want = _epoch(serial)
            got = _epoch(workers)
            _assert_epochs_equal(got, want)
            _assert_epochs_equal(got, _epoch(jax_loader))
            epochs.append([ids for ids, _, _ in got])
        assert epochs[0] != epochs[1]
        if case == "empty_shard":
            assert any(ids == [] for ids in epochs[0])
        if case == "bf16":
            assert got[0][2]["teacher"].dtype == np.uint16 == got[0][2]["emg"].dtype
    finally:
        workers.close()
    workers.close()  # idempotent


def test_shm_slot_recycling():
    """The slots' lifetime (the twin of ``tests/test_dataset.py``'s): a slot
    stays taken while any view of its batch lives — a sub-view that
    outlives its array, or a tensor ``torch.from_numpy`` made of it, as the
    trainer's ``to_device`` does on the CPU — recycles when the last dies,
    grows on demand and serves again."""
    pool = SlotPool(2, initial_size=1024)
    writer = SlotWriter(pool.paths)
    try:
        s0, s1 = pool.acquire(), pool.acquire()
        a_ref = np.arange(12, dtype=np.float32).reshape(3, 4)
        arrays0 = pool.open_batch(writer.write(s0, {"a": a_ref, "b": np.array([7], np.int32)}))
        np.testing.assert_array_equal(arrays0["a"], a_ref)
        assert arrays0["b"][0] == 7
        big = np.random.default_rng(0).normal(size=600)  # 4 800 B > 1 024
        arrays1 = pool.open_batch(writer.write(s1, {"big": big}))
        np.testing.assert_array_equal(arrays1["big"], big)
        assert pool.free_slots() == 0
        sub = arrays0["a"][1:]
        tensor = ttrain.to_device({"big": arrays1["big"]}, torch.device("cpu"))["big"]
        assert tensor.data_ptr() == arrays1["big"].ctypes.data  # zero-copy
        del arrays0, arrays1
        gc.collect()
        assert pool.free_slots() == 0
        np.testing.assert_array_equal(tensor.numpy(), big)
        del sub
        gc.collect()
        assert pool.free_slots() == 1
        del tensor
        gc.collect()
        assert pool.free_slots() == 2
        arrays2 = pool.open_batch(writer.write(pool.acquire(), {"c": np.full(5, 3, np.int8)}))
        np.testing.assert_array_equal(arrays2["c"], np.full(5, 3, np.int8))
        bits = pool.open_batch(writer.write(pool.acquire(),
                                            {"t": np.arange(6, dtype=np.uint16)}))["t"]
        assert bits.dtype == np.uint16  # bf16 bit patterns travel as plain <u2
    finally:
        pool.close()


def test_abandoned_iteration_then_close(tmp_path):
    """An iteration broken off after one batch recycles its slots (the next
    full epoch is right); ``close()`` during an iteration makes the
    iterator raise instead of hanging; closing is quick; the prefetch
    thread over a worker loader stops when its consumer does."""
    import threading

    _rows(tmp_path)
    kw = dict(_common(tmp_path), shuffle=False, batch_size=1, include_teacher=False)
    loader = tds.make_dataloader(vocab=default_vocab(), num_workers=1, **kw)
    try:
        it = iter(loader)
        next(it)
        del it
        gc.collect()
        serial = _epoch(tds.make_dataloader(vocab=default_vocab(), **kw))
        _assert_epochs_equal(_epoch(loader), serial)
        gc.collect()
        assert loader._slots.free_slots() == loader.num_workers + 6
        it = iter(loader)
        next(it)
        loader.close()
        with pytest.raises(RuntimeError, match="close"):
            for _ in it:
                pass
    finally:
        t0 = time.time()
        loader.close()
        assert time.time() - t0 < 10.0
    workers = tds.make_dataloader(vocab=default_vocab(), num_workers=1, **kw)
    try:
        workers._ensure_pool()  # the pool's own threads are not the prefetch's
        n_before = threading.active_count()
        gen = tds.prefetch(workers, size=1)
        next(gen)
        gen.close()
        deadline = time.time() + 10.0
        while threading.active_count() > n_before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= n_before
    finally:
        workers.close()


def test_worker_processes_import_neither_jax_nor_cuda(tmp_path):
    """A worker loads the port's data modules on numpy alone: no JAX, no
    ``ssd_tpu``, no ``ml_dtypes``, and CUDA never starts; the workers are
    forked from the fork server, not from this process (which may hold a
    CUDA context)."""
    _rows(tmp_path)
    loader = tds.make_dataloader(vocab=default_vocab(), num_workers=1, **_common(tmp_path))
    try:
        next(iter(loader))
        probe = ("sorted(m for m in __import__('sys').modules if m.split('.')[0] in "
                 "('jax', 'jaxlib', 'flax', 'ssd_tpu', 'ml_dtypes') or m == 'torch.cuda' "
                 "and __import__('torch').cuda.is_initialized())")
        assert loader._pool.apply(eval, (probe,)) == []
        assert loader._pool.apply(eval, ("__import__('multiprocessing').current_process()"
                                         ".name.startswith('ForkServerPoolWorker')",))
        parents = loader._pool.apply(eval, ("(__import__('os').getppid(), "
                                            "__import__('os').getpid())",))
        assert parents[0] != __import__("os").getpid()
    finally:
        loader.close()


@pytest.mark.parametrize("num_workers,local_world,want",
                         [(0, 1, 0), (4, 1, 4), (4, 2, 2), (8, 4, 2), (2, 4, 1), (3, 2, 1)])
def test_workers_per_rank_split_the_host_count(num_workers, local_world, want):
    """``data.num_workers`` (else ``optim.num_workers``) is a host's count:
    each of a node's ranks starts its share, at least one."""
    for cfg in ({"data": {"num_workers": num_workers}, "optim": {}},
                {"data": {}, "optim": {"num_workers": num_workers}}):
        assert ttrain.workers_per_rank(cfg, local_world) == want


def test_training_with_workers_equals_in_process(tmp_path):
    """``train_from_config`` at ``data.num_workers: 2`` and ``0``, host
    SpecAugment and dropout on, two epochs: every logged loss and every
    trained weight bit-equal; the worker processes are gone after."""
    import multiprocessing as mp

    base = json.loads(_corpus(tmp_path).read_text())
    base["optim"]["max_epochs"] = 2
    runs = {}
    for n in (0, 2):
        cfg = json.loads(json.dumps(base))
        cfg["data"]["num_workers"] = n
        runs[n] = ttrain.train_from_config(cfg, tmp_path / f"w{n}", device="cpu")
    for h in (h for run in runs.values() for h in run["history"]):
        h["train"].pop("utterances_per_sec_per_chip")  # a rate, not a result
    assert runs[2]["history"] == runs[0]["history"]
    got = load_checkpoint(tmp_path / "w2" / "last")["state_dict"]
    want = load_checkpoint(tmp_path / "w0" / "last")["state_dict"]
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    assert not [p for p in mp.active_children() if "PoolWorker" in p.name]


def test_workers_do_not_import_the_parents_main(tmp_path):
    """A script that trains with workers is not imported again by them (a
    trainer's ``__main__`` pulls in torch and every model): the workers
    build the script's batches and never run its module body."""
    import subprocess
    import sys
    from pathlib import Path

    _rows(tmp_path)
    marker = tmp_path / "imported_by_a_worker"
    script = tmp_path / "main_script.py"
    script.write_text(f"""
import sys
from pathlib import Path
if __name__ == "__mp_main__":
    Path({str(marker)!r}).write_text("x")
sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})
from ssd_tpu_torch.data import dataset as tds
from ssd_tpu_torch.data.vocab import default_vocab

if __name__ == "__main__":
    loader = tds.make_dataloader(vocab=default_vocab(), num_workers=2,
                                 index_path={str(tmp_path / "index.jsonl")!r},
                                 features_root={str(tmp_path / "features")!r},
                                 splits=["voiced"], subsets=["train"], batch_size=3)
    print(sum(b.emg.shape[0] for b in loader))
    assert sys.modules["__main__"].__file__ == {str(script)!r}
    loader.close()
""")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 0
    assert not marker.exists()


def test_the_stray_process_guard_sees_an_open_pool(tmp_path):
    """``tests/torch_procs.py``'s guard, which every port test that starts
    processes runs after itself: an open pool's workers (forked by the fork
    server, which shares their command line) are reported; after ``close``
    nothing is, the fork server and resource tracker aside."""
    _rows(tmp_path)
    kw = dict(_common(tmp_path), shuffle=False, batch_size=1, include_teacher=False)
    before = {pid for pid, _, _ in stray_processes()}
    loader = tds.make_dataloader(vocab=default_vocab(), num_workers=2, **kw)
    try:
        next(iter(loader))
        workers = [p for p in stray_processes() if p[0] not in before]
        assert len(workers) == 2, workers
        assert all("multiprocessing.forkserver" in cmd for _, _, cmd in workers)
    finally:
        loader.close()
    deadline = time.time() + 10.0
    while [p for p in stray_processes() if p[0] not in before] and time.time() < deadline:
        time.sleep(0.05)
    assert [p for p in stray_processes() if p[0] not in before] == []
