"""The trainer's checkpoint writer and the kernels' build cache, on the CPU.

``logging.async_checkpoints: true`` (the twin of
``tests/test_training.py::test_async_checkpoints_equivalent``): the port's
trainer writes each checkpoint on a background thread from a host copy
taken at the save, and every file it writes equals the synchronous run's —
weights, AdamW moments and steps, the update count, the accumulation window,
epoch and step — also when each write is slowed so that the next epoch
certainly trains while it is in flight (the case that fails if the copy
aliases live tensors), with gradient accumulation, on preemption and over a
2-rank gloo mesh. A failed write raises at the next save or at
``finalize``.

``--compile-cache`` / ``$SSD_COMPILE_CACHE``: the flag over the variable
over ``ssd_tpu_torch/_build/``; the g++ host library built into and loaded
from the cache; an unwritable cache raises; each CLI points the cache.
"""

import json
import os
import shutil
import threading
import time
from pathlib import Path

import pytest
import torch

from ssd_tpu_torch.evaluation import evaluate as teval
from ssd_tpu_torch.serving import server as tserver
from ssd_tpu_torch.training import checkpoint as ckpt
from ssd_tpu_torch.training import schedules as tsched
from ssd_tpu_torch.training import train as ttrain
from ssd_tpu_torch.utils import cuda_build, native

from .test_torch_logging import restored_logging
from .test_torch_parallel import _close, _flat
from .test_torch_training import _corpus
from .torch_parallel_worker import run_group
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

SLOW_WRITE_S = 0.5  # longer than a tiny epoch on the CPU


def _cfg(root: Path, epochs: int = 2, grad_accum: int = 1, asynchronous: bool = False) -> dict:
    cfg = json.loads(_corpus(root).read_text())
    cfg["optim"].update(max_epochs=epochs, grad_accum=grad_accum, num_workers=0)
    cfg["logging"]["async_checkpoints"] = asynchronous
    return cfg


def _record_writes(monkeypatch, delay: float = 0.0) -> list:
    """Route every checkpoint write through a recorder that sleeps
    ``delay`` s first, then keeps a copy of the files it wrote (``last``
    is rewritten every epoch); returns the list of writes, in order."""
    writes = []
    real = ckpt._write_payload

    def write(run_dir, payload, cfg_text, is_best):
        time.sleep(delay)
        real(run_dir, payload, cfg_text, is_best)
        kept = run_dir / "kept" / str(sum(w["run"] == run_dir for w in writes))
        names = ("last", "best") if is_best else ("last",)
        for name in names:
            (kept / name).mkdir(parents=True)
            shutil.copy(run_dir / name / ckpt.MODEL_FILE, kept / name / ckpt.MODEL_FILE)
        writes.append(dict(run=run_dir, thread=threading.current_thread().name,
                           epoch=payload.get("epoch"), names=names, kept=kept))

    monkeypatch.setattr(ckpt, "_write_payload", write)
    return writes


def _assert_same(a, b, where: str = "payload") -> None:
    """``a`` and ``b`` equal leaf for leaf, tensors by ``torch.equal``."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _assert_run_complete(run: Path) -> None:
    """Every file of a finished run is there and whole, nothing half-written."""
    for name in ("last", "best"):
        assert ckpt.load_checkpoint(run / name)["format"] == ckpt.FORMAT
    assert json.loads((run / "config.json").read_text())["logging"]["run_name"] == "tiny"
    assert not list(run.rglob("*.tmp"))


@pytest.mark.parametrize("case", ["plain", "slowed", "grad_accum"])
def test_async_checkpoints_equivalent(tmp_path, monkeypatch, case):
    """2 epochs sync, then async: every save's ``last`` and ``best`` equal."""
    writes = _record_writes(monkeypatch, delay=SLOW_WRITE_S if case == "slowed" else 0.0)
    accum = 3 if case == "grad_accum" else 1
    runs = {}
    for asynchronous in (False, True):
        name = "async" if asynchronous else "sync"
        cfg = _cfg(tmp_path / name, grad_accum=accum, asynchronous=asynchronous)
        summary = ttrain.train_from_config(cfg, tmp_path / name / "run", device="cpu")
        assert summary["epochs"] == 2 and not summary["preempted"]
        _assert_run_complete(tmp_path / name / "run")  # landed before the trainer returned
        runs[name] = [w for w in writes if w["run"] == (tmp_path / name / "run").resolve()]
    sync, asyn = runs["sync"], runs["async"]
    assert [w["epoch"] for w in sync] == [w["epoch"] for w in asyn] == [1, 2]
    assert [w["names"] for w in sync] == [w["names"] for w in asyn]
    main = threading.main_thread().name
    assert {w["thread"] for w in sync} == {main}
    assert all(w["thread"].startswith("checkpoint-writer") for w in asyn)
    for s, a in zip(sync, asyn):
        for name in s["names"]:
            got = ckpt.load_checkpoint(a["kept"] / name)
            want = ckpt.load_checkpoint(s["kept"] / name)
            _assert_same(got, want, f"epoch {s['epoch']} {name}")
            assert got["step"] == want["step"] > 0
            opt = got["optimizer"]
            assert opt["adamw"]["state"] and opt["update_count"] > 0
            if case == "grad_accum":
                assert opt["mini_step"] == 0 and len(opt["acc"]) == len(opt["adamw"]["state"])
    for name in ("last", "best"):
        _assert_same(ckpt.load_checkpoint(tmp_path / "async" / "run" / name),
                     ckpt.load_checkpoint(tmp_path / "sync" / "run" / name), name)


def test_writer_snapshots_the_optimizer_and_an_open_accumulation_window(tmp_path, monkeypatch):
    """The writer, called directly, with AdamW moments and an open
    accumulation window that the caller updates in place while the slowed
    write is in flight: the files hold the state as it was at ``save``."""
    writes = _record_writes(monkeypatch, delay=SLOW_WRITE_S)
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Linear(5, 3)
    opt = tsched.Optimizer(list(model.parameters()), lambda n: 1e-2, grad_accum=3)

    def micro_step():
        model(torch.randn(4, 5, generator=gen)).square().sum().backward()
        opt.step()
        opt.zero_grad()

    for _ in range(4):  # one update, then a window of one micro-step
        micro_step()
    assert opt.update_count == 1 and opt.mini_step == 1
    want_sd = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = opt.state_dict()
    want_opt = {**want_opt, "acc": [a.clone() for a in want_opt["acc"]], "adamw": {
        **want_opt["adamw"], "state": {i: {k: v.clone() for k, v in st.items()}
                                       for i, st in want_opt["adamw"]["state"].items()}}}
    writer = ckpt.CheckpointWriter(async_saves=True)
    writer.save(tmp_path, model.state_dict(), {"run": 1}, is_best=True,
                optimizer=opt.state_dict(), epoch=3, step=4)
    assert not writes  # still sleeping: the caller goes on
    for _ in range(2):  # closes the window (acc zeroed) and moves every moment
        micro_step()
    assert opt.update_count == 2 and not torch.equal(model.weight, want_sd["weight"])
    writer.finalize()
    assert len(writes) == 1 and writes[0]["names"] == ("last", "best")
    for name in ("last", "best"):
        got = ckpt.load_checkpoint(tmp_path / name)
        _assert_same(got["state_dict"], want_sd, name)
        _assert_same(got["optimizer"], want_opt, name)
        assert (got["epoch"], got["step"], got["optimizer"]["mini_step"]) == (3, 4, 1)
    assert json.loads((tmp_path / "config.json").read_text()) == {"run": 1}


@pytest.mark.parametrize("surfaces", ["next_save", "finalize", "sync"])
def test_a_failed_write_raises_and_leaves_nothing_saved(tmp_path, surfaces):
    """``last`` is a file where the writer needs a directory: the write
    fails on the writer's thread and raises at the next ``save`` or at
    ``finalize`` (at once when synchronous), once; no model file or
    ``config.json`` makes the run look saved."""
    (tmp_path / "last").write_text("in the way")
    writer = ckpt.CheckpointWriter(async_saves=surfaces != "sync")
    sd = torch.nn.Linear(2, 2).state_dict()
    if surfaces == "sync":
        with pytest.raises(OSError):
            writer.save(tmp_path, sd, {})
    else:
        writer.save(tmp_path, sd, {})  # returns: the write runs behind it
        with pytest.raises(OSError):
            if surfaces == "next_save":
                writer.save(tmp_path, sd, {})
            else:
                writer.finalize()
    writer.finalize()  # raised once, not again
    assert sorted(p.name for p in tmp_path.iterdir()) == ["last"]
    assert (tmp_path / "last").read_text() == "in the way"


def _preempted_then_resumed(root: Path, monkeypatch, asynchronous: bool) -> tuple:
    """3 epochs with gradient accumulation, stopped after the first train
    step of epoch 2 (an open window), then ``--resume`` to the end."""
    guards = []

    class Guard(ttrain.PreemptionGuard):
        def __enter__(self):
            guards.append(self)
            return super().__enter__()

    make = ttrain.make_train_step

    def make_signalled(*args, **kwargs):
        step = make(*args, **kwargs)
        calls = []

        def signalled(*a, **k):
            out = step(*a, **k)
            calls.append(1)
            if len(calls) == 3:  # epoch 1: 2 steps; the first of epoch 2
                guards[-1].requested = True
            return out

        return signalled

    cfg = _cfg(root, epochs=3, grad_accum=2, asynchronous=asynchronous)
    with monkeypatch.context() as m:
        m.setattr(ttrain, "PreemptionGuard", Guard)
        m.setattr(ttrain, "make_train_step", make_signalled)
        stopped = ttrain.train_from_config(cfg, root / "run", device="cpu")
    preempted = ckpt.load_checkpoint(root / "run" / "last")
    resumed = ttrain.train_from_config(cfg, root / "run", resume=True, device="cpu")
    return stopped, preempted, resumed, ckpt.load_checkpoint(root / "run" / "last")


def test_preemption_waits_and_leaves_a_resumable_last(tmp_path, monkeypatch):
    writes = _record_writes(monkeypatch)
    sync = _preempted_then_resumed(tmp_path / "sync", monkeypatch, False)
    asyn = _preempted_then_resumed(tmp_path / "async", monkeypatch, True)
    stopped, preempted, resumed, final = asyn
    assert stopped["preempted"] and [h["epoch"] for h in stopped["history"]] == [1]
    # the preemption save (epoch 1's label, 3 micro-steps, the window open)
    # is written on the training thread, after epoch 1's write has landed
    assert (preempted["epoch"], preempted["step"], preempted["optimizer"]["mini_step"]) == (1, 3, 1)
    ran = [w for w in writes if w["run"] == (tmp_path / "async" / "run").resolve()]
    assert [w["epoch"] for w in ran[:2]] == [1, 1]
    assert ran[0]["thread"].startswith("checkpoint-writer")
    assert ran[1]["thread"] == threading.main_thread().name
    assert [h["epoch"] for h in resumed["history"]] == [2, 3] and final["epoch"] == 3
    for i in (1, 3):  # the preempted and the final `last`
        _assert_same(asyn[i], sync[i])


def test_two_rank_async_checkpoints_are_written_by_rank_0_alone(tmp_path, monkeypatch):
    """DP + FSDP over 2 gloo ranks, 2 epochs sync then async: rank 0's
    writer thread writes every file, rank 1 none; the files equal the
    synchronous ones, and epoch 1's equal one process's at the tolerance of
    ``tests/test_torch_parallel.py`` (set for one epoch)."""
    cfg = _flat(_cfg(tmp_path / "one"))
    _record_writes(monkeypatch)
    ttrain.train_from_config(cfg, tmp_path / "one" / "run", device="cpu")
    jobs = [dict(name=name, kind="writes", run_dir=str(tmp_path / name),
                 cfg=dict(cfg, parallel={"fsdp": True},
                          logging=dict(cfg["logging"], async_checkpoints=name == "async")))
            for name in ("sync", "async")]
    ranks = run_group(jobs, tmp_path / "group")
    assert ranks[1]["sync"]["writes"] == ranks[1]["async"]["writes"] == []
    assert [w[1:] for w in ranks[0]["async"]["writes"]] == \
        [w[1:] for w in ranks[0]["sync"]["writes"]]
    assert {w[0] for w in ranks[0]["sync"]["writes"]} == {"MainThread"}
    assert all(w[0].startswith("checkpoint-writer") for w in ranks[0]["async"]["writes"])
    for name in ("last", "best"):
        _assert_same(ckpt.load_checkpoint(tmp_path / "async" / name),
                     ckpt.load_checkpoint(tmp_path / "sync" / name), name)
    _close(tmp_path / "async" / "kept" / "0" / "last", tmp_path / "one" / "run" / "kept" / "0" / "last")


# ------------------------------------------------------------ compile cache


@pytest.fixture
def cache_env(monkeypatch):
    """``$SSD_COMPILE_CACHE`` unset for the test and as it was after it
    (``delenv`` alone records nothing to undo for an unset variable)."""
    monkeypatch.setenv(cuda_build.CACHE_ENV, "")
    monkeypatch.delenv(cuda_build.CACHE_ENV)
    return monkeypatch


@pytest.mark.parametrize("flag,env,want", [
    ("flag", "env", "flag"), (None, "env", "env"), (None, None, None)])
def test_compile_cache_flag_over_env_over_default(tmp_path, cache_env, flag, env, want):
    """The flag over the variable over the package's ``_build/``; a cache
    asked for is created and exported, the default is left alone."""
    cache_env.setattr(cuda_build, "BUILD_DIR", tmp_path / "pkg" / "_build")
    if env:
        cache_env.setenv(cuda_build.CACHE_ENV, str(tmp_path / env))
    got = cuda_build.enable_compile_cache(tmp_path / flag if flag else None)
    want = (tmp_path / want) if want else cuda_build.BUILD_DIR
    assert got == str(want) and want.is_dir() == bool(want != cuda_build.BUILD_DIR)
    assert os.environ.get(cuda_build.CACHE_ENV) == (str(want) if flag or env else None)
    assert cuda_build.build_dir() == want
    lib = cuda_build.CudaLibrary("x", "ctc.cu", {}, "err")
    assert lib.library_path().parent == want


def test_a_relative_compile_cache_is_exported_absolute(tmp_path, cache_env):
    """A relative ``$SSD_COMPILE_CACHE`` is the one path checked, built in
    and handed to child processes, whatever their working directory."""
    cache_env.chdir(tmp_path)
    cache_env.setenv(cuda_build.CACHE_ENV, "rel")
    got = cuda_build.enable_compile_cache()
    assert got == str(tmp_path / "rel") == os.environ[cuda_build.CACHE_ENV]
    cache_env.chdir(tmp_path / "rel")
    assert cuda_build.build_dir() == tmp_path / "rel"


def test_host_library_builds_into_and_loads_from_the_cache(tmp_path, cache_env):
    cache_env.setattr(native, "_lib", None)  # this process's library, put back after
    cache = Path(cuda_build.enable_compile_cache(tmp_path / "cache"))
    assert cache == (tmp_path / "cache").resolve()
    path = native.library_path()
    assert path.parent == cache and not path.exists()
    lib = native.load()
    assert path.exists() and Path(lib._name) == path and native.load() is lib
    assert sorted(p.name for p in cache.iterdir()) == [path.name]


def test_an_unwritable_compile_cache_raises(tmp_path, cache_env):
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError, match="--compile-cache DIR"):
        cuda_build.enable_compile_cache(tmp_path / "file" / "cache")
    assert cuda_build.CACHE_ENV not in os.environ


def test_an_unwritable_default_raises_only_when_a_build_needs_it(tmp_path, cache_env):
    """A read-only install starts: the default is not checked until a
    build needs it, and that build's error names ``--compile-cache``."""
    (tmp_path / "file").write_text("")
    cache_env.setattr(cuda_build, "BUILD_DIR", tmp_path / "file" / "_build")
    assert cuda_build.enable_compile_cache() == str(cuda_build.BUILD_DIR)
    cache_env.setattr(native, "_lib", None)  # this process's library, put back after
    with pytest.raises(OSError, match="--compile-cache DIR"):
        native.load()


class _Called(Exception):
    pass


@pytest.mark.parametrize("cli", ["train", "evaluate", "server"])
def test_each_cli_points_the_compile_cache(tmp_path, cache_env, cli):
    """Each CLI's ``main`` hands ``--compile-cache`` to
    ``enable_compile_cache`` before it loads anything."""
    seen = []

    def enable(path):
        seen.append(path)
        raise _Called

    module = {"train": ttrain, "evaluate": teval, "server": tserver}[cli]
    cache_env.setattr(module, "enable_compile_cache", enable)
    cache_env.setattr("ssd_tpu_torch.utils.config.setup_cli_logging", lambda: None)
    argv = {"train": ["--config", "c.json"], "evaluate": ["--checkpoint", "ck"],
            "server": ["--checkpoint", "ck"]}[cli] + [
        "--compile-cache", str(tmp_path / "cache"), "--device", "cpu"]
    with restored_logging(), pytest.raises(_Called):
        if cli == "server":
            cache_env.setattr("sys.argv", ["server", *argv])
            module.main()
        else:
            module.main(argv)
    assert seen == [tmp_path / "cache"]
