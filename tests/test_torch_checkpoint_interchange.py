"""Checkpoint interchange between the JAX package's orbax runs and the
port's ``model.pt`` (``scripts/convert_checkpoint.py`` over
``ssd_tpu_torch/models/flax_bridge.py``), optimizer state included:

* a JAX run saved mid-way (the trainer's payload; with ``grad_accum`` 2 an
  accumulation window open) and converted ``--from-jax`` resumes in the port
  on the same batches with the JAX run's losses and weights, within
  ``tests/test_torch_training.py``'s tolerances; the port's state converted
  back ``--from-torch`` restores under the JAX trainer's topology-checked
  target and takes the next JAX step as the JAX run's own state does; the
  port trainer's ``--resume`` continues the converted run;
* a port-trained checkpoint converted ``--from-torch`` (unrolled and
  ``scan_layers``) evaluates in ``ssd_tpu.evaluation.evaluate`` to the port
  eval CLI's greedy text, and converting it back gives the same tensors,
  optimizer state and counters bit for bit; the bridge's two directions
  give a flax tree back bit for bit."""

import copy
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.evaluation import evaluate as jeval
from ssd_tpu.models.conformer import stack_block_tree
from ssd_tpu.training import checkpoint as jckpt
from ssd_tpu.training import train as jtrain
from ssd_tpu_torch.evaluation import evaluate as teval
from ssd_tpu_torch.models import flax_bridge
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.training import checkpoint as tckpt
from ssd_tpu_torch.training import schedules as tsched
from ssd_tpu_torch.training import train as ttrain

from .helpers import make_tiny_setup
from .test_torch_logging import restored_logging
from .test_torch_models import _variables
from .test_torch_training import (BLANK, IN_DIM, LAMBDAS, LOSS_RTOL, TEACHER_DIM, VOCAB,
                                  _assert_tree_close, _batch, _cfg, _jax_setup, _port_tree,
                                  _to_torch)
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SAVED_AT, RESUMED = 3, 2  # JAX micro-steps before the save, then after it on both sides
PARAM_ATOL, BN_MEAN_ATOL = 5e-5, 5e-4  # test_three_train_steps_match_jax's


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", REPO / "scripts" / "convert_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


convert = _load_script()


def _convert(*argv):
    with restored_logging():
        convert.main([str(a) for a in argv])


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX model, optimizer, initial state and compiled train step per
    ``grad_accum`` (the initial state is copied for each use: the step
    donates its input)."""
    cache = {}

    def get(grad_accum):
        if grad_accum not in cache:
            jmodel, tx, state = _jax_setup(_cfg(grad_accum))
            step = jtrain.make_train_step(jmodel, tx, BLANK, False)
            cache[grad_accum] = (jmodel, tx, state, step)
        jmodel, tx, state, step = cache[grad_accum]
        return jmodel, tx, jax.tree_util.tree_map(jnp.array, state), step

    return get


def _run_cfg(root, grad_accum):
    """The train-step tests' model and optimizer over make_tiny_setup's
    corpus (16 input features, the 48-symbol vocab, teacher dim 32): two
    train utterances at batch 1, two epochs."""
    tiny, _, _ = make_tiny_setup(root, teacher_dim=TEACHER_DIM)
    cfg = dict(tiny, **_cfg(grad_accum))
    cfg["optim"] = dict(cfg["optim"], batch_size=1, max_epochs=2)
    cfg.pop("augmentation")
    return cfg


def _bn_split(model):
    names = set(model.state_dict())
    means = {n for n in names if n.endswith(".bn.mean")}
    return names - means, means


def _payload(state, epoch):
    """The JAX trainer's checkpoint payload."""
    return {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "epoch": np.asarray(epoch),
            "step": np.asarray(state.step)}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_jax_run_resumes_in_the_port_and_back(tmp_path, jax_runs, monkeypatch, grad_accum):
    cfg = _run_cfg(tmp_path, grad_accum)
    jmodel, tx, jstate, jstep = jax_runs(grad_accum)
    batches = [_batch(0), _batch(1)]
    jbatch = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    lam, rng = jnp.asarray(LAMBDAS, jnp.float32), jax.random.key(2, impl="rbg")
    for i in range(SAVED_AT):
        jstate, _ = jstep(jstate, jbatch[i % 2], lam, rng)
    jckpt.save_checkpoint(tmp_path / "jax_run", _payload(jstate, 1), cfg)
    jlosses = []
    for i in range(SAVED_AT, SAVED_AT + RESUMED):
        jstate, jl = jstep(jstate, jbatch[i % 2], lam, rng)
        jlosses.append(jl)

    _convert("--from-jax", tmp_path / "jax_run" / "last", "--output", tmp_path / "port_run")
    assert (json.loads((tmp_path / "port_run" / "config.json").read_text())
            == json.loads((tmp_path / "jax_run" / "config.json").read_text()))
    payload = tckpt.load_checkpoint(tmp_path / "port_run" / "last")
    opt = payload["optimizer"]
    assert (payload["epoch"], payload["step"]) == (1, SAVED_AT)
    assert (opt["update_count"], opt["mini_step"]) == divmod(SAVED_AT, grad_accum)
    assert (opt["acc"] is None) == (grad_accum == 1)
    if grad_accum > 1:  # an open window: a non-zero running mean
        assert any(float(a.abs().max()) > 0 for a in opt["acc"])

    # resume as the trainer's --resume does, on the JAX run's next batches
    model = build_model(cfg, IN_DIM, VOCAB)
    model.load_state_dict(payload["state_dict"])
    optimizer, _ = tsched.build_optimizer(cfg, model.parameters(), 10)
    optimizer.load_state_dict(payload["optimizer"])
    state = ttrain.TrainState(model=model, optimizer=optimizer)
    state.step = payload["step"]
    tstep = ttrain.make_train_step(BLANK, False)
    for i, jl in zip(range(SAVED_AT, SAVED_AT + RESUMED), jlosses):
        state, tl = tstep(state, _to_torch(batches[i % 2]), LAMBDAS, None)
        for k in ("total", "ctc", "distill"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=LOSS_RTOL,
                                       err_msg=f"{k} step {i}")
    want = _port_tree(state.model, jstate.params, jstate.batch_stats)
    params, means = _bn_split(state.model)
    _assert_tree_close(state.model, want, atol=PARAM_ATOL, keys=params)
    _assert_tree_close(state.model, want, atol=BN_MEAN_ATOL, keys=means)
    assert (state.optimizer.update_count, state.optimizer.mini_step) == divmod(
        SAVED_AT + RESUMED, grad_accum)

    # … and back: the JAX trainer's --resume target restores the port's state
    tckpt.save_checkpoint(tmp_path / "port_run2", state.model.state_dict(), cfg,
                          optimizer=state.optimizer.state_dict(), epoch=1, step=state.step)
    _convert("--from-torch", tmp_path / "port_run2" / "last", "--output", tmp_path / "jax_run2")
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype), _payload(jstate, 0))
    restored = jckpt.load_checkpoint(tmp_path / "jax_run2" / "last", target=abstract)
    assert int(restored["step"]) == int(jstate.step) == SAVED_AT + RESUMED
    for got, want_leaf in zip(jax.tree_util.tree_leaves(restored["opt_state"]),
                              jax.tree_util.tree_leaves(jstate.opt_state)):
        assert got.dtype == want_leaf.dtype and got.shape == want_leaf.shape
        if got.ndim == 0:  # the counts and the window position
            assert int(got) == int(want_leaf)
    back = jtrain.TrainState(params=restored["params"], batch_stats=restored["batch_stats"],
                             opt_state=restored["opt_state"], step=jnp.asarray(restored["step"]))
    # the next JAX step from the port's state and from the JAX run's own
    i = SAVED_AT + RESUMED
    back, lb = jstep(back, jbatch[i % 2], lam, rng)
    jstate, lj = jstep(jstate, jbatch[i % 2], lam, rng)
    for k in ("total", "ctc", "distill"):
        np.testing.assert_allclose(float(lb[k]), float(lj[k]), rtol=LOSS_RTOL, err_msg=k)
    model.load_state_dict(_port_tree(model, back.params, back.batch_stats))
    want = _port_tree(model, jstate.params, jstate.batch_stats)
    _assert_tree_close(model, want, atol=PARAM_ATOL, keys=params)
    _assert_tree_close(model, want, atol=BN_MEAN_ATOL, keys=means)

    # the port trainer's --resume continues the converted JAX run: epoch 2's
    # two micro-steps (and, with grad_accum 2, the flush that closes it)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the JSONL scalar writer
    run = tmp_path / "port_run"
    with restored_logging():
        ttrain.main(["--config", str(run / "config.json"), "--run-dir", str(run), "--resume",
                     "--device", "cpu"])
    final = tckpt.load_checkpoint(run / "last")
    steps = SAVED_AT + 2 + (SAVED_AT + 2) % grad_accum
    assert (final["epoch"], final["step"]) == (2, steps)
    assert (final["optimizer"]["update_count"], final["optimizer"]["mini_step"]) == (
        steps // grad_accum, 0)


# -------------------------------------------------------------- the reverse


@pytest.fixture
def quiet(monkeypatch):
    """Both eval CLIs' logging set-up left alone (it replaces pytest's
    handlers), and the root logger restored after the test."""
    monkeypatch.setattr("ssd_tpu.utils.config.setup_cli_logging", lambda: None)
    monkeypatch.setattr("ssd_tpu_torch.utils.config.setup_cli_logging", lambda: None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with restored_logging():
        yield


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_layers"])
def test_port_run_evaluates_in_jax_and_round_trips(tmp_path, monkeypatch, quiet, scan):
    cfg, _, root = make_tiny_setup(tmp_path)
    cfg["model"]["encoder"]["scan_layers"] = scan
    cfg["optim"]["batch_size"] = 1  # two micro-steps an epoch, grad_accum 2
    run = root / "torch_run"
    ttrain.train_from_config(copy.deepcopy(cfg), run, device="cpu")
    payload = tckpt.load_checkpoint(run / "last")
    # the CTC head ×10, so argmax margins dwarf the fp32 gap between the
    # packages and the greedy text is not all blanks
    sd = dict(payload["state_dict"])
    sd["ctc_head.fc.weight"] = sd["ctc_head.fc.weight"] * 10
    tckpt.save_checkpoint(run, sd, tckpt.load_config_for(run / "last"),
                          optimizer=payload["optimizer"], epoch=payload["epoch"],
                          step=payload["step"])

    _convert("--from-torch", run / "last", "--output", root / "jax_run")
    assert ("blocks" in jckpt.load_checkpoint_np(root / "jax_run" / "last")["params"]["encoder"]) \
        is scan
    common = ["--decoder", "greedy", "--subsets", "train", "val", "--batch-size", "2"]
    monkeypatch.setattr(sys, "argv", ["evaluate", "--checkpoint", str(root / "jax_run" / "last"),
                                      "--output", str(root / "jax_eval")] + common)
    jeval.main()
    teval.main(["--checkpoint", str(run / "last"), "--output", str(root / "torch_eval"),
                "--device", "cpu"] + common)
    want = (root / "jax_eval" / "predictions.jsonl").read_text().splitlines()
    got = (root / "torch_eval" / "predictions.jsonl").read_text().splitlines()
    assert got == want and len(got) == 3
    assert any(json.loads(line)["hyp"] for line in got)

    # back to the port: the same tensors, optimizer state and counters
    _convert("--from-jax", root / "jax_run" / "last", "--output", root / "torch_back")
    back = tckpt.load_checkpoint(root / "torch_back" / "last")
    assert list(back["state_dict"]) == list(sd)
    for name, t in sd.items():
        assert torch.equal(back["state_dict"][name], t), name
    want_opt, got_opt = payload["optimizer"], back["optimizer"]
    for key in ("update_count", "mini_step"):
        assert got_opt[key] == want_opt[key], key
    for a, b in zip(got_opt["acc"], want_opt["acc"]):
        assert torch.equal(a, b)
    # the learning rate is the schedule's, set before every update
    assert ([dict(g, lr=None) for g in got_opt["adamw"]["param_groups"]]
            == [dict(g, lr=None) for g in want_opt["adamw"]["param_groups"]])
    for i, st in want_opt["adamw"]["state"].items():
        for key, t in st.items():
            assert torch.equal(got_opt["adamw"]["state"][i][key], t), (i, key)
    assert (back["epoch"], back["step"]) == (payload["epoch"], payload["step"])


@pytest.mark.parametrize("conv_norm", ["batch", "layer"])
@pytest.mark.parametrize("stacked", [False, True], ids=["unrolled", "stacked"])
def test_bridge_round_trip_is_bit_equal(conv_norm, stacked):
    """flax params + batch_stats → state_dict → flax: the same tree, leaf
    for leaf, in either layout."""
    cfg = {"model": {"encoder": dict(d_model=48, num_layers=2, num_heads=4, ffn_dim=96,
                                     depthwise_conv_kernel_size=5, subsample_factor=2,
                                     dropout=0.0, conv_norm=conv_norm),
                     "projection_dim": 32, "ctc_dropout": 0.0}}
    _, params, stats = _variables(cfg, seed=7)
    if stacked:
        params = dict(params, encoder=stack_block_tree(params["encoder"], 2))
        if stats:
            stats = dict(stats, encoder=stack_block_tree(stats["encoder"], 2))
    enc_cfg = build_model(cfg, IN_DIM, VOCAB).encoder_cfg
    sd = flax_bridge.state_dict_from_flax(params, stats, enc_cfg)
    got_params, got_stats = flax_bridge.flax_from_state_dict(sd, enc_cfg, stacked)
    for want, got in ((params, got_params), (stats, got_stats)):
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, a), (_, b) in zip(got_leaves, want_leaves):
            assert a.dtype == np.asarray(b).dtype, path
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))
