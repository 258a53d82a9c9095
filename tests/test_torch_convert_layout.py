"""The port's layout converter (``ssd_tpu_torch/training/convert_layout.py``)
against the JAX package's CLI: one set of weights saved by both packages in
an unrolled, a scanned and a pipelined (stacked, ``scan_layers`` false)
layout, converted by each package's CLI in both directions. The converted
configs are equal, the port's converted weights are the bridge of the JAX
CLI's, and the converted models' log-probs agree: fp32 within the models'
parity tolerance, bf16 within atol 5e-2 (``scan_layers`` feeds block_0 an
fp32 carry, which moves a bf16 model's numbers). The CLIs refuse the same
three conversions with the same message."""

import copy
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.models.conformer import stack_block_tree
from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu.training import convert_layout as jconvert
from ssd_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from ssd_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.training import convert_layout as tconvert
from ssd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

from .test_torch_logging import restored_logging
from .test_torch_models import IN_DIM, LP_TOL, VOCAB, _cfg, _inputs, _run_torch, _variables

torch.set_num_threads(1)

BF16_LP_ATOL = 5e-2  # bf16 log-probs, port vs JAX (tests/test_torch_bf16.py)
LITERAL_BF16 = {"xla_allow_excess_precision": False}  # XLA keeps every bf16 rounding
LAYOUTS = {
    "unrolled": {},
    "scan": {"scan_layers": True},
    "pipelined": {"conv_norm": "layer", "pipeline_microbatches": 2},
}


@pytest.fixture(scope="module")
def weights():
    """JAX-initialized unrolled weights with non-trivial BN statistics, one
    set per ``conv_norm``."""
    return {norm: _variables(_cfg(conv_norm=norm), seed=5)[1:] for norm in ("batch", "layer")}


def _source(root, weights, layout, dtype):
    """The same weights in ``layout``, saved by both packages (epoch 3, step
    17, an optimizer state that the converters drop)."""
    cfg = _cfg(input_dim=IN_DIM, **LAYOUTS[layout],
               **({"compute_dtype": "bfloat16"} if dtype == "bf16" else {}))
    enc = cfg["model"]["encoder"]
    params, stats = weights[enc.get("conv_norm", "batch")]
    jparams, jstats = copy.deepcopy(params), copy.deepcopy(stats)
    if layout != "unrolled":
        jparams["encoder"] = stack_block_tree(jparams["encoder"], enc["num_layers"])
        if jstats:
            jstats["encoder"] = stack_block_tree(jstats["encoder"], enc["num_layers"])
    jax_save_checkpoint(root / "jax_src", {"params": jparams, "batch_stats": jstats,
                                           "opt_state": {"dummy": np.zeros(2)},
                                           "epoch": np.asarray(3), "step": np.asarray(17)}, cfg)
    sd = state_dict_from_flax(params, stats, build_model(cfg, IN_DIM, VOCAB).encoder_cfg)
    save_checkpoint(root / "torch_src", sd, cfg, optimizer={"update_count": 4}, epoch=3, step=17)
    return cfg


def _argv(root, side, src, to, out):
    return ["--checkpoint", str(root / f"{side}_{src}" / "last"), "--to", to,
            "--output", str(root / f"{side}_{out}")]


def _convert(root, src, to, out):
    with restored_logging():
        jconvert.main(_argv(root, "jax", src, to, out))
        tconvert.main(_argv(root, "torch", src, to, out))


def _log_probs(cfg, params, stats, x, lengths):
    model = jax_build_model(cfg, input_dim=IN_DIM, vocab_size=VOCAB)
    fn = jax.jit(lambda v, a, n: model.apply(v, a, n, train=False)[0],
                 compiler_options=LITERAL_BF16)
    return np.asarray(fn({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         jnp.asarray(lengths)))


def _torch_log_probs(cfg, state_dict, x, lengths):
    model = build_model(cfg, input_dim=IN_DIM, vocab_size=VOCAB)
    model.load_state_dict(state_dict)
    return _run_torch(model.eval(), x, lengths)[0]


@pytest.mark.parametrize("dtype,src,to", [
    ("fp32", "unrolled", "scan"), ("fp32", "scan", "unrolled"),
    ("fp32", "pipelined", "unrolled"), ("fp32", "pipelined", "scan"),
    ("bf16", "unrolled", "scan"), ("bf16", "scan", "unrolled"),
])
def test_port_cli_matches_jax_cli(tmp_path, weights, dtype, src, to):
    src_cfg = _source(tmp_path, weights, src, dtype)
    # the CLIs' basicConfig(force=True) replaces the root's handlers (and
    # caplog's): the port's log line is caught on its own logger
    records = []
    catch = logging.Handler()
    catch.emit = records.append
    tconvert.logger.addHandler(catch)
    try:
        _convert(tmp_path, "src", to, "out")
    finally:
        tconvert.logger.removeHandler(catch)
    assert any("optimizer state dropped" in r.getMessage() for r in records)
    cfg = json.loads((tmp_path / "torch_out" / "config.json").read_text())
    assert cfg == json.loads((tmp_path / "jax_out" / "config.json").read_text())
    assert cfg["model"]["encoder"]["scan_layers"] is (to == "scan")
    assert "pipeline_microbatches" not in cfg["model"]["encoder"]

    want = jax_load_checkpoint(tmp_path / "jax_out" / "last")
    got = load_checkpoint(tmp_path / "torch_out" / "last")
    assert (got["epoch"], got["step"]) == (int(want["epoch"]), int(want["step"])) == (3, 17)
    assert "optimizer" not in got and "opt_state" not in want
    enc_cfg = build_model(cfg, IN_DIM, VOCAB).encoder_cfg
    bridged = state_dict_from_flax(want["params"], want["batch_stats"], enc_cfg)
    assert set(bridged) == set(got["state_dict"])
    for name, t in got["state_dict"].items():
        assert torch.equal(t, bridged[name]), name

    x, lengths = _inputs()
    want_lp = _log_probs(cfg, want["params"], want["batch_stats"], x, lengths)
    got_lp = _torch_log_probs(cfg, got["state_dict"], x, lengths)
    if dtype == "fp32":
        np.testing.assert_allclose(got_lp, want_lp, **LP_TOL)
    else:
        np.testing.assert_allclose(got_lp, want_lp, rtol=0, atol=BF16_LP_ATOL)
        # the layout is not math-neutral in bf16: the source config's model
        # gives other numbers from the same weights
        before = _torch_log_probs(src_cfg, got["state_dict"], x, lengths)
        assert 0 < np.abs(before - got_lp).max() < BF16_LP_ATOL


@pytest.mark.parametrize("src,to,chain", [
    ("unrolled", "unrolled", None), ("scan", "scan", None), ("pipelined", "scan", "scan"),
], ids=["unrolled-to-unrolled", "scan-to-scan", "pipelined-to-scan-twice"])
def test_cli_refuses_what_the_jax_cli_refuses(tmp_path, weights, src, to, chain):
    _source(tmp_path, weights, src, "fp32")
    if chain:  # convert once, then ask for the same layout again
        _convert(tmp_path, "src", chain, "src2")
        src = "src2"
    else:
        src = "src"
    with restored_logging():
        with pytest.raises(ValueError, match="already in the") as want:
            jconvert.main(_argv(tmp_path, "jax", src, to, "x"))
        with pytest.raises(ValueError, match="already in the") as got:
            tconvert.main(_argv(tmp_path, "torch", src, to, "x"))
    assert str(got.value) == str(want.value)
