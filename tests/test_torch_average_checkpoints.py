"""Checkpoint averaging in the port (``ssd_tpu_torch.training.
average_checkpoints``) against the JAX package's ``average_payloads``: the
same three flax payloads averaged by JAX and bridged equal the port's
average of the bridged state_dicts bit for bit; the CLI writes the exact
float64 mean, the largest epoch / step and no optimizer state; mismatched
and int8_prequant checkpoints are refused; the average served by the CPU
engine matches the JAX engine on the averaged params."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu.ops import quant as jquant
from ssd_tpu.serving import engine as jeng
from ssd_tpu.training import average_checkpoints as javg
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops import quant as tquant
from ssd_tpu_torch.serving import engine as teng
from ssd_tpu_torch.training import average_checkpoints as tavg
from ssd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

from .test_torch_logging import restored_logging
from .test_torch_models import LP_TOL
from .test_torch_serving import CHANNELS, N_MELS, _requests, j_pad, small_buckets  # noqa: F401
from .test_torch_serving import _cfg as serving_cfg

torch.set_num_threads(1)

IN_DIM = CHANNELS * N_MELS


def _payload(seed, epoch):
    """A JAX checkpoint payload: params from ``seed`` and random BatchNorm
    statistics, counters, and an optimizer entry the average drops."""
    model = jax_build_model(serving_cfg(), input_dim=IN_DIM, vocab_size=48)
    v = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 40, IN_DIM)),
                                  jnp.array([40])))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32), v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats,
            "epoch": np.asarray(epoch), "step": np.asarray(epoch * 10),
            "opt_state": {"dummy": np.zeros((2,))}}


def _enc_cfg(cfg=None):
    return build_model(cfg or serving_cfg(), input_dim=IN_DIM, vocab_size=48).encoder_cfg


@pytest.fixture(scope="module")
def payloads():
    return [_payload(s, epoch=s + 1) for s in range(3)]


def _bridged(p):
    return state_dict_from_flax(p["params"], p["batch_stats"], _enc_cfg())


def test_average_equals_jax_average_payloads_bit_for_bit(payloads):
    want = javg.average_payloads(payloads)
    want_sd = state_dict_from_flax(want["params"], want["batch_stats"], _enc_cfg())
    got = tavg.average_state_dicts([_bridged(p) for p in payloads])
    assert list(got) == list(want_sd)
    assert any(k.endswith("bn.mean") for k in got) and any(k.endswith("bn.var") for k in got)
    for k in want_sd:
        assert got[k].dtype == want_sd[k].dtype == torch.float32
        assert torch.equal(got[k], want_sd[k]), k
    assert int(want["epoch"]) == 3 and int(want["step"]) == 30


def _saved_runs(tmp_path, payloads, cfg):
    for i, p in enumerate(payloads):
        save_checkpoint(tmp_path / f"run{i}", _bridged(p), cfg, optimizer={"update_count": i},
                        epoch=int(p["epoch"]), step=int(p["step"]))
    return [str(tmp_path / f"run{i}" / "last") for i in range(len(payloads))]


def test_cli_writes_the_exact_mean_and_drops_the_optimizer(payloads, tmp_path):
    vocab = tmp_path / "vocab.json"
    default_vocab().to_json(vocab)
    cfg = serving_cfg(vocab)
    ckpts = _saved_runs(tmp_path, payloads, cfg)
    # a later config must not win: the first checkpoint's is kept
    (tmp_path / "run2" / "config.json").write_text(json.dumps({"other": 1}))
    with restored_logging():
        tavg.main(["--checkpoints", *ckpts, "--output", str(tmp_path / "avg")])
    got = load_checkpoint(tmp_path / "avg" / "last")
    assert got["epoch"] == 3 and got["step"] == 30
    assert "optimizer" not in got
    assert json.loads((tmp_path / "avg" / "config.json").read_text()) == cfg
    sds = [_bridged(p) for p in payloads]
    for k, t in got["state_dict"].items():
        mean = (sds[0][k].double() + sds[1][k].double() + sds[2][k].double()) / 3
        assert torch.equal(t, mean.float()), k


def test_one_checkpoint_averages_to_itself(payloads):
    sd = _bridged(payloads[0])
    got = tavg.average_state_dicts([sd])
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_shape_and_key_mismatches_are_refused(payloads):
    a = {"w": torch.zeros(2, 2)}
    with pytest.raises(ValueError, match="mismatch"):
        tavg.average_state_dicts([a, {"w": torch.zeros(3, 2)}])
    with pytest.raises(ValueError, match="mismatch"):
        tavg.average_state_dicts([a, {"w": torch.zeros(2, 2), "v": torch.zeros(1)}])
    with pytest.raises(ValueError, match="at least one"):
        tavg.average_state_dicts([])
    # the JAX tool refuses the same topology mismatch
    with pytest.raises(ValueError, match="mismatch"):
        javg.average_payloads([{"params": {"w": np.zeros((2, 2), np.float32)}, "batch_stats": {}},
                               {"params": {"w": np.zeros((3, 2), np.float32)}, "batch_stats": {}}])


def test_int8_prequant_checkpoints_are_refused(payloads, tmp_path):
    cfg = serving_cfg()
    cfg["model"]["encoder"]["quantize"] = "int8_prequant"
    enc_cfg = _enc_cfg(cfg)
    sds = [tquant.maybe_prequantize(_bridged(p), enc_cfg) for p in payloads[:2]]
    assert any(t.dtype == torch.int8 for t in sds[0].values())
    for i, sd in enumerate(sds):
        save_checkpoint(tmp_path / f"q{i}", sd, cfg)
    with pytest.raises(ValueError, match="float"):
        tavg.average_state_dicts(sds)
    with restored_logging(), pytest.raises(ValueError, match="float"):
        tavg.main(["--checkpoints", str(tmp_path / "q0/last"), str(tmp_path / "q1/last"),
                   "--output", str(tmp_path / "qavg")])
    assert not (tmp_path / "qavg").exists()
    # the JAX tool refuses its own int8_prequant tree the same way
    jpays = [dict(p, params=jax.device_get(jquant.maybe_prequantize(
        p["params"], cfg["model"]["encoder"]))) for p in payloads[:2]]
    with pytest.raises(ValueError, match="float"):
        javg.average_payloads(jpays)


def test_average_served_by_the_cpu_engine_matches_jax(payloads, tmp_path):
    vocab = tmp_path / "vocab.json"
    default_vocab().to_json(vocab)
    cfg = serving_cfg(vocab)
    ckpts = _saved_runs(tmp_path, payloads, cfg)
    with restored_logging():
        tavg.main(["--checkpoints", *ckpts, "--output", str(tmp_path / "avg")])
    avg = javg.average_payloads(payloads)
    reqs = _requests()
    j = jeng.InferenceEngine(serving_cfg(), avg["params"], avg["batch_stats"], jax_default_vocab())
    t = teng.InferenceEngine.from_checkpoint(tmp_path / "avg" / "last", device="cpu")
    j_lp, j_ol = j._pipeline(*map(jnp.asarray, j_pad(reqs)))
    t_lp, t_ol = t.forward(reqs)
    np.testing.assert_array_equal(t_ol.numpy(), np.asarray(j_ol))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), **LP_TOL)
    assert t.transcribe(reqs) == j.transcribe(reqs)


def _help_flags(capsys, call):
    with pytest.raises(SystemExit):
        call()
    return {w.rstrip(",") for w in capsys.readouterr().out.split() if w.startswith("--")}


def test_cli_flags_equal_jax(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["average_checkpoints"])
    assert _help_flags(capsys, lambda: tavg.main(["--help"])) == _help_flags(
        capsys, lambda: javg.main(["--help"])) == {"--help", "--checkpoints", "--output"}
