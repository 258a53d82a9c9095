"""The port's GPipe schedule (``ssd_tpu_torch/parallel/pipeline.py``)
against ``ssd_tpu/parallel/pipeline.py`` on the CPU.

In one process a ``pipeline_microbatches > 0`` model runs its blocks in
order with an fp32 carry, the JAX no-mesh ``scan_stack`` path: log-probs
held to the JAX model's in fp32 and bf16, and a JAX pipelined tree
(stacked ``blocks/block``) loads through the bridge. The JAX validation and
divisibility errors have twins. One 2-rank gloo group
(``tests/torch_parallel_worker.py``) runs every multi-process case:
``{model: 2, pipeline_microbatches: 2}`` at B = 5 (each data rank's rows
padded to 6 with a weight-0 row), with the fused ops' CPU versions, with
``fsdp``, with ``remat`` and with ``grad_accum: 2`` (AdamW's multi-tensor
path, the card's default, which FSDP's DTensors and another stage's empty
parameters must both take), each held to the JAX
single-device step with the same ``pipeline_microbatches`` (its batch
padded as the JAX trainer pads it) in losses, every gradient and the
updated parameters, equal on both ranks; the errors of a stack the stages
do not divide and of rows the microbatches do not; a pipelined
``train_from_config`` whose ``last`` equals one process's epoch, resumes in
one process, and serves and evaluates there as the same weights do
unpipelined; and two pipelined runs with dropout on, bit-equal."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.models.conformer import EncoderConfig as JEncoderConfig
from ssd_tpu.parallel.pipeline import validate_pipeline_config as j_validate
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.evaluation import evaluate as teval
from ssd_tpu_torch.models.conformer import EncoderConfig
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.parallel import pipeline as tpp
from ssd_tpu_torch.serving.engine import InferenceEngine
from ssd_tpu_torch.training import train as ttrain
from ssd_tpu_torch.training.checkpoint import load_checkpoint

from .test_torch_bf16 import LP_ATOL, _jit
from .test_torch_models import LP_TOL, _inputs, _run_torch, _torch_model, _variables
from .test_torch_parallel import _close, _flat
from .test_torch_parallel_train import _batch, _jax_steps
from .test_torch_training import (
    BLANK, GRAD_FLOOR, GRAD_REL, IN_DIM, LAMBDAS, LOSS_RTOL, NOISE_ONLY, VOCAB, _cfg, _corpus,
)
from .torch_parallel_worker import run_group
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

M = 2  # microbatches
PP = dict(conv_norm="layer", pipeline_microbatches=M)
PAR = {"model": 2, "pipeline_microbatches": M}


def _pp_cfg(**kw):
    """The parity config (2 blocks, d_model 48) with ``conv_norm: layer``
    and ``pipeline_microbatches: 2``."""
    enc = dict(PP, **{k: v for k, v in kw.items() if k != "grad_accum"})
    return _cfg(grad_accum=kw.get("grad_accum", 1), **enc)


# ---------------------------------------------------------------- one process


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequential_stack_matches_jax_scan_stack(dtype):
    """Without stages the blocks run in order on an fp32 carry, as the JAX
    ``scan_stack`` fallback runs them; in bf16 block_0's residual adds
    therefore run in fp32 (the ``scan_layers`` carry), which the tolerance
    of ``tests/test_torch_bf16.py`` holds."""
    cfg = {"model": _pp_cfg(compute_dtype=dtype)["model"]}
    jm, params, stats = _variables(cfg, seed=6)
    assert "blocks" in params["encoder"]  # the JAX pipelined layout: stacked
    x, lengths = _inputs()
    args = ({"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(lengths))
    want_lp, want_ol, _ = _jit(lambda *a: jm.apply(*a, train=False))(*args)
    got_lp, got_ol, _ = _run_torch(_torch_model(cfg, params, stats), x, lengths)
    np.testing.assert_array_equal(got_ol, np.asarray(want_ol))
    tol = LP_TOL if dtype == "float32" else dict(rtol=0, atol=LP_ATOL)
    np.testing.assert_allclose(got_lp, np.asarray(want_lp), **tol)


def test_jax_pipelined_tree_loads_through_the_bridge():
    """A JAX pipelined tree's stacked ``blocks/block`` leaves unstack into
    the port's ``encoder.blocks.{i}``, and the port's unpipelined model on
    those weights equals the pipelined one bit for bit in fp32 (the fp32
    carry is a no-op there)."""
    cfg = {"model": _pp_cfg()["model"]}
    _, params, stats = _variables(cfg, seed=7)
    stacked = params["encoder"]["blocks"]["block"]
    sd = state_dict_from_flax(params, stats, build_model(cfg, IN_DIM, VOCAB).encoder_cfg)
    for i in range(2):
        np.testing.assert_array_equal(sd[f"encoder.blocks.{i}.ffn1.w1.weight"].numpy(),
                                      np.asarray(stacked["ffn1"]["w1"]["kernel"][i]).T)
        np.testing.assert_array_equal(sd[f"encoder.blocks.{i}.conv.cn.weight"].numpy(),
                                      np.asarray(stacked["conv"]["cn"]["scale"][i]))
    x, lengths = _inputs()
    pipelined = _torch_model(cfg, params, stats)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["model"]["encoder"]["pipeline_microbatches"] = 0
    plain = build_model(plain_cfg, IN_DIM, VOCAB).eval()
    plain.load_state_dict(pipelined.state_dict())
    for a, b in zip(_run_torch(pipelined, x, lengths), _run_torch(plain, x, lengths)):
        np.testing.assert_array_equal(a, b)


def test_pipeline_validation():
    """The JAX messages for what the schedule cannot take, on both configs."""
    base = dict(input_dim=16, d_model=32, num_layers=4, num_heads=4, ffn_dim=64,
                depthwise_conv_kernel_size=7, dropout=0.0, subsample_factor=2,
                conv_norm="layer")
    for over, match in ((dict(conv_norm="batch"), "conv_norm"),
                        (dict(scan_layers=True), "scan_layers"),
                        (dict(sequence_parallel=True), "sequence")):
        for validate, cls in ((tpp.validate_pipeline_config, EncoderConfig),
                              (j_validate, JEncoderConfig)):
            with pytest.raises(ValueError, match=match):
                validate(cls(**dict(base, **over), pipeline_microbatches=2))
    tpp.validate_pipeline_config(EncoderConfig(**base))  # pipeline off: fine
    tpp.validate_pipeline_config(EncoderConfig(**base, pipeline_microbatches=2))


def test_pipeline_divisibility_errors(runs):
    """The JAX schedule's run-time errors (its ``num_layers`` and ``not
    divisible`` messages), on the 2-rank group: 3 blocks over 2 stages, and
    3 rows in 2 microbatches."""
    ranks, _ = runs
    for r in ranks:
        assert "num_layers=3 not divisible by 2 stages" in r["errors"]["layers"]
        assert "batch 3 on this data rank not divisible by microbatches 2" in r["errors"]["rows"]
    with pytest.raises(ValueError, match="num_layers"):
        tpp.check_stages(5, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tpp.check_rows(4, 3)


# ---------------------------------------------------------------- 2 ranks

# name → (encoder keys, extra parallel keys, JAX reference)
CASES = {
    "pp": ({}, {}, "one"),
    "pp_fused": ({"attention_impl": "fused", "depthwise_impl": "pallas"}, {}, "one"),
    "pp_fsdp": ({}, {"fsdp": True}, "one"),
    "pp_remat": ({"remat": True, "remat_policy": "dots"}, {}, "one"),
    "pp_accum": ({"grad_accum": 2}, {}, "accum"),
}


def _padded(batch, rows):
    """The JAX trainer's padding: zero rows of weight 0 up to ``rows``."""
    b = batch["emg"].shape[0]
    return {k: np.concatenate([v, np.zeros((rows - b,) + v.shape[1:], v.dtype)])
            for k, v in batch.items()}


def _group_jobs(root, one_start, accum_start, batches):
    jobs = []
    for name, (enc, par, ref) in CASES.items():
        start, n = (accum_start, 2) if ref == "accum" else (one_start, 1)
        jobs.append(dict(name=name, kind="step", cfg=_pp_cfg(**enc), parallel=dict(PAR, **par),
                         input_dim=IN_DIM, vocab=VOCAB, state_dict=start, batches=batches[:n],
                         lambdas=LAMBDAS, blank=BLANK, foreach=True))
    odd = _pp_cfg()
    odd["model"]["encoder"]["num_layers"] = 3
    jobs.append(dict(name="errors", kind="pipeline_errors", cfg=_pp_cfg(), cfg_odd_layers=odd,
                     parallel=PAR, input_dim=IN_DIM, vocab=VOCAB))
    train_cfg = _train_cfg(root)
    jobs.append(dict(name="train", kind="train", cfg=dict(train_cfg, parallel=PAR),
                     run_dir=str(root / "ranks")))
    for run in ("a", "b"):  # dropout and SpecAugment on, twice from one seed
        jobs.append(dict(name=f"dropout_{run}", kind="train",
                         cfg=dict(_train_cfg(root, flat=False), parallel=PAR),
                         run_dir=str(root / f"dropout_{run}")))
    return jobs


def _train_cfg(root, flat=True):
    cfg = json.loads(_corpus(root).read_text())
    cfg = _flat(cfg) if flat else cfg
    cfg["model"]["encoder"].update(num_layers=2, conv_norm="layer")
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    batches = [_batch(0), _batch(1)]
    rows = -(-batches[0]["emg"].shape[0] // M) * M
    padded = [_padded(b, rows) for b in batches]
    one = _jax_steps(_pp_cfg(), padded[:1])
    accum = _jax_steps(_pp_cfg(grad_accum=2), padded)
    ranks = run_group(_group_jobs(root, one[0], accum[0], batches), root / "group")
    # one process, the same training config: the sequential stack
    cfg = _train_cfg(root)
    ttrain.train_from_config(copy.deepcopy(cfg), root / "one", device="cpu")
    return ranks, {"one": one, "accum": accum, "root": root, "cfg": cfg}


@pytest.mark.parametrize("name", list(CASES))
def test_two_stage_step_matches_jax(runs, name):
    """Losses, every gradient (each block's from its stage, the front end's
    and heads' alike on both stages), the parameters after the update, the
    same on both ranks; ``pp_accum`` takes two micro-steps to one update."""
    ranks, want = runs
    _, losses, grads, after = want[CASES[name][2]]
    got = ranks[0][name]
    for i, (g, w) in enumerate(zip(got["losses"], losses)):
        for k in ("total", "ctc", "distill"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"{name} {k} {i}")
    assert set(got["grads"]) == set(grads)
    for n, w in grads.items():
        assert got["grads"][n].shape == w.shape, n
        atol = max(GRAD_REL * float(w.abs().max()), GRAD_FLOOR)
        np.testing.assert_allclose(got["grads"][n].numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{name} grad {n}")
    param_atol = 5e-5 if name == "pp_accum" else 2e-5
    for n, w in after.items():
        if n.endswith(NOISE_ONLY):
            continue
        np.testing.assert_allclose(got["state"][n].numpy(), w.numpy(), rtol=0, atol=param_atol,
                                   err_msg=f"{name} {n}")
    other = ranks[1][name]
    assert other["losses"] == got["losses"]
    assert all(torch.equal(other["state"][n], got["state"][n]) for n in got["state"])
    assert all(torch.equal(other["grads"][n], got["grads"][n]) for n in got["grads"])
    if name == "pp_accum":
        assert got["update_count"] == 1 and got["mini_step"] == 0


def test_pipelined_training_equals_one_process_and_resumes_there(runs):
    """The 2-stage epoch's ``last`` (full tensors, written by rank 0) equals
    one process's epoch within the CPU tolerances, records
    ``pipeline_microbatches``, and resumes in one process for epoch 2."""
    ranks, want = runs
    root, cfg = want["root"], want["cfg"]
    assert ranks[0]["train"]["history"][0]["val"] == ranks[1]["train"]["history"][0]["val"]
    saved = json.loads((root / "ranks" / "config.json").read_text())
    assert saved["model"]["encoder"]["pipeline_microbatches"] == M
    _close(root / "ranks" / "last", root / "one" / "last")
    summary = ttrain.train_from_config(dict(cfg, optim=dict(cfg["optim"], max_epochs=2)),
                                       root / "ranks", resume=True, device="cpu")
    assert [h["epoch"] for h in summary["history"]] == [2]
    assert np.isfinite(summary["history"][0]["val"]["total"])


def test_pipelined_training_with_dropout_is_finite_and_reproducible(runs):
    """Dropout 0.1 and SpecAugment on: the blocks draw from each stage's own
    stream, the front end and the heads from the data rank's; two runs from
    one seed give the same losses and weights bit for bit, finite."""
    ranks, want = runs
    root = want["root"]
    a, b = ranks[0]["dropout_a"]["history"], ranks[0]["dropout_b"]["history"]
    for h in a + b:
        h["train"].pop("utterances_per_sec_per_chip")
    assert a == b and all(np.isfinite(h["train"]["total"]) for h in a)
    wa = load_checkpoint(root / "dropout_a" / "last")["state_dict"]
    wb = load_checkpoint(root / "dropout_b" / "last")["state_dict"]
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    flat = load_checkpoint(root / "ranks" / "last")["state_dict"]
    assert not all(torch.equal(wa[k], flat[k]) for k in wa)  # the masks did act


def test_pipelined_checkpoint_serves_and_evaluates_in_one_process(runs):
    """The 2-stage run's checkpoint, served by the engine and scored by the
    eval CLI's ``evaluate_checkpoint`` in one process: the same log-probs
    and records as the same weights without ``pipeline_microbatches``."""
    _, want = runs
    root = want["root"]
    ckpt = root / "ranks" / "last"
    cfg = json.loads((root / "ranks" / "config.json").read_text())
    plain = copy.deepcopy(cfg)
    plain["model"]["encoder"]["pipeline_microbatches"] = 0
    features = {"emg": {"sample_rate": 1000, "n_fft": 64, "hop_length": 16, "n_mels": 8,
                        "normalize": "per_file"}}
    sd = load_checkpoint(ckpt)["state_dict"]
    rng = np.random.default_rng(0)
    reqs = [rng.normal(size=(n, 2)).astype(np.float32) for n in (900, 1500, 400)]
    served = [InferenceEngine(dict(c, features=features), sd, default_vocab(), device="cpu")
              .forward(reqs) for c in (cfg, plain)]
    assert torch.equal(served[0][0], served[1][0]) and torch.equal(served[0][1], served[1][1])

    def argmax(lp, ol):
        return [str(x) for x in lp.argmax(-1)[:, :3].tolist()]

    records = [teval.evaluate_checkpoint(ckpt, c, default_vocab(), ["voiced"], ["train", "val"],
                                         argmax, batch_size=3, device="cpu")["records"]
               for c in (cfg, plain)]
    assert records[0] == records[1] and len(records[0]) == 5
