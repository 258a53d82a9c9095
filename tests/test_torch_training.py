"""Port parity: the port's training path (``ssd_tpu_torch.training``) against
``ssd_tpu.training`` on the CPU — one and three train steps from the same
weights through ``flax_bridge``, with dropout 0 and augmentation off — plus
the optimizer, the schedules, ``MaskedBatchNorm``'s batch statistics,
dropout, the checkpoint and the CLI."""

import copy
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssd_tpu.models.conformer import MaskedBatchNorm as JMaskedBatchNorm
from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu.training import schedules as jsched
from ssd_tpu.training import train as jtrain
from ssd_tpu_torch.data.index_dataset import save_index
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.models import conformer as tconf
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops.dropout import dropout
from ssd_tpu_torch.training import schedules as tsched
from ssd_tpu_torch.training import train as ttrain
from ssd_tpu_torch.training.checkpoint import load_checkpoint, load_params_partial, save_checkpoint
from ssd_tpu_torch.utils.cuda_build import CACHE_ENV, build_dir

from .test_torch_logging import restored_logging
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

IN_DIM, VOCAB, TEACHER_DIM, BLANK = 16, 48, 32, 1
LAMBDAS = (0.65, 0.35)
LOSS_RTOL = 1e-4  # fp32 on both sides; summation order differs
GRAD_REL = 1e-4  # max abs error ≤ GRAD_REL × that tensor's max-abs gradient …
GRAD_FLOOR = 1e-6  # … or this. Two biases have a true gradient of 0 and
# both sides give rounding noise of ±1e-7: the attention key bias (softmax
# is shift invariant) and the depthwise-conv bias (the batch mean removes it)
NOISE_ONLY = (".attn.mha.key.bias", ".conv.dw.bias")
STAT_ATOL = 1e-5


def _cfg(grad_accum=1, dropout=0.0, **enc):
    return {
        "model": {
            "encoder": dict(d_model=48, num_layers=2, num_heads=4, ffn_dim=96,
                            depthwise_conv_kernel_size=5, subsample_factor=2, dropout=dropout,
                            **enc),
            "projection_dim": TEACHER_DIM,
            "ctc_dropout": dropout,
        },
        "optim": {"lr": 1e-3, "weight_decay": 1e-2, "clip_grad_norm": 1.0,
                  "grad_accum": grad_accum, "scheduler": {"name": "warmup_hold", "warmup_steps": 3}},
    }


def _batch(seed=0, B=3, T=64, S=32, Tt=32):
    rng = np.random.default_rng(seed)
    emg_len = np.asarray([64, 50, 37][:B], np.int32)
    tok_len = np.asarray([12, 9, 0][:B], np.int32)  # one empty transcript
    emg = rng.normal(size=(B, T, IN_DIM)).astype(np.float32)
    tokens = np.zeros((B, S), np.int32)
    for i, n in enumerate(emg_len):
        emg[i, n:] = 0.0
        tokens[i, : tok_len[i]] = rng.integers(3, VOCAB, size=tok_len[i])
    teacher = rng.normal(size=(B, Tt, TEACHER_DIM)).astype(np.float32)
    t_len = np.asarray([32, 25, 18][:B], np.int32)
    return {"emg": emg, "emg_lengths": emg_len, "tokens": tokens, "token_lengths": tok_len,
            "weight": np.ones(B, np.float32), "teacher": teacher, "teacher_lengths": t_len}


def _jax_setup(cfg, total_updates=10):
    model = jax_build_model(cfg, input_dim=IN_DIM, vocab_size=VOCAB)
    tx, _ = jsched.build_optimizer(cfg, total_updates)
    state = jtrain.init_state(model, tx, IN_DIM, jax.random.PRNGKey(0))
    return model, tx, state


def _port_setup(cfg, params, batch_stats, total_updates=10):
    model = build_model(cfg, input_dim=IN_DIM, vocab_size=VOCAB)
    model.load_state_dict(state_dict_from_flax(params, batch_stats, model.encoder_cfg))
    opt, _ = tsched.build_optimizer(cfg, model.parameters(), total_updates)
    return ttrain.TrainState(model=model, optimizer=opt)


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_tree(model, params, batch_stats):
    return state_dict_from_flax(jax.device_get(params), jax.device_get(batch_stats), model.encoder_cfg)


def _assert_tree_close(got_model, want_sd, atol_rel=None, atol=None, keys=None):
    for name, t in list(got_model.named_parameters()) + list(got_model.named_buffers()):
        if (keys is not None and name not in keys) or name.endswith(NOISE_ONLY):
            continue
        want = want_sd[name].numpy()
        tol = atol if atol is not None else atol_rel * max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(t.detach().numpy(), want, rtol=0, atol=tol, err_msg=name)


def test_one_train_step_matches_jax():
    """Losses, every parameter gradient, the updated batch statistics and
    the updated parameters after one step, from the same weights."""
    _check_one_train_step(_cfg())


def test_one_train_step_matches_jax_fused_attention_pallas_depthwise():
    """The same step with ``attention_impl: fused`` and ``depthwise_impl:
    pallas`` on both sides: the port's fused attention and depthwise
    autograd Functions against the Pallas kernels' custom VJPs."""
    _check_one_train_step(_cfg(attention_impl="fused", depthwise_impl="pallas"))


def _check_one_train_step(cfg):
    jmodel, tx, jstate = _jax_setup(cfg)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lam = jnp.asarray(LAMBDAS, jnp.float32)
    (_, (jlosses, jstats)), jgrads = jax.value_and_grad(
        lambda p: jtrain._losses(jmodel, p, jstate.batch_stats, jbatch, lam, BLANK, False, True,
                                 jax.random.PRNGKey(1)),
        has_aux=True,
    )(jstate.params)

    tstate = _port_setup(cfg, jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    grad_model = copy.deepcopy(tstate.model)
    total, tlosses = ttrain._losses(grad_model, _to_torch(batch), LAMBDAS, BLANK, False, True, None)
    total.backward()
    for k in ("total", "ctc", "distill"):
        np.testing.assert_allclose(float(tlosses[k].detach()), float(jlosses[k]), rtol=LOSS_RTOL)
    grads_sd = _port_tree(grad_model, jgrads, jstats)
    for name, p in grad_model.named_parameters():
        want = grads_sd[name].numpy()
        atol = max(GRAD_REL * np.abs(want).max(), GRAD_FLOOR)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=atol, err_msg=name)
    stats_sd = _port_tree(grad_model, jstate.params, jstats)
    bn_keys = {n for n, _ in grad_model.named_buffers()}
    assert bn_keys and all(".bn." in k for k in bn_keys)
    _assert_tree_close(grad_model, stats_sd, atol=STAT_ATOL, keys=bn_keys)

    jstep = jtrain.make_train_step(jmodel, tx, BLANK, False)
    jstate, _ = jstep(jstate, jbatch, lam, jax.random.key(2, impl="rbg"))
    tstep = ttrain.make_train_step(BLANK, False)
    tstate, _ = tstep(tstate, _to_torch(batch), LAMBDAS, None)
    # Adam's first step is ±lr·(g/|g|): a tolerance of a few % of lr. Adam
    # turns the NOISE_ONLY biases' noise into ±lr/2 steps that the outputs
    # never see, so the parameter checks leave those two out
    _assert_tree_close(tstate.model, _port_tree(tstate.model, jstate.params, jstate.batch_stats),
                       atol=2e-5)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax(grad_accum):
    """Losses over three steps (two batches alternating); with grad_accum 2
    the third micro-step opens a window that the flush closes."""
    cfg = _cfg(grad_accum)
    jmodel, tx, jstate = _jax_setup(cfg)
    tstate = _port_setup(cfg, jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    batches = [_batch(0), _batch(1)]
    lam = jnp.asarray(LAMBDAS, jnp.float32)
    jstep = jtrain.make_train_step(jmodel, tx, BLANK, False)
    tstep = ttrain.make_train_step(BLANK, False)
    rng = jax.random.key(2, impl="rbg")
    for i in range(3):
        b = batches[i % 2]
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, lam, rng)
        tstate, tl = tstep(tstate, _to_torch(b), LAMBDAS, None)
        for k in ("total", "ctc", "distill"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=LOSS_RTOL, err_msg=f"{k} step {i}")
    if grad_accum > 1:
        assert tstate.optimizer.mini_step == 1
        jstate = jtrain.flush_partial_accumulation(jstate, jtrain.make_flush_step(tx), grad_accum)
        tstate = ttrain.flush_partial_accumulation(tstate, ttrain.make_flush_step(), grad_accum)
        assert tstate.optimizer.mini_step == 0 and tstate.optimizer.update_count == 2
        assert tstate.step == int(jstate.step) == 4
    want = _port_tree(tstate.model, jstate.params, jstate.batch_stats)
    bn_means = {n for n, _ in tstate.model.named_buffers() if n.endswith(".bn.mean")}
    _assert_tree_close(tstate.model, want, atol=5e-5,
                       keys={n for n, _ in tstate.model.state_dict().items()} - bn_means)
    # the running means carry the depthwise bias, whose noise-driven Adam
    # steps (±lr/2 each) they average with weight 0.1: held to lr/2
    _assert_tree_close(tstate.model, want, atol=5e-4, keys=bn_means)


def test_masked_batchnorm_train_statistics_match_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 2.0, size=(3, 10, 6)).astype(np.float32)
    mask = np.arange(10)[None, :] < np.asarray([10, 6, 1])[:, None]
    x[~mask] = 1e3  # padded frames must not enter the statistics
    jbn = JMaskedBatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False)
    want, upd = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask), True, mutable=["batch_stats"])
    bn = tconf.MaskedBatchNorm(6)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bn(xt, torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(got.detach().numpy()[mask], np.asarray(want)[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=STAT_ATOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=STAT_ATOL)
    # gradients flow through the batch mean and variance, as in JAX
    g = rng.normal(size=x.shape).astype(np.float32) * mask[:, :, None]
    want_gx = jax.grad(lambda a: jnp.sum(
        jbn.apply(v, a, jnp.asarray(mask), True, mutable=["batch_stats"])[0] * g))(jnp.asarray(x))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=1e-4, atol=1e-5)
    # eval normalizes with the running statistics and leaves them alone
    before = bn.mean.clone()
    bn(torch.from_numpy(x), torch.from_numpy(mask), train=False)
    assert torch.equal(bn.mean, before)


def test_attention_dropout_mask_is_shared_over_batch_and_heads(monkeypatch):
    """flax's broadcast_dropout: one (T, T) keep-mask for every row and head."""
    shapes = []
    real = tconf.keep_multiplier

    def spy(shape, *a, **k):
        shapes.append(tuple(shape))
        return real(shape, *a, **k)

    monkeypatch.setattr(tconf, "keep_multiplier", spy)
    torch.manual_seed(0)
    mha = tconf._MultiHeadAttention(16, 4, dropout=0.5)
    x = torch.randn(1, 9, 16).expand(3, 9, 16)  # identical rows
    mask = torch.ones(3, 9, dtype=torch.bool)
    out = mha(x, mask, train=True, generator=torch.Generator().manual_seed(1))
    assert shapes == [(9, 9)]
    assert torch.equal(out[0], out[1]) and torch.equal(out[1], out[2])
    assert not torch.allclose(out, mha(x, mask))  # eval: no dropout


def test_dropout_keeps_the_expectation():
    x = torch.ones(200_000)
    y = dropout(x, 0.12, torch.Generator().manual_seed(0))
    assert abs(float((y == 0).float().mean()) - 0.12) < 0.005
    assert abs(float(y.mean()) - 1.0) < 0.01
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.88))
    assert dropout(x, 0.0, None) is x
    assert torch.equal(dropout(x, 0.3, torch.Generator().manual_seed(4)),
                       dropout(x, 0.3, torch.Generator().manual_seed(4)))


@pytest.mark.parametrize("name", ["warmup_hold", "linear", "cosine", None])
def test_schedules_match_jax(name):
    sched = {"name": name, "warmup_steps": 4, "t_max": 9} if name else None
    cfg = {"optim": {"scheduler": sched}}
    js = jsched.build_schedule(cfg, 3e-4, 12)
    ts = tsched.build_schedule(cfg, 3e-4, 12)
    for step in range(14):
        np.testing.assert_allclose(ts(step), float(js(jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_optimizer_matches_optax(grad_accum):
    """Clip (scale only when norm ≥ clip) + AdamW + MultiSteps' mean."""
    cfg = {"optim": {"lr": 0.1, "weight_decay": 0.05, "clip_grad_norm": 1.0,
                     "grad_accum": grad_accum, "scheduler": {"name": "warmup_hold", "warmup_steps": 2}}}
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    tx, _ = jsched.build_optimizer(cfg, 10)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("a", "b")]
    opt, _ = tsched.build_optimizer(cfg, tp, 10)
    for i, scale in enumerate([3.0, 0.01, 2.0, 0.5]):  # above and below the clip
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in p0.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{k} after micro-step {i}")
    assert opt.update_count == 4 // grad_accum


def _corpus(root, n_train=4):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_train + 1):
        uid = f"voiced/s1/{i}_0"
        t = int(rng.integers(30, 70))
        for kind, arr in (("emg", rng.normal(size=(t, 2, 8))),
                          ("teacher", rng.normal(size=(t // 2, 12)))):
            p = root / "features" / kind / f"{uid}.npy"
            p.parent.mkdir(parents=True, exist_ok=True)
            np.save(p, arr.astype(np.float32))
        rows.append(dict(utterance_id=uid, split="voiced", subset="val" if i == n_train else "train",
                         speaker="s1", stem=f"{i}_0", emg_path="-", audio_path=None,
                         transcript="hello world", sentence_index=i, book="", has_audio=False,
                         metadata_json="{}"))
    save_index(rows, root / "index.jsonl")
    default_vocab().to_json(root / "vocab.json")
    cfg = {
        "data": {"index": str(root / "index.jsonl"), "features_root": str(root / "features"),
                 "train_splits": ["voiced"], "val_splits": ["voiced"], "train_subsets": ["train"],
                 "val_subsets": ["val"], "vocab": str(root / "vocab.json")},
        "model": {"encoder": {"d_model": 16, "num_layers": 1, "num_heads": 2, "ffn_dim": 32,
                              "depthwise_conv_kernel_size": 5, "dropout": 0.1,
                              "subsample_factor": 2},
                  "projection_dim": 12, "ctc_dropout": 0.1},
        "loss": {"lambda_distill": 0.35, "lambda_ctc": 0.65, "distill_warmup_epochs": 2},
        "optim": {"batch_size": 2, "grad_accum": 1, "lr": 1e-3, "weight_decay": 1e-2,
                  "max_epochs": 1, "clip_grad_norm": 5.0, "num_workers": 2,
                  "scheduler": {"name": "warmup_hold", "warmup_steps": 2}},
        "augmentation": {"specaugment": {"p": 0.5, "time_masks": 1, "freq_masks": 1}},
        "logging": {"seed": 0, "run_name": "tiny", "log_interval": 1},
    }
    path = root / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def test_cli_trains_resumes_and_warm_starts_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the JSONL scalar writer
    cfg_path = _corpus(tmp_path)
    run = tmp_path / "run"
    with restored_logging():
        ttrain.main(["--config", str(cfg_path), "--run-dir", str(run), "--device", "cpu"])
    for f in ("last/model.pt", "best/model.pt", "config.json", "tb/scalars.jsonl"):
        assert (run / f).exists(), f
    payload = load_checkpoint(run / "last")
    assert payload["epoch"] == 1 and payload["step"] == 2
    assert payload["optimizer"]["update_count"] == 2
    tags = {json.loads(line)["tag"] for line in (run / "tb/scalars.jsonl").read_text().splitlines()}
    assert {"train/total_loss", "val/total_loss", "train/lambda_distill"} <= tags
    saved = json.loads((run / "config.json").read_text())
    assert saved["model"]["encoder"]["input_dim"] == 16

    cfg = json.loads(cfg_path.read_text())
    cfg["optim"]["max_epochs"] = 2
    summary = ttrain.train_from_config(cfg, run, resume=True, device="cpu")
    assert summary["epochs"] == 2 and [h["epoch"] for h in summary["history"]] == [2]
    assert load_checkpoint(run / "last")["optimizer"]["update_count"] == 4

    run2 = tmp_path / "warm"
    monkeypatch.setenv(CACHE_ENV, "")  # the flag exports it: put back after the test
    with restored_logging():
        ttrain.main(["--config", str(cfg_path), "--run-dir", str(run2), "--device", "cpu",
                     "--init-checkpoint", str(run / "best"), "--dry-run", "--overfit-batches", "1",
                     "--profile-dir", str(tmp_path / "trace"),
                     "--compile-cache", str(tmp_path / "cc")])
    assert (run2 / "last/model.pt").exists()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert build_dir() == (tmp_path / "cc").resolve() and build_dir().is_dir()


def test_weights_only_checkpoint_loads_and_partial_copy(tmp_path):
    m = build_model(_cfg(), input_dim=IN_DIM, vocab_size=VOCAB)
    save_checkpoint(tmp_path, m.state_dict(), {"model": _cfg()["model"]})
    payload = load_checkpoint(tmp_path / "last")
    assert "optimizer" not in payload and "epoch" not in payload
    other = build_model(_cfg(), input_dim=IN_DIM + 8, vocab_size=VOCAB)
    merged = load_params_partial(other.state_dict(), payload["state_dict"])
    key = "encoder.subsample.convs.conv_0.weight"  # input width differs: kept fresh
    assert merged[key] is other.state_dict()[key] or torch.equal(merged[key], other.state_dict()[key])
    assert torch.equal(merged["ctc_head.fc.weight"], payload["state_dict"]["ctc_head.fc.weight"])


def test_trainer_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the CPU-only refusal")
    cfg = json.loads(_corpus(tmp_path).read_text())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train_from_config(cfg, tmp_path / "run")
    with pytest.raises(RuntimeError, match="CUDA is not available"), restored_logging():
        ttrain.main(["--config", str(tmp_path / "config.json"), "--run-dir", str(tmp_path / "r")])


@pytest.mark.parametrize(
    "section,override",
    [
        ("parallel", {"model": 2}),
        ("parallel", {"fsdp": True}),
        ("parallel", {"sequence": True}),
        ("parallel", {"pipeline_microbatches": 2}),
        ("env", {"WORLD_SIZE": "2"}),
    ],
    ids=lambda o: o if isinstance(o, str) else next(iter(o)),
)
def test_unported_training_config_raises(tmp_path, monkeypatch, caplog, section, override):
    """The ``parallel:`` block in one process without a launcher, as the
    JAX trainer takes it on one device: ``model: 2`` raises ``make_mesh``'s
    ``ValueError``, ``pipeline_microbatches`` with the default BatchNorm
    raises ``validate_pipeline_config``'s (``tests/test_torch_pipeline.py``
    trains it with ``conv_norm: layer``),
    ``WORLD_SIZE=2`` without a launcher's ``RANK`` is an error; ``fsdp`` and
    ``sequence`` train as no-ops (``sequence`` warns), the weights equal to
    a run without them."""
    cfg = json.loads(_corpus(tmp_path).read_text())
    if section == "env":
        for k, v in override.items():
            monkeypatch.setenv(k, v)
    else:
        cfg.setdefault(section, {}).update(override)
    key = next(iter(override))
    if key in ("model", "pipeline_microbatches", "WORLD_SIZE"):
        error, match = {"model": (ValueError, "not divisible by model=2"),
                        "pipeline_microbatches": (ValueError, "conv_norm: layer"),
                        "WORLD_SIZE": (RuntimeError, "torch.distributed.run")}[key]
        with pytest.raises(error, match=match):
            ttrain.train_from_config(cfg, tmp_path / "run", device="cpu")
        return
    with caplog.at_level("WARNING", logger=ttrain.logger.name):
        ttrain.train_from_config(cfg, tmp_path / "run", device="cpu")
    assert ("has no effect with parallel.model=1" in caplog.text) == (key == "sequence")
    plain = json.loads((tmp_path / "config.json").read_text())
    ttrain.train_from_config(plain, tmp_path / "plain", device="cpu")
    got = load_checkpoint(tmp_path / "run" / "last")["state_dict"]
    want = load_checkpoint(tmp_path / "plain" / "last")["state_dict"]
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
