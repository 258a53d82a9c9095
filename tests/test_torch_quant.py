"""Int8 quantized inference in the port (``ssd_tpu_torch/ops/quant.py``,
``quantize: int8 | int8_prequant``) against the JAX package's
``ssd_tpu/ops/quant.py`` on the CPU: the quantized values, scales and int32
sums bit for bit, the rescaled products, whole models through the weight
bridge, training (``int8`` trains float, ``int8_prequant`` refuses), and the
engine, server, eval CLI and exporter with ``--quantize``."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.evaluation import evaluate as jeval
from ssd_tpu.ops import quant as jquant
from ssd_tpu.serving import engine as jeng
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.evaluation import evaluate as teval
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops import quant as tquant
from ssd_tpu_torch.serving import engine as teng
from ssd_tpu_torch.serving import export as texport
from ssd_tpu_torch.serving import server as tserver
from ssd_tpu_torch.training import train as ttrain
from ssd_tpu_torch.training.checkpoint import save_checkpoint

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.models.ssd_model import build_model as jax_build_model

from .test_torch_evaluation import corpus, quiet  # noqa: F401  (fixtures)
from .test_torch_logging import restored_logging
from .test_torch_models import IN_DIM, _cfg, _inputs, _variables
from .test_torch_serving import _cfg as serving_cfg
from .test_torch_serving import _requests, j_pad, small_buckets, weights  # noqa: F401
from .test_torch_training import _corpus

torch.set_num_threads(1)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# whole-model log-probs, port vs JAX: fp32 noise may move a value that sits
# at a rounding boundary by one quantization step (tests/test_torch_bf16.py's bound for bf16)
MODEL_ATOL = {"float32": 1e-3, "bfloat16": 5e-2}
# greedy tokens compared on frames whose top-2 margin exceeds this: in bf16,
# twice the bound, since the float bf16 models already differ by ~0.036 here
DECISIVE = {"float32": 1e-2, "bfloat16": 1e-1}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(TORCH_DTYPES[dtype])


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


# -------------------------------------------------------------------- per op


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 48), (3, 13, 96)], ids=["2d", "3d"])
def test_quantize_per_axis_bit_equal(shape, dtype):
    x = _x(shape, 0)
    x[0, ...] = 0.0  # an all-zero row: the 1e-8 floor of the scale
    jq, js = jquant._quantize_per_axis(jnp.asarray(x, JAX_DTYPES[dtype]), axis=-1)
    tq, ts = tquant.quantize_per_axis(_torch(x, dtype), dim=-1)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 48), (3, 13, 96)], ids=["2d", "3d"])
def test_int8_dot_general_parity(shape, dtype):
    """The int32 accumulator equal, the output as JAX's ``int8_dot_general``."""
    x = _x(shape, 1)
    w = _x((shape[-1], 40), 2) / np.sqrt(shape[-1])  # JAX's (in, out) kernel
    jx, jw = jnp.asarray(x, JAX_DTYPES[dtype]), jnp.asarray(w, JAX_DTYPES[dtype])
    dims = (((len(shape) - 1,), (0,)), ((), ()))
    want = jquant.int8_dot_general(jx, jw, dims)
    tx, tw = _torch(x, dtype), _torch(np.ascontiguousarray(w.T), dtype)
    got = tquant.int8_linear(tx, tw).to(TORCH_DTYPES[dtype])
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == want.shape

    xq, _ = jquant._quantize_per_axis(jx, axis=-1)
    wq, _ = jquant._quantize_per_axis(jw, axis=0)
    want_acc = jax.lax.dot_general(xq, wq, dims, preferred_element_type=jnp.int32)
    txq, _ = tquant.quantize_per_axis(tx, dim=-1)
    twq, _ = tquant.quantize_per_axis(tw, dim=1)
    got_acc = tquant.int8_matmul(txq.reshape(-1, shape[-1]), twq)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy().reshape(want_acc.shape), np.asarray(want_acc))
    rtol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prequantize_and_prequant_dot_parity(dtype):
    w = _x((64, 24), 3) / 8.0  # (in, out)
    jq, js = jquant.prequantize_kernel(jnp.asarray(w), JAX_DTYPES[dtype])
    tq, ts = tquant.prequantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)),
                                       TORCH_DTYPES[dtype])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.float32

    x = _x((5, 11, 64), 4)
    want = jquant.int8_prequant_dot(jnp.asarray(x, JAX_DTYPES[dtype]), jq, js)
    got = tquant.int8_prequant_linear(_torch(x, dtype), tq, ts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # the prequantized product is the dynamic one
    dyn = tquant.int8_linear(_torch(x, dtype), torch.from_numpy(np.ascontiguousarray(w.T))
                             .to(TORCH_DTYPES[dtype]))
    torch.testing.assert_close(got, dyn, rtol=1e-6, atol=1e-6)


def test_int8_matmul_plain_is_exact_at_the_widest_product():
    """|sum| ≤ 127² · 3072 < 2³¹: the float64 plain product is exact, as
    int64 arithmetic is (tpu_scaled_large's w2, K = 3 072)."""
    a = torch.full((3, 3072), -127, dtype=torch.int8)
    a[1] = 127
    a[2] = torch.from_numpy(np.random.default_rng(5).integers(-127, 128, 3072).astype(np.int8))
    b = torch.full((8, 3072), -127, dtype=torch.int8)
    got = tquant.int8_matmul(a, b)
    want = a.to(torch.int64) @ b.to(torch.int64).t()
    assert torch.equal(got.to(torch.int64), want)
    assert int(got[0, 0]) == 127 * 127 * 3072


def test_non_dense_contraction_refused():
    with pytest.raises(NotImplementedError):
        jquant.int8_dot_general(jnp.zeros((4, 8)), jnp.zeros((4, 8)), (((0,), (0,)), ((), ())))
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="shapes"):
        tquant.int8_matmul(a, torch.zeros((8, 16), dtype=torch.int8))  # K 8 against 16
    with pytest.raises(ValueError, match="shapes"):
        tquant.int8_matmul(a[None], a)
    with pytest.raises(TypeError, match="int8"):
        tquant.int8_matmul(a.float(), a)


def test_prequantize_state_dict_converts_only_the_eligible_weights():
    m = build_model(_cfg(), input_dim=IN_DIM, vocab_size=48)
    sd = m.state_dict()
    pre = tquant.prequantize_state_dict(sd)
    converted = sorted(k for k in pre if k.endswith(".scale"))
    assert len(converted) == 2 * 6  # ffn1.w1/w2, conv.pw1/pw2, ffn2.w1/w2 in each of 2 blocks
    for k in converted:
        w = k[: -len("scale")] + "weight"
        assert k.split(".")[-2] in tquant.QUANT_ELIGIBLE and pre[w].dtype == torch.int8
    assert all(pre[k] is v for k, v in sd.items() if not k.endswith(
        tuple(f"{n}.weight" for n in tquant.QUANT_ELIGIBLE)))
    assert tquant.prequantize_state_dict(pre).keys() == pre.keys()  # idempotent


# -------------------------------------------------------------- whole model


def _jax_lp(cfg, params, stats, x, lengths):
    jm = jax_build_model(cfg, input_dim=IN_DIM, vocab_size=48)
    lp, ol, _ = jax.jit(lambda *a: jm.apply(*a, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(lengths))
    return np.asarray(lp, np.float32), np.asarray(ol)


def _torch_lp(cfg, sd, x, lengths):
    m = build_model(cfg, input_dim=IN_DIM, vocab_size=48)
    m.load_state_dict(tquant.maybe_prequantize(sd, m.encoder_cfg))
    with torch.inference_mode():
        lp, ol, _ = m.eval()(torch.from_numpy(x), torch.from_numpy(lengths))
    return lp.float().numpy(), ol.numpy()


def _decisive_tokens_equal(got, want, lengths, margin=DECISIVE["float32"]):
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > margin
    valid = np.arange(want.shape[1])[None, :] < lengths[:, None]
    sel = decisive & valid
    assert sel.sum() > 0.5 * valid.sum()
    np.testing.assert_array_equal(got.argmax(-1)[sel], want.argmax(-1)[sel])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int8_prequant"])
def test_quantized_model_matches_jax(mode, dtype):
    """Shared weights through the bridge (the JAX ``int8_prequant`` tree, int8
    kernels and scales, through the bridge too): log-probs within
    :data:`MODEL_ATOL`, greedy tokens equal on decisive frames and, in fp32,
    the port's gap to JAX at most a tenth of JAX's own int8-vs-float gap. In
    bf16 that last bound cannot hold: the float bf16 models already differ by
    ~0.036 on these inputs (test_torch_bf16.py's 5e-2 bound), about JAX's int8-vs-float
    gap itself."""
    float_cfg = _cfg(compute_dtype=dtype)
    cfg = _cfg(compute_dtype=dtype, quantize=mode)
    _, params, stats = _variables(float_cfg)
    x, lengths = _inputs()
    want_float, _ = _jax_lp(float_cfg, params, stats, x, lengths)
    jparams = jquant.maybe_prequantize(params, cfg["model"]["encoder"])
    want, want_ol = _jax_lp(cfg, jparams, stats, x, lengths)
    enc_cfg = build_model(cfg, input_dim=IN_DIM, vocab_size=48).encoder_cfg
    for sd in (state_dict_from_flax(params, stats, enc_cfg),
               state_dict_from_flax(jax.device_get(jparams), stats, enc_cfg)):
        got, got_ol = _torch_lp(cfg, sd, x, lengths)
        np.testing.assert_array_equal(got_ol, want_ol)
        valid = (np.arange(want.shape[1])[None, :] < want_ol[:, None])[..., None]
        gap = np.abs(np.where(valid, got - want, 0)).max()
        jax_gap = np.abs(np.where(valid, want - want_float, 0)).max()
        assert gap <= MODEL_ATOL[dtype], gap
        if dtype == "float32":
            assert gap <= 0.1 * jax_gap, (gap, jax_gap)
        _decisive_tokens_equal(got, want, want_ol, DECISIVE[dtype])


def test_int8_prequant_matches_int8_in_the_port():
    """The JAX package's own bound between the two paths
    (``tests/test_quant.py``: rtol 1e-5, atol 1e-6)."""
    _, params, stats = _variables(_cfg())
    x, lengths = _inputs()
    enc_cfg = build_model(_cfg(), input_dim=IN_DIM, vocab_size=48).encoder_cfg
    sd = state_dict_from_flax(params, stats, enc_cfg)
    dyn, _ = _torch_lp(_cfg(quantize="int8"), sd, x, lengths)
    pre, _ = _torch_lp(_cfg(quantize="int8_prequant"), sd, x, lengths)
    np.testing.assert_allclose(pre, dyn, rtol=1e-5, atol=1e-6)


def _loss_and_grads(cfg, sd, x, lengths):
    torch.manual_seed(0)
    m = build_model(cfg, input_dim=IN_DIM, vocab_size=48)
    m.load_state_dict(sd)
    lp, _, st = m(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                  generator=torch.Generator().manual_seed(0))
    loss = lp.float().square().mean() + st.float().square().mean()
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in m.named_parameters()}


def test_int8_trains_float():
    """``train=True`` under ``quantize: int8`` runs the float products: the
    loss and every gradient bit-equal to ``quantize: none``'s."""
    _, params, stats = _variables(_cfg())
    x, lengths = _inputs()
    sd = state_dict_from_flax(params, stats, build_model(_cfg(), IN_DIM, 48).encoder_cfg)
    loss_f, grads_f = _loss_and_grads(_cfg(), sd, x, lengths)
    loss_q, grads_q = _loss_and_grads(_cfg(quantize="int8"), sd, x, lengths)
    assert torch.equal(loss_f, loss_q)
    assert grads_f.keys() == grads_q.keys()
    for k in grads_f:
        assert torch.equal(grads_f[k], grads_q[k]), k


def test_int8_prequant_refuses_training(tmp_path):
    cfg = _cfg(quantize="int8_prequant")
    m = build_model(cfg, input_dim=IN_DIM, vocab_size=48)
    x, lengths = _inputs()
    with pytest.raises(ValueError, match="inference-only"):
        m(torch.from_numpy(x), torch.from_numpy(lengths), train=True)
    # the train CLI refuses before it reads anything, with JAX's message
    with pytest.raises(ValueError, match="int8_prequant is inference-only"):
        ttrain.train_from_config({"model": {"encoder": {"quantize": "int8_prequant"}},
                                  "logging": {}, "data": {}}, tmp_path / "run", device="cpu")
    assert not (tmp_path / "run").exists()


def test_train_cli_trains_int8_float(tmp_path):
    cfg = json.loads(_corpus(tmp_path).read_text())
    cfg["model"]["encoder"]["quantize"] = "int8"
    summary = ttrain.train_from_config(cfg, tmp_path / "run", dry_run=True, device="cpu")
    assert np.isfinite(summary["best_val"])


# ------------------------------------------------- engine, server, CLIs


@pytest.mark.parametrize("mode", ["int8", "int8_prequant"])
def test_engine_matches_jax_quantized(weights, small_buckets, mode):  # noqa: F811
    params, stats, sd = weights
    j = jeng.InferenceEngine(serving_cfg(), params, stats, jax_default_vocab(), quantize=mode)
    t = teng.InferenceEngine(serving_cfg(), sd, default_vocab(), device="cpu", quantize=mode)
    assert t.cfg["model"]["encoder"]["quantize"] == mode
    reqs = _requests()
    j_lp, j_ol = j._pipeline(*map(jnp.asarray, j_pad(reqs)))
    t_lp, t_ol = t.forward(reqs)
    want, got = np.asarray(j_lp), t_lp.numpy()
    np.testing.assert_array_equal(t_ol.numpy(), np.asarray(j_ol))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    _decisive_tokens_equal(got, want, np.asarray(j_ol))
    assert t.transcribe(reqs) == j.transcribe(reqs)


def test_server_cli_serves_quantized(weights, tmp_path, monkeypatch):  # noqa: F811
    _, _, sd = weights
    vocab_path = tmp_path / "vocab.json"
    default_vocab().to_json(vocab_path)
    save_checkpoint(tmp_path / "run", sd, serving_cfg(vocab_path))
    started = []
    monkeypatch.setattr(tserver.ThreadingHTTPServer, "serve_forever",
                        lambda self: started.append(self))
    monkeypatch.setattr(sys, "argv", [
        "server", "--checkpoint", str(tmp_path / "run" / "last"), "--port", "0",
        "--device", "cpu", "--no-warmup", "--quantize", "int8_prequant"])
    with restored_logging():
        tserver.main()
    (server,) = started
    engine = server.batcher.engine
    assert engine.cfg["model"]["encoder"]["quantize"] == "int8_prequant"
    w1 = engine.model.encoder.blocks[0].ffn1.w1
    assert isinstance(w1, tquant.QuantDense) and w1.weight.dtype == torch.int8


@pytest.mark.parametrize("mode", ["int8", "int8_prequant"])
def test_eval_cli_matches_jax_quantized(corpus, tmp_path, monkeypatch, quiet, mode):  # noqa: F811
    """``--quantize``: the same predictions, WER and CER as the JAX CLI."""
    _, root = corpus
    common = ["--decoder", "greedy", "--subsets", "train", "val", "--batch-size", "2",
              "--quantize", mode]
    monkeypatch.setattr(sys, "argv", ["evaluate", "--checkpoint", str(root / "jax_run" / "last"),
                                      "--output", str(tmp_path / "jax")] + common)
    jeval.main()
    teval.main(["--checkpoint", str(root / "torch_run" / "last"), "--output",
                str(tmp_path / "torch"), "--device", "cpu"] + common)
    (jm, jp), (tm, tp) = [
        (json.loads((tmp_path / side / "metrics.json").read_text()),
         (tmp_path / side / "predictions.jsonl").read_text().splitlines())
        for side in ("jax", "torch")]
    assert tp == jp
    assert (tm["wer"], tm["cer"]) == (jm["wer"], jm["cer"])
    used = json.loads((tmp_path / "torch" / "config_used.json").read_text())
    assert used["model"]["encoder"]["quantize"] == mode


def test_export_cli_quantized(weights, small_buckets, tmp_path, monkeypatch):  # noqa: F811
    _, _, sd = weights
    monkeypatch.setattr(texport, "SAMPLE_BUCKET", 256)
    vocab_path = tmp_path / "vocab.json"
    default_vocab().to_json(vocab_path)
    save_checkpoint(tmp_path / "run", sd, serving_cfg(vocab_path))
    out = tmp_path / "artifact"
    with restored_logging():
        texport.main(["--checkpoint", str(tmp_path / "run" / "last"), "--out", str(out),
                      "--batch-sizes", "4", "--sample-lengths", "768", "--device", "cpu",
                      "--quantize", "int8_prequant"])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["quantize"] == "int8_prequant"
    t = texport.ExportedTranscriber.load(out, device="cpu")
    reqs = _requests()
    engine = teng.InferenceEngine.from_checkpoint(tmp_path / "run" / "last", device="cpu",
                                                  quantize="int8_prequant")
    assert t.transcribe(reqs) == engine.transcribe(reqs)
