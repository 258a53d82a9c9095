"""Port parity under ``compute_dtype: bfloat16``: ``ssd_tpu_torch`` against
the JAX package in bf16 on the CPU, from the same weights through
``flax_bridge`` — the forward in the four ``attention_impl`` ×
``depthwise_impl`` combinations with and without ``scan_layers``, a train
step, the bf16 plain versions of the attention and depthwise kernels against
the Pallas kernels (interpret mode) with their custom VJPs, the bf16 batch
arrays against ``ml_dtypes``' cast, and a bf16 model through ``export`` and
a streaming window.

The JAX side runs jitted with ``xla_allow_excess_precision`` off
(:data:`LITERAL_BF16`): XLA on the CPU otherwise keeps the intermediates of
a fused chain of elementwise ops in fp32 — the Pallas depthwise kernel's
``(src * w[j]).astype(f32)`` then skips the bf16 rounding its program
states — where the port, like the TPU program, rounds after every op.

Tolerances. The model's bf16 forward: any fp32-level difference (a
LayerNorm's variance formula, a product's summation order) flips some bf16
roundings, and a flip moves a value by a bf16 ulp, so the port sits about as
far from the JAX bf16 forward as that sits from the JAX fp32 one (the
printed ratio is ~1). Log-probs: atol 5e-2 (a logit of magnitude 4–8 moves
by 0.03 in one rounding); the student representation likewise. The kernels'
plain versions follow the Pallas formulas op for op: the depthwise forward
and its whole VJP bit-equal, the attention within two bf16 roundings of
each output's scale.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ssd_tpu.data.dataset import collate as jax_collate
from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.ops.attention import _fused_attn
from ssd_tpu.ops.depthwise_conv import depthwise_conv1d as jax_depthwise
from ssd_tpu.training import train as jtrain
from ssd_tpu_torch.data import dataset as tdata
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.models.conformer import Dense
from ssd_tpu_torch.ops import attention as tattn
from ssd_tpu_torch.ops import depthwise_conv as tdw
from ssd_tpu_torch.ops.dropout import dropout, keep_multiplier
from ssd_tpu_torch.serving import engine as teng
from ssd_tpu_torch.serving import export as texport
from ssd_tpu_torch.serving import streaming as tstream
from ssd_tpu_torch.training import train as ttrain
from ssd_tpu_torch.training.checkpoint import save_checkpoint

from .test_torch_models import _cfg, _inputs, _run_torch, _torch_model, _variables
from .test_torch_streaming import CHANNELS, GEOMETRY, shared_weights, tiny_cfg
from .test_torch_training import BLANK, LAMBDAS
from .test_torch_training import _batch as _train_batch
from .test_torch_training import _cfg as _train_cfg
from .test_torch_training import _jax_setup, _port_setup, _port_tree

torch.set_num_threads(1)

BF16 = dict(compute_dtype="bfloat16")
LP_ATOL = 5e-2  # log-probs and student representation, port vs JAX, both bf16
LOSS_RTOL = 1e-2  # bf16 train step: losses, port vs JAX
# bf16 gradients of one step, per tensor, as fractions of its largest fp32
# gradient: the JAX package's own bf16 backward is 4–20 % off its fp32 one
# on the GLU's pw1 bias (the gate's bf16 rounding), so the port is held to
# the JAX bf16 gradient within twice that gap (+ 1 %), and to the fp32
# gradient within 1.25 × it (+ 1 %) — no less accurate than the JAX bf16 step
GRAD_NOISE_FACTOR, GRAD_ACCURACY_FACTOR, GRAD_FLOOR = 2.0, 1.25, 1e-2
ULP = 2.0**-8  # one bf16 rounding, relative
LITERAL_BF16 = {"xla_allow_excess_precision": False}


def _jit(fn):
    return jax.jit(fn, compiler_options=LITERAL_BF16)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


def _valid_err(got, want, lengths):
    return max(float(np.abs(np.asarray(got)[i, :n] - np.asarray(want)[i, :n]).max())
               for i, n in enumerate(lengths))


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_layers"])
@pytest.mark.parametrize("impl", [("flax", "lax"), ("fused", "lax"), ("flax", "pallas"),
                                  ("fused", "pallas")], ids="-".join)
def test_bf16_forward_matches_jax(impl, scan):
    """Log-probs and the student representation of a bf16 model against the
    JAX package's bf16 model (its Pallas kernels in interpret mode), with
    and without ``scan_layers`` — whose fp32 carry into block_0 the port
    reproduces on its unrolled stack."""
    att, dw = impl
    cfg = _cfg(attention_impl=att, depthwise_impl=dw, scan_layers=scan, **BF16)
    jm, params, stats = _variables(cfg, seed=4)
    jm32, _, _ = _variables(_cfg(attention_impl=att, depthwise_impl=dw, scan_layers=scan), seed=4)
    x, lengths = _inputs()
    args = ({"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(lengths))
    want_lp, want_ol, want_st = _jit(lambda *a: jm.apply(*a, train=False))(*args)
    want32_lp = _jit(lambda *a: jm32.apply(*a, train=False))(*args)[0]
    model = _torch_model(cfg, params, stats)
    assert model.encoder.blocks[0].ffn1.w1.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got_lp, got_ol, got_st = _run_torch(model, x, lengths)
    assert got_lp.dtype == got_st.dtype == np.float32
    np.testing.assert_array_equal(got_ol, np.asarray(want_ol))
    gap = _valid_err(got_lp, want_lp, got_ol)
    jax_gap = _valid_err(want_lp, want32_lp, got_ol)
    print(f"{att}/{dw} scan_layers={scan}: log-probs port vs JAX (bf16) {gap:.4f}, JAX bf16 vs "
          f"fp32 {jax_gap:.4f}, ratio {gap / jax_gap:.3f}")
    np.testing.assert_allclose(got_lp, np.asarray(want_lp), rtol=0, atol=LP_ATOL)
    np.testing.assert_allclose(got_st, np.asarray(want_st), rtol=0, atol=LP_ATOL)


def test_scan_layers_changes_block0_by_a_bf16_rounding():
    """Under bf16 ``scan_layers`` is not math-neutral (the JAX package's
    ``tests/test_scan_layers.py`` pins the same): block_0's residual adds run
    in fp32 instead of bf16. In fp32 the two layouts are bit-identical."""
    x, lengths = _inputs()
    cfg = _cfg(**BF16)
    _, params, stats = _variables(cfg, seed=5)
    outs = {}
    for dtype in ("bfloat16", "float32"):
        for scan in (False, True):
            m = _torch_model(_cfg(compute_dtype=dtype, scan_layers=scan), params, stats)
            outs[dtype, scan] = _run_torch(m, x, lengths)[0]
    np.testing.assert_array_equal(outs["float32", False], outs["float32", True])
    diff = np.abs(outs["bfloat16", False] - outs["bfloat16", True]).max()
    assert 0 < diff < LP_ATOL


def test_dense_casts_like_flax():
    """``Dense`` casts input, weight and bias to the compute dtype and keeps
    fp32 parameters; fp32 compute is ``nn.Linear`` exactly."""
    torch.manual_seed(0)
    d = Dense(8, 4, torch.bfloat16)
    x = torch.randn(3, 8)
    y = d(x)
    assert y.dtype == torch.bfloat16 and d.weight.dtype == torch.float32
    want = torch.nn.functional.linear(x.bfloat16(), d.weight.bfloat16(), d.bias.bfloat16())
    assert torch.equal(y, want)
    d32 = Dense(8, 4)
    d32.load_state_dict(d.state_dict())
    assert torch.equal(d32(x), torch.nn.Linear.forward(d32, x))


@pytest.mark.parametrize("impl", [{}, {"attention_impl": "fused", "depthwise_impl": "pallas"}],
                         ids=["flax-lax", "fused-pallas"])
def test_bf16_train_step_matches_jax(impl):
    """Losses and every parameter gradient of one bf16 train step (dropout 0),
    from the same weights, with the teacher moved in bf16 on both sides,
    against the JAX bf16 step and the JAX fp32 one (GRAD_* above)."""
    cfg = _train_cfg(**BF16, **impl)
    jmodel, _, jstate = _jax_setup(cfg)
    jmodel32, _, _ = _jax_setup(_train_cfg(**impl))
    batch = _train_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["teacher"] = jnp.asarray(batch["teacher"].astype(ml_dtypes.bfloat16))
    lam = jnp.asarray(LAMBDAS, jnp.float32)

    def jax_grads(m):
        return _jit(jax.value_and_grad(
            lambda p: jtrain._losses(m, p, jstate.batch_stats, jbatch, lam, BLANK, False, True,
                                     jax.random.PRNGKey(1)),
            has_aux=True,
        ))(jstate.params)

    (_, (jlosses, jstats)), jgrads = jax_grads(jmodel)
    jgrads32 = jax_grads(jmodel32)[1]

    tstate = _port_setup(cfg, jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    model = tstate.model
    tbatch = ttrain.to_device(dict(batch, teacher=tdata.bf16_bits(batch["teacher"])),
                              torch.device("cpu"))
    assert tbatch["teacher"].dtype == torch.bfloat16
    total, tlosses = ttrain._losses(model, tbatch, LAMBDAS, BLANK, False, True, None)
    total.backward()
    for k in ("total", "ctc", "distill"):
        np.testing.assert_allclose(float(tlosses[k].detach()), float(jlosses[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    grads, grads32 = _port_tree(model, jgrads, jstats), _port_tree(model, jgrads32, jstats)
    worst = (0.0, 0.0)
    for name, p in model.named_parameters():
        if name.endswith((".attn.mha.key.bias", ".conv.dw.bias")):  # true gradient 0: noise
            continue
        got, want, want32 = p.grad.numpy(), grads[name].numpy(), grads32[name].numpy()
        scale = np.abs(want32).max()
        jax_gap = np.abs(want - want32).max() / scale
        gap, accuracy = np.abs(got - want).max() / scale, np.abs(got - want32).max() / scale
        worst = max(worst, (gap, jax_gap))
        assert gap <= GRAD_NOISE_FACTOR * jax_gap + GRAD_FLOOR, (name, gap, jax_gap)
        assert accuracy <= GRAD_ACCURACY_FACTOR * jax_gap + GRAD_FLOOR, (name, accuracy, jax_gap)
    print(f"bf16 train step {impl or 'flax/lax'}: worst gradient gap to JAX bf16 {worst[0]:.4f} "
          f"of the tensor's max (JAX bf16 vs fp32 there: {worst[1]:.4f})")


# --------------------------------------------------------------------------
# The kernels' plain bf16 versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("drop", [False, True])
def test_bf16_attention_plain_matches_pallas(drop):
    """The fused attention in bf16: the port's plain forward and backward
    (the CPU path of the autograd Function) against ``_fused_attn``'s Pallas
    kernels and custom VJP, all inputs bf16, the multiplier built in bf16."""
    rng = np.random.default_rng(7 + drop)
    B, T, H, hd = 2, 40, 2, 16
    q, k, v, g = (rng.normal(size=(B, H, T, hd)).astype(np.float32) for _ in range(4))
    lengths = np.array([T, 13])
    km = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    keep = rng.uniform(size=(T, T)) >= 0.1
    mult = _bf16(keep) / 0.9  # 1.109375 where kept
    assert float(mult.max()) == 1.109375

    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    jmult = jnp.asarray(_f32(mult), jnp.bfloat16) if drop else jnp.ones((T, T), jnp.bfloat16)
    jkm = jnp.asarray(km)[:, None, :]

    def fwd_bwd(q, kt, v, g):
        out, vjp = jax.vjp(lambda a, b, c: _fused_attn(drop, a, b, c, jkm, jmult), q, kt, v)
        return (out, *vjp(g))

    out, dq, dkt, dv = _jit(fwd_bwd)(jq, jnp.swapaxes(jk, -1, -2), jv, jg)
    want = [np.asarray(a, np.float32) for a in (out, dq, jnp.swapaxes(dkt, -1, -2), dv)]

    tq, tk, tv = (_bf16(a).requires_grad_(True) for a in (q, k, v))
    got_out = tattn.fused_attention(tq, tk, tv, torch.from_numpy(km), mult if drop else None)
    assert got_out.dtype == torch.bfloat16
    got_out.backward(_bf16(g))
    got = [_f32(got_out), _f32(tq.grad), _f32(tk.grad), _f32(tv.grad)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * ULP * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("T,K", [(37, 5), (64, 15)])
def test_bf16_depthwise_plain_matches_pallas(T, K):
    """The depthwise stencil in bf16 bit-equal to the Pallas kernels and
    their VJP: the forward and dx (each tap's product rounded to bf16, then
    the fp32 sum in tap order), dw and db (fp32 sums rounded to bf16)."""
    rng = np.random.default_rng(T)
    B, C = 3, 24
    x, g = (rng.normal(size=(B, T, C)).astype(np.float32) for _ in range(2))
    w = (rng.normal(size=(K, C)) / 3).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    jx, jw, jb, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b, g))

    def fwd_bwd(x, w, b, g):
        y, vjp = jax.vjp(jax_depthwise, x, w, b)
        return (y, *vjp(g))

    want = [np.asarray(a, np.float32) for a in _jit(fwd_bwd)(jx, jw, jb, jg)]

    tx, tw, tb = (_bf16(a).requires_grad_(True) for a in (x, w, b))
    got_y = tdw.depthwise_conv1d(tx, tw, tb)
    got_y.backward(_bf16(g))
    assert got_y.dtype == tx.grad.dtype == tw.grad.dtype == tb.grad.dtype == torch.bfloat16
    for name, a, ref in zip(("y", "dx", "dw", "db"),
                            (got_y, tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_array_equal(_f32(a), ref, err_msg=name)


def test_dropout_scale_in_the_tensor_dtype():
    """``FastDropout``'s scale ``jnp.asarray(1/(1-rate), x.dtype)``: in bf16
    1/0.9 rounds to 1.109375, for the activations and the attention
    multiplier alike."""
    gen = torch.Generator().manual_seed(0)
    mult = keep_multiplier((64, 64), 0.1, gen, torch.device("cpu"), torch.bfloat16)
    assert mult.dtype == torch.bfloat16
    assert set(mult.unique().tolist()) == {0.0, 1.109375}
    assert float(jnp.asarray(1.0 / 0.9, jnp.bfloat16)) == 1.109375
    x = _bf16(np.linspace(-3, 3, 64))
    y = dropout(x, 0.1, torch.Generator().manual_seed(1))
    kept = y != 0
    assert torch.equal(y[kept], (x * torch.tensor(1.109375, dtype=torch.bfloat16))[kept])


def test_bf16_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 4, dtype=torch.bfloat16)
    w = torch.zeros(3, 4, dtype=torch.bfloat16)
    for kernel, args in ((tdw.DW_FWD_BF16, (x, w, w[0])), (tdw.DW_BWD_BF16, (x, w, x))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernel(*args)
    q = torch.zeros(1, 2, 8, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.ATTN_FWD_BF16(q, q, q, torch.ones(1, 8, dtype=torch.int32))


# --------------------------------------------------------------------------
# bf16 batches
# --------------------------------------------------------------------------


def test_bf16_bits_equal_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-40, 38, size=4096),
        np.array([0.0, -0.0, 1.00390625, 1.01171875, -1.00390625, np.inf, -np.inf, np.nan, -np.nan,
                  3.4e38, -3.4e38, 1e-45, 1.17e-38], np.float32),
    ]).astype(np.float32)
    np.testing.assert_array_equal(tdata.bf16_bits(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_bf16_batches_equal_jax_collate():
    """``collate`` with ``teacher_dtype`` / ``emg_dtype: bfloat16`` gives the
    JAX loader's ml_dtypes arrays bit for bit, and the trainer's
    ``to_device`` hands them over as bfloat16 tensors."""
    rng = np.random.default_rng(1)
    vocab, jvocab = default_vocab(), jax_default_vocab()
    items = [{"utterance_id": f"u{i}", "transcript": "ab", "tokens": np.array([3, 4], np.int32),
              "emg": rng.normal(size=(n, 12)).astype(np.float32),
              "teacher": rng.normal(size=(n // 2, 8)).astype(np.float32)}
             for i, n in enumerate((70, 130, 9))]
    got = tdata.collate(items, vocab, teacher_dtype="bfloat16", emg_dtype="bfloat16")
    want = jax_collate(items, jvocab, teacher_dtype=ml_dtypes.bfloat16, emg_dtype=ml_dtypes.bfloat16)
    for name in ("emg", "teacher"):
        assert getattr(got, name).dtype == np.uint16
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name).view(np.uint16))
    t = ttrain.to_device({"teacher": got.teacher, "tokens": got.tokens}, torch.device("cpu"))
    assert t["teacher"].dtype == torch.bfloat16 and t["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(_f32(t["teacher"]), want.teacher.astype(np.float32))


def test_emg_dtype_bf16_rules():
    """As in the JAX package: ``emg_dtype: bfloat16`` needs a bf16 encoder,
    and raw EMG (featurized on the device) refuses it."""
    cfg = {"data": {"emg_dtype": "bfloat16"}, "model": {"encoder": {}}}
    with pytest.raises(ValueError, match="requires model.encoder.compute_dtype"):
        ttrain._check_slice(cfg)
    cfg["model"]["encoder"]["compute_dtype"] = "bfloat16"
    ttrain._check_slice(cfg)
    with pytest.raises(ValueError, match="cached features only"):
        tdata.make_dataloader(index_path=None, features_root=None, splits=[], subsets=None,
                              vocab=default_vocab(), batch_size=1, raw=True, emg_dtype="bfloat16")


# --------------------------------------------------------------------------
# Serving a bf16 model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_checkpoint(tmp_path_factory):
    """The tiny serving weights under fused/pallas, computing in bf16."""
    _, _, sd = shared_weights()
    root = tmp_path_factory.mktemp("bf16")
    default_vocab().to_json(root / "vocab.json")
    cfg = tiny_cfg(root / "vocab.json", attention_impl="fused", depthwise_impl="pallas", **BF16)
    save_checkpoint(root / "run", sd, cfg)
    return root / "run" / "last"


def test_bf16_export_and_stream_match_the_engine(bf16_checkpoint, tmp_path, monkeypatch):
    """A bf16 checkpoint exported (the custom ops carry bf16 through
    ``torch.export``) gives the engine's greedy tokens; a one-window stream
    gives the engine's text; the log-probs reach the decoders in fp32."""
    monkeypatch.setattr(teng, "SAMPLE_BUCKET", 256)
    monkeypatch.setattr(teng, "BATCH_BUCKETS", (1, 2))
    engine = teng.InferenceEngine.from_checkpoint(bf16_checkpoint, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [rng.normal(size=(n, CHANNELS)).astype(np.float32) for n in (200, 256)]
    lp, _ = engine.forward(reqs)
    assert lp.dtype == torch.float32
    out = texport.export_checkpoint(bf16_checkpoint, tmp_path / "export", batch_sizes=(2,),
                                    sample_lengths=(256,), device="cpu")
    t = texport.ExportedTranscriber.load(out, device="cpu")
    tokens, counts = t.call(reqs)
    with torch.no_grad():
        want_tokens, want_counts = texport.BucketProgram(engine, 0.0)(
            *(torch.from_numpy(a) for a in engine._pad(reqs)))
    np.testing.assert_array_equal(counts, want_counts.numpy())
    np.testing.assert_array_equal(tokens, want_tokens.numpy())
    assert t.transcribe(reqs) == engine.transcribe(reqs)

    emg = rng.normal(size=(300, CHANNELS)).astype(np.float32)
    ts = tstream.ChunkedStreamingTranscriber(engine, **GEOMETRY)
    for i in range(0, 300, 100):
        assert ts.feed(emg[i : i + 100]) is None
    text = ts.finish()
    assert ts.windows == 1 and text == engine.transcribe([emg])[0]
