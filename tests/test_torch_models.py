"""Port parity: ``ssd_tpu_torch.models`` against ``ssd_tpu.models.SSDModel``
with the same weights through ``flax_bridge``, on the CPU, in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.models.conformer import stack_block_tree
from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model

torch.set_num_threads(1)

LP_TOL = dict(atol=2e-4, rtol=2e-4)
IN_DIM, VOCAB = 16, 48


def _cfg(**enc_overrides):
    enc = dict(
        d_model=48, num_layers=2, num_heads=4, ffn_dim=96,
        depthwise_conv_kernel_size=5, subsample_factor=2, dropout=0.0,
    )
    enc.update(enc_overrides)
    return {"model": {"encoder": enc, "projection_dim": 32, "ctc_dropout": 0.0}}


def _variables(cfg, seed=0):
    """JAX init + random non-trivial BN statistics and affine params."""
    model = jax_build_model(cfg, input_dim=IN_DIM, vocab_size=VOCAB)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 40, IN_DIM)), jnp.array([40]))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if "'mean'" in name or "'bias'" in name:
            return rng.normal(0.0, 0.3, x.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.7, 1.3, x.shape).astype(np.float32)
        return x

    v = jax.tree_util.tree_map_with_path(perturb, jax.device_get(v))
    return model, v["params"], v.get("batch_stats", {})


def _torch_model(cfg, params, batch_stats):
    m = build_model(cfg, input_dim=IN_DIM, vocab_size=VOCAB)
    m.load_state_dict(state_dict_from_flax(params, batch_stats, m.encoder_cfg))
    return m.eval()


def _inputs(B=3, T=41, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, IN_DIM)).astype(np.float32)
    lengths = np.asarray([T, T - 9, 17][:B], np.int32)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    return x, lengths


def _run_torch(m, x, lengths):
    with torch.inference_mode():
        lp, ol, st = m(torch.from_numpy(x), torch.from_numpy(lengths))
    return lp.numpy(), ol.numpy(), st.numpy()


@pytest.mark.parametrize("conv_norm", ["batch", "layer"])
def test_log_probs_match_jax(conv_norm):
    cfg = _cfg(conv_norm=conv_norm)
    jm, params, stats = _variables(cfg)
    x, lengths = _inputs()
    want_lp, want_ol, want_st = jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(lengths), train=False
    )
    got_lp, got_ol, got_st = _run_torch(_torch_model(cfg, params, stats), x, lengths)
    np.testing.assert_array_equal(got_ol, np.asarray(want_ol))
    np.testing.assert_allclose(got_lp, np.asarray(want_lp), **LP_TOL)
    np.testing.assert_allclose(got_st, np.asarray(want_st), **LP_TOL)


def test_padding_invariance_across_buckets():
    """The same utterances in two padded lengths give the same valid outputs."""
    cfg = _cfg()
    _, params, stats = _variables(cfg, seed=2)
    m = _torch_model(cfg, params, stats)
    x, lengths = _inputs(T=41)
    wide = np.zeros((3, 73, IN_DIM), np.float32)
    wide[:, :41] = x
    lp_a, ol_a, _ = _run_torch(m, x, lengths)
    lp_b, ol_b, _ = _run_torch(m, wide, lengths)
    np.testing.assert_array_equal(ol_a, ol_b)
    for i, n in enumerate(ol_a):
        np.testing.assert_allclose(lp_a[i, :n], lp_b[i, :n], **LP_TOL)


def test_scan_layers_tree_through_bridge():
    """A ``scan_layers`` (stacked blocks/block) tree loads into the unrolled
    port and gives the unrolled JAX model's outputs."""
    cfg = _cfg()
    jm, params, stats = _variables(cfg, seed=3)
    n = cfg["model"]["encoder"]["num_layers"]
    s_params = dict(params, encoder=stack_block_tree(params["encoder"], n))
    s_stats = dict(stats, encoder=stack_block_tree(stats["encoder"], n))
    scan_cfg = _cfg(scan_layers=True)
    x, lengths = _inputs()
    want_lp, _, _ = jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(lengths), train=False
    )
    got_lp, _, _ = _run_torch(_torch_model(scan_cfg, s_params, s_stats), x, lengths)
    np.testing.assert_allclose(got_lp, np.asarray(want_lp), **LP_TOL)


@pytest.mark.parametrize(
    "override",
    [
        {"attention_impl": "fused"},
        {"depthwise_impl": "pallas"},
        {"attention_impl": "fused", "depthwise_impl": "pallas"},
    ],
    ids=lambda o: "+".join(o),
)
def test_fused_attention_and_pallas_depthwise_match_jax(override):
    """The two implementation keys keep the parameter tree: the same flax
    weights through ``state_dict_from_flax`` give the JAX model's log-probs,
    the JAX side running its Pallas kernels in interpret mode."""
    cfg = _cfg(**override)
    jm, params, stats = _variables(cfg, seed=4)
    x, lengths = _inputs()
    want_lp, want_ol, want_st = jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(lengths), train=False
    )
    got_lp, got_ol, got_st = _run_torch(_torch_model(cfg, params, stats), x, lengths)
    np.testing.assert_array_equal(got_ol, np.asarray(want_ol))
    np.testing.assert_allclose(got_lp, np.asarray(want_lp), **LP_TOL)
    np.testing.assert_allclose(got_st, np.asarray(want_st), **LP_TOL)


@pytest.mark.parametrize(
    "override",
    [
        {"quantize": "int8"},
        {"compute_dtype": "bfloat16"},
        {"pipeline_microbatches": 2, "conv_norm": "layer"},
    ],
    ids=lambda o: next(iter(o)),
)
def test_unported_config_keys_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(_cfg(**override), input_dim=IN_DIM, vocab_size=VOCAB)


def test_invalid_config_values_raise_like_jax():
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(_cfg(remat_policy="bogus"), input_dim=IN_DIM, vocab_size=VOCAB)
    with pytest.raises(ValueError, match="quantize"):
        build_model(_cfg(quantize="int4"), input_dim=IN_DIM, vocab_size=VOCAB)
    # memory / parallelism knobs leave single-device inference math alone
    build_model(
        _cfg(remat=True, attn_remat=True, sequence_parallel=True),
        input_dim=IN_DIM, vocab_size=VOCAB,
    )
