"""Rematerialization in the port (``remat``, ``remat_policy``,
``attn_remat``): a train step with dropout drawn from an explicit generator
gives, under every policy, the same losses, gradients, BatchNorm running
statistics and generator state as the step without remat — bit for bit on
the CPU — and the recompute really runs; ``attn_remat`` with ``remat`` logs
the JAX package's warning once."""

import copy
import logging

import pytest
import torch

from ssd_tpu.models import conformer as jconf
from ssd_tpu_torch.models import conformer as tconf
from ssd_tpu_torch.models.conformer import init_flax_style
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.training import train as ttrain

from .test_torch_training import BLANK, IN_DIM, LAMBDAS, VOCAB, _batch, _cfg, _to_torch

torch.set_num_threads(1)

DROPOUT = 0.1
REMATS = {
    "full": dict(remat=True, remat_policy="full"),
    "dots": dict(remat=True, remat_policy="dots"),
    "dots_no_batch": dict(remat=True, remat_policy="dots_no_batch"),
    "attn_remat": dict(attn_remat=True),
}


def _model(**enc):
    m = build_model(_cfg(dropout=DROPOUT, **enc), input_dim=IN_DIM, vocab_size=VOCAB)
    init_flax_style(m, torch.Generator().manual_seed(0))
    return m


def _step(model, seed=3):
    """One train step's losses and the generator it drew its dropout from."""
    gen = torch.Generator().manual_seed(seed)
    total, losses = ttrain._losses(model, _to_torch(_batch()), LAMBDAS, BLANK, False, True, gen)
    total.backward()
    return {k: v.detach() for k, v in losses.items()}, gen


@pytest.mark.parametrize("impl", [{}, {"attention_impl": "fused", "depthwise_impl": "pallas"},
                                  {"compute_dtype": "bfloat16"}],
                         ids=["flax-lax", "fused-pallas", "bf16"])
@pytest.mark.parametrize("policy", list(REMATS))
def test_remat_gradients_equal_unrematted(policy, impl):
    base = _model(**impl)
    remat = _model(**impl, **REMATS[policy])
    remat.load_state_dict(copy.deepcopy(base.state_dict()))
    want_losses, want_gen = _step(base)
    got_losses, got_gen = _step(remat)
    assert torch.equal(got_gen.get_state(), want_gen.get_state())
    for k, v in want_losses.items():
        assert torch.equal(got_losses[k], v), k
    got_params = dict(remat.named_parameters())
    for name, p in base.named_parameters():
        assert torch.equal(got_params[name].grad, p.grad), name
    got_bufs = dict(remat.named_buffers())
    for name, b in base.named_buffers():
        assert torch.equal(got_bufs[name], b), name


@pytest.mark.parametrize("policy", list(REMATS))
def test_remat_recomputes_in_the_backward(policy):
    """The block (or, for ``attn_remat``, the attention alone) runs again
    during the backward (entered: the recompute stops once it has what the
    backward needs); nothing else does."""
    model = _model(**REMATS[policy])
    calls = {"attn": 0, "ffn1": 0}
    block = model.encoder.blocks[0]
    for name in calls:
        getattr(block, name).register_forward_pre_hook(
            lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
    gen = torch.Generator().manual_seed(3)
    total, _ = ttrain._losses(model, _to_torch(_batch()), LAMBDAS, BLANK, False, True, gen)
    assert calls == {"attn": 1, "ffn1": 1}
    total.backward()
    assert calls == {"attn": 2, "ffn1": 1 if policy == "attn_remat" else 2}


def test_remat_is_inert_without_gradients():
    model = _model(**REMATS["full"]).eval()
    ref = copy.deepcopy(model)
    ref.encoder.cfg = _model().encoder.cfg
    batch = _to_torch(_batch())
    with torch.no_grad():
        got = model(batch["emg"], batch["emg_lengths"])[0]
        want = ref(batch["emg"], batch["emg_lengths"])[0]
    assert torch.equal(got, want)


def test_attn_remat_under_remat_warns_like_jax(monkeypatch, caplog):
    monkeypatch.setattr(jconf, "_ATTN_REMAT_WARNED", False)
    monkeypatch.setattr(tconf, "_ATTN_REMAT_WARNED", False)
    enc = dict(remat=True, attn_remat=True)
    with caplog.at_level(logging.WARNING):
        jconf._block_cls(jconf.EncoderConfig(input_dim=IN_DIM, **enc))
        _model(**enc)
        _model(**enc)  # once a process
    jax_msgs = [r.getMessage() for r in caplog.records if r.name == jconf.__name__]
    port_msgs = [r.getMessage() for r in caplog.records if r.name == tconf.__name__]
    assert len(jax_msgs) == 1 and port_msgs == jax_msgs
