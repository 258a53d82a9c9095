"""Port parity over a mesh: 2-rank train steps of the port (gloo on the
CPU, ``tests/torch_parallel_worker.py``) against the JAX package's
single-device step on the same weights through ``flax_bridge``, dropout 0,
at the tolerances of ``tests/test_torch_training.py``.

One 2-rank group runs every case: data parallelism at B = 5 (one rank gets
a padding row of weight 0), DP + FSDP, tensor parallelism, tensor + sequence parallelism
(``model: 2, sequence: true``) at an odd T′ = 33 with the composite ops and
with the fused attention and depthwise ops (their CPU versions; local heads
and a T-shard plus halo), and ``grad_accum: 2`` with and without FSDP. Each is held to the JAX
step's losses, every gradient (synced over the mesh, unsharded), the
updated parameters and the BatchNorm running statistics, which must be
equal on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssd_tpu.training import train as jtrain
from ssd_tpu_torch.models.flax_bridge import state_dict_from_flax
from ssd_tpu_torch.models.ssd_model import build_model

from .test_torch_training import (
    BLANK, GRAD_FLOOR, GRAD_REL, IN_DIM, LAMBDAS, LOSS_RTOL, NOISE_ONLY, STAT_ATOL, VOCAB,
    _cfg, _jax_setup,
)
from .torch_parallel_worker import run_group
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

B, T = 5, 66  # T′ = 33 after the ×2 subsampler: odd, so sequence parallelism pads it
CASES = {
    "dp": ({}, {}),
    "fsdp": ({"fsdp": True}, {}),
    "tp": ({"model": 2}, {}),
    "tp_sp": ({"model": 2, "sequence": True}, {}),
    "tp_sp_fused": ({"model": 2, "sequence": True, "fsdp": True},
                    {"attention_impl": "fused", "depthwise_impl": "pallas"}),
}


# (T-shard, frames each side): K 5 on 5-frame shards, and a shard shorter
# than the stencil's reach
HALOS = [(5, 2), (2, 3)]


def _batch(seed):
    rng = np.random.default_rng(seed)
    emg_len = np.asarray([66, 50, 37, 61, 20], np.int32)
    tok_len = np.asarray([12, 9, 0, 7, 3], np.int32)  # one empty transcript
    emg = rng.normal(size=(B, T, IN_DIM)).astype(np.float32)
    tokens = np.zeros((B, 32), np.int32)
    for i, n in enumerate(emg_len):
        emg[i, n:] = 0.0
        tokens[i, : tok_len[i]] = rng.integers(3, VOCAB, size=tok_len[i])
    return {"emg": emg, "emg_lengths": emg_len, "tokens": tokens, "token_lengths": tok_len,
            "weight": np.ones(B, np.float32),
            "teacher": rng.normal(size=(B, 32, 32)).astype(np.float32),
            "teacher_lengths": np.asarray([32, 25, 18, 30, 10], np.int32)}


def _jax_steps(cfg, batches):
    """The JAX step's losses a micro-step, the first micro-step's
    gradients, and the parameters and statistics after the last, as port
    ``state_dict``\\ s; plus the starting weights."""
    jmodel, tx, state = _jax_setup(cfg)
    enc_cfg = build_model(cfg, IN_DIM, VOCAB).encoder_cfg
    lam = jnp.asarray(LAMBDAS, jnp.float32)
    start = state_dict_from_flax(jax.device_get(state.params),
                                 jax.device_get(state.batch_stats), enc_cfg)

    @jax.jit
    def step(state, batch):
        (_, (losses, stats)), grads = jax.value_and_grad(
            lambda p: jtrain._losses(jmodel, p, state.batch_stats, batch, lam, BLANK, False,
                                     True, jax.random.PRNGKey(1)),
            has_aux=True,
        )(state.params)
        updates, opt = tx.update(grads, state.opt_state, state.params)
        new = state.replace(params=optax.apply_updates(state.params, updates),
                            batch_stats=stats, opt_state=opt, step=state.step + 1)
        return new, losses, grads

    losses, grads = [], None
    for b in batches:
        state, jl, jg = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append({k: float(v) for k, v in jl.items()})
        if grads is None:
            grads = state_dict_from_flax(jax.device_get(jg), jax.device_get(state.batch_stats),
                                         enc_cfg)
    after = state_dict_from_flax(jax.device_get(state.params),
                                 jax.device_get(state.batch_stats), enc_cfg)
    return start, losses, grads, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = [_batch(0), _batch(1)]
    one = _jax_steps(_cfg(), batches[:1])
    accum = _jax_steps(_cfg(grad_accum=2), batches)
    jobs = []
    for name, (par, enc) in CASES.items():
        jobs.append(dict(name=name, kind="step", cfg=_cfg(**enc), parallel=par,
                         input_dim=IN_DIM, vocab=VOCAB, state_dict=one[0], batches=batches[:1],
                         lambdas=LAMBDAS, blank=BLANK))
    for name, par in (("accum", {}), ("accum_fsdp", {"fsdp": True})):
        jobs.append(dict(name=name, kind="step", cfg=_cfg(grad_accum=2), parallel=par,
                         input_dim=IN_DIM, vocab=VOCAB, state_dict=accum[0], batches=batches,
                         lambdas=LAMBDAS, blank=BLANK))
    for ts, h in HALOS:
        jobs.append(dict(name=f"halo_{ts}_{h}", kind="halo", ts=ts, h=h))
    ranks = run_group(jobs, tmp_path_factory.mktemp("par_train"))
    want = {name: one for name in CASES}
    want["accum"] = want["accum_fsdp"] = accum
    return ranks, want


def _check(ranks, want, name, param_atol=2e-5):
    """``param_atol``: test_torch_training's, 2e-5 after one step (Adam's
    first step is ±lr·g/|g|), 5e-5 after an accumulated one."""
    got = ranks[0][name]
    _, losses, grads, after = want[name]
    for i, (g, w) in enumerate(zip(got["losses"], losses)):
        for k in ("total", "ctc", "distill"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"{name} {k} {i}")
    for n, w in grads.items():
        if n not in got["grads"]:
            assert ".bn." in n, n  # running statistics: buffers, no gradient
            continue
        atol = max(GRAD_REL * float(w.abs().max()), GRAD_FLOOR)
        np.testing.assert_allclose(got["grads"][n].numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{name} grad {n}")
    bufs = {n for n in after if n.endswith((".bn.mean", ".bn.var"))}
    assert bufs
    for n, w in after.items():
        if n.endswith(NOISE_ONLY):
            continue
        tol = STAT_ATOL if n in bufs else param_atol
        np.testing.assert_allclose(got["state"][n].numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=f"{name} {n}")
    for n in bufs:  # the running statistics are the same on every rank
        assert torch.equal(ranks[1][name]["state"][n], got["state"][n]), n


def test_data_parallel_step_at_an_uneven_batch_matches_jax(runs):
    _check(*runs, "dp")


def test_data_parallel_fsdp_step_matches_jax(runs):
    _check(*runs, "fsdp")


def test_tensor_parallel_step_matches_jax(runs):
    """``model: 2`` without ``sequence``: the residual stream replicated,
    the FFN and attention bracketed by copy / all-reduce."""
    _check(*runs, "tp")


def test_tensor_and_sequence_parallel_step_at_an_odd_length_matches_jax(runs):
    assert (T - 1) // 2 + 1 == 33  # T′: the degree 2 does not divide it
    _check(*runs, "tp_sp")


def test_tp_sp_fsdp_step_with_the_fused_ops_matches_jax(runs):
    """``configs/tpu_scaled_large.yaml``'s block (model 2, sequence, fsdp)
    with ``attention_impl: fused`` / ``depthwise_impl: pallas``."""
    _check(*runs, "tp_sp_fused")


@pytest.mark.parametrize("name", ["accum", "accum_fsdp"])
def test_grad_accum_over_two_ranks_matches_jax(runs, name):
    """Two micro-steps, one update; under FSDP the accumulator is sharded."""
    ranks, want = runs
    _check(ranks, want, name, param_atol=5e-5)
    assert ranks[0][name]["update_count"] == 1 and ranks[0][name]["mini_step"] == 0


@pytest.mark.parametrize("ts,h", HALOS)
def test_stencil_window_is_the_neighbours_frames_and_contiguous(runs, ts, h):
    """``collectives.halo``: each rank's window is its shard with ``h``
    frames of the neighbours' ('SAME' zeros at the ends), contiguous as the
    card's stencil kernel takes it; the backward sums every window's
    gradient of a frame at the frame's owner."""
    ranks, _ = runs
    got = [r[f"halo_{ts}_{h}"] for r in ranks]
    full = torch.arange(3 * ts * 2 * 4, dtype=torch.float32).reshape(3, 2 * ts, 4)
    padded = torch.nn.functional.pad(full, (0, 0, h, h))
    g_padded = torch.zeros_like(padded)
    for r, res in enumerate(got):
        assert res["contiguous"]
        assert torch.equal(res["y"], padded[:, r * ts:r * ts + ts + 2 * h])
        g_padded[:, r * ts:r * ts + ts + 2 * h] += res["gy"]
    for r, res in enumerate(got):
        assert torch.equal(res["gx"], g_padded[:, h + r * ts:h + (r + 1) * ts])
