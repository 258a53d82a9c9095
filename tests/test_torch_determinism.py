"""Reproducible training with the port: the twin of
``tests/test_determinism.py`` (identical seeds give identical training
trajectories), the CTC gradient summed without atomics, and cuDNN's
deterministic algorithms while the trainer runs on the card
(``logging.async_checkpoints`` is held in
``tests/test_torch_checkpoint_async.py``).

On the card the same seed gives bit-equal losses too (``chip_smoke.py``
trains twice from one seed in both configurations); here the trainer runs
on the CPU, where it exercises the same code with the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.ops import ctc_loss as jctc
from ssd_tpu_torch.ops import ctc_loss as tctc
from ssd_tpu_torch.training import train as ttrain

from .test_torch_ctc_loss import GRAD_ATOL, LOSS_TOL, _batch
from .test_torch_training import _corpus
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)


def _train(tmp_path, name, seed=0):
    import json

    cfg = json.loads(_corpus(tmp_path / name).read_text())
    cfg["logging"].update(seed=seed)
    return ttrain.train_from_config(cfg, tmp_path / name / "run", dry_run=True, device="cpu")


def test_same_seed_same_losses(tmp_path):
    s1, s2 = _train(tmp_path, "r1"), _train(tmp_path, "r2")
    assert s1["best_val"] == s2["best_val"]
    assert s1["history"][0]["train"]["total"] == s2["history"][0]["train"]["total"]


def test_different_seed_different_losses(tmp_path):
    s1, s2 = _train(tmp_path, "r1"), _train(tmp_path, "r2", seed=123)
    assert s1["best_val"] != s2["best_val"]


def test_cudnn_is_deterministic_only_while_training_on_the_card():
    flags = torch.backends.cudnn
    before = flags.deterministic, flags.benchmark
    flags.benchmark = True
    try:
        with ttrain._deterministic_cudnn(torch.device("cuda")):
            assert (flags.deterministic, flags.benchmark) == (True, False)
        assert (flags.deterministic, flags.benchmark) == (before[0], True)
        with ttrain._deterministic_cudnn(torch.device("cpu")):
            assert (flags.deterministic, flags.benchmark) == (before[0], True)
    finally:
        flags.deterministic, flags.benchmark = before


@pytest.mark.parametrize("T", [24, 200])
def test_ctc_gradient_without_atomics_matches_jax(T, monkeypatch):
    """The log-probs' gradient is the product with the states' one-hot
    labels — no ``scatter_add_`` runs in the backward — and matches the JAX
    loss's gradient at ``tests/test_torch_ctc_loss.py``'s tolerances, on a
    batch with repeated labels, an empty target and an impossible row."""
    lp, ll, tg, tl = _batch(seed=T, T=T)

    def refuse(*args, **kwargs):
        raise AssertionError("the CTC backward added with scatter_add_")

    monkeypatch.setattr(torch.Tensor, "scatter_add_", refuse)
    x = torch.from_numpy(lp).requires_grad_(True)
    loss = tctc.ctc_loss(x, torch.from_numpy(ll), torch.from_numpy(tg), torch.from_numpy(tl), 1)
    loss.sum().backward()

    def f(a):
        return jctc.ctc_loss(a, jnp.asarray(ll), jnp.asarray(tg), jnp.asarray(tl), blank_id=1,
                             impl="scan")

    want, vjp = jax.vjp(f, jnp.asarray(lp))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), **LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.ones_like(want))[0]), rtol=0,
                               atol=GRAD_ATOL)
