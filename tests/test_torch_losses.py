"""Port parity: ``ssd_tpu_torch.models.losses`` against ``ssd_tpu.models.losses``
on the CPU, in fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.models import losses as jl
from ssd_tpu_torch.models import losses as tl

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t_in,t_out", [(37, 20), (20, 37), (16, 16), (1, 5)])
def test_interpolate_linear_matches_jax(t_in, t_out):
    x = np.random.default_rng(t_in).normal(size=(2, t_in, 6)).astype(np.float32)
    want = np.asarray(jl.interpolate_linear(jnp.asarray(x), t_out))
    got = tl.interpolate_linear(torch.from_numpy(x), t_out).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("t_teacher", [13, 24], ids=["rescaled", "same-length"])
def test_distillation_mse_matches_jax(normalize, t_teacher):
    rng = np.random.default_rng(3)
    B, Ts, D = 3, 24, 10
    student = rng.normal(size=(B, Ts, D)).astype(np.float32)
    teacher = rng.normal(size=(B, t_teacher, D)).astype(np.float32)
    s_len = np.asarray([24, 17, 0], np.int32)
    # 5 → 9.23 and 7 → 12.92 exercise the round; the 0-length row masks out
    t_len = np.asarray([t_teacher, 5, 7], np.int32)
    want = jl.distillation_mse(jnp.asarray(student), jnp.asarray(s_len), jnp.asarray(teacher),
                               jnp.asarray(t_len), normalize=normalize)
    got = tl.distillation_mse(torch.from_numpy(student), torch.from_numpy(s_len),
                              torch.from_numpy(teacher), torch.from_numpy(t_len), normalize=normalize)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    no_len = tl.distillation_mse(torch.from_numpy(student), torch.from_numpy(s_len),
                                 torch.from_numpy(teacher), None, normalize=normalize)
    want_no_len = jl.distillation_mse(jnp.asarray(student), jnp.asarray(s_len),
                                      jnp.asarray(teacher), None, normalize=normalize)
    np.testing.assert_allclose(float(no_len), float(want_no_len), **TOL)


@pytest.mark.parametrize("with_teacher", [True, False])
def test_joint_loss_matches_jax(with_teacher):
    rng = np.random.default_rng(5)
    B, T, V, S, D = 3, 20, 12, 5, 8
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(B, T, V)).astype(np.float32)), -1).numpy()
    ll = np.asarray([20, 14, 9], np.int32)
    tg = rng.integers(2, V, size=(B, S)).astype(np.int32)
    tlen = np.asarray([5, 3, 0], np.int32)
    student = rng.normal(size=(B, T, D)).astype(np.float32)
    teacher = rng.normal(size=(B, 11, D)).astype(np.float32) if with_teacher else None
    t_len = np.asarray([11, 7, 4], np.int32) if with_teacher else None
    w = dict(lambda_distill=0.35, lambda_ctc=0.65)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want = jl.joint_loss(j(lp), j(ll), j(tg), j(tlen), j(student), j(teacher), j(t_len),
                         jl.LossWeights(**w), blank_id=1)
    got = tl.joint_loss(t(lp), t(ll), t(tg), t(tlen), t(student), t(teacher), t(t_len),
                        tl.LossWeights(**w), blank_id=1)
    for k in ("total", "ctc", "distill"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL)
