"""Port parity: ``ssd_tpu_torch.ops.depthwise_conv`` against
``ssd_tpu.ops.depthwise_conv`` on the CPU, fp32.

The JAX side runs as its own tests run it here: the Pallas stencil in
interpret mode, with ``jax.grad`` through its custom VJP. Tolerances:
forward and dx atol = rtol = 1e-5; dw and db, sums over B·T terms, within
1e-4 of the tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.ops.depthwise_conv import depthwise_conv1d as jax_depthwise_conv1d
from ssd_tpu_torch.models import conformer as tconf
from ssd_tpu_torch.ops import depthwise_conv as tdw

torch.set_num_threads(1)

B, C = 3, 16
TOL = dict(atol=1e-5, rtol=1e-5)
SUM_REL = 1e-4


def _inputs(T, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    g = rng.normal(size=(B, T, C)).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("T,K", [(40, 3), (40, 5), (40, 15), (15, 15), (70, 15)])
def test_forward_and_gradients_match_jax(T, K):
    x, w, b, g = _inputs(T, K, seed=K + T)
    y, vjp = jax.vjp(jax_depthwise_conv1d, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_dx, want_dw, want_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    got = tdw.depthwise_conv1d(xt, wt, bt)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **TOL)
    for name, a, want in (("dw", wt.grad, want_dw), ("db", bt.grad, want_db)):
        np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=SUM_REL * np.abs(want).max(),
                                   err_msg=name)


def test_even_kernel_size_raises():
    x, w, b, g = _inputs(12, 4, seed=0)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    for call in (lambda: tdw.depthwise_conv1d(xt, wt, bt),
                 lambda: tdw.depthwise_conv1d_plain(xt, wt, bt),
                 lambda: tdw.depthwise_conv1d_bwd_plain(xt, wt, torch.from_numpy(g))):
        with pytest.raises(ValueError, match="odd kernel size"):
            call()


def test_cpu_tensors_take_the_plain_path_and_the_wrappers_refuse_them():
    x, w, b, g = _inputs(20, 5, seed=1)
    xt = torch.from_numpy(x).requires_grad_(True)
    before = (tdw.DW_FWD.launches, tdw.DW_BWD.launches)
    tdw.depthwise_conv1d(xt, torch.from_numpy(w), torch.from_numpy(b)).sum().backward()
    assert (tdw.DW_FWD.launches, tdw.DW_BWD.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tdw.DW_FWD(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))


@pytest.mark.parametrize("train", [False, True])
def test_conv_module_pallas_matches_lax_on_the_same_weights(train):
    """``depthwise_impl: pallas`` keeps ``nn.Conv1d``'s parameters: the same
    module state gives the same outputs and parameter gradients."""
    torch.manual_seed(0)
    lax = tconf._ConvModule(C, 7, "batch", 0.0, "lax")
    pls = tconf._ConvModule(C, 7, "batch", 0.0, "pallas")
    pls.load_state_dict(lax.state_dict())
    x = torch.randn(B, 30, C)
    mask = torch.arange(30)[None, :] < torch.tensor([30, 21, 9])[:, None]
    outs = []
    for m in (lax, pls):
        y = m(x, mask, train=train)
        (y * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        outs.append((y.detach(), {n: p.grad for n, p in m.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], **TOL)
    for name, g in outs[0][1].items():
        if train and name == "dw.bias":
            # before a training BatchNorm its true gradient is 0 (the batch
            # mean removes it): both paths return rounding noise
            continue
        torch.testing.assert_close(outs[1][1][name], g, atol=SUM_REL * float(g.abs().max()),
                                   rtol=0, msg=name)
