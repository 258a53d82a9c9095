"""Depthwise 1-D convolution, the conv module's stencil (PyTorch port of
``ssd_tpu/ops/depthwise_conv.py``).

'SAME'-padded, channel-last: ``y[b, t, c] = bias[c] + Σ_j w[j, c] ·
x[b, t + j − pad, c]`` with ``pad = (K − 1) // 2`` and zeros outside
``[0, T)``; odd K only, as in the JAX package (with even K the ``nn.Conv`` it
stands in for would emit T − 1 frames).

:func:`depthwise_conv1d` is a ``torch.autograd.Function`` mirroring the JAX
custom VJP: dx is the flipped stencil over the incoming gradient, dw the
kernel's partials summed outside it, db the gradient summed over (batch,
time) — on the card a row of the backward kernel's partials, on the CPU
``g.sum``. Each direction dispatches on the device
of its input: a CUDA tensor goes to the hand-written kernels of
``csrc/depthwise_conv.cu`` (:data:`DW_FWD`, :data:`DW_BWD`), a CPU tensor to
the plain versions :func:`depthwise_conv1d_plain` /
:func:`depthwise_conv1d_bwd_plain`. The forward is the custom op
``ssd_tpu_torch::depthwise_fwd`` (PyTorch's dispatcher picks the device's
implementation), so that a captured graph (``torch.export``) holds it as one
node; the backward, which no exported graph reaches, dispatches in Python.
There is no fall back: a CUDA tensor reaches the kernel or raises.

Two dtypes, as the JAX package's ``DepthwiseConv1d`` runs in the model's
compute dtype: fp32, and bf16 (``compute_dtype: bfloat16``), where x, w and
b are bf16, each tap's product is rounded to bf16 before the fp32 sum (the
Pallas kernel forms ``src * w[j]`` in bf16), y and dx are bf16, and dw and
db — fp32 sums — are rounded to bf16, the dtype of the w and b the op was
given, as the JAX VJP casts them (autograd then upcasts them to the fp32
parameters). Each dtype has its own kernel instance and its own launch
count (:data:`DW_FWD` / :data:`DW_FWD_BF16`, :data:`DW_BWD` /
:data:`DW_BWD_BF16`); another dtype on the card raises. The fp32 kernels
take one channel a thread; the bf16 ones two, loaded and stored as one
bf16x2 word, each tap's product formed by a bf16x2 multiply (the exact
product rounded once, which equals the plain version's fp32 product rounded
to bf16 on every input).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ssd_tpu_torch.utils.cuda_build import (
    DTYPE_SUFFIX,
    CudaKernel,
    CudaLibrary,
    check_cuda_tensor,
    instance_for,
)


def _check_odd(K: int) -> None:
    if K % 2 == 0:
        raise ValueError(f"depthwise_conv1d requires an odd kernel size, got K={K}")


# --------------------------------------------------------------------------
# Plain versions (CPU path; the card's reference for the kernels)
# --------------------------------------------------------------------------


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_fwd_kernel``: x (B, T, C), w (K, C), b (C,) → (B, T, C); the bias
    starts the sum and the taps add in order j = 0 … K − 1, in fp32. Each
    product ``x · w[j]`` is formed in the inputs' dtype (in bf16: rounded)
    and type promotion adds it to the fp32 sum."""
    K = w.shape[0]
    _check_odd(K)
    T = x.shape[1]
    pad = (K - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    acc = b.to(torch.float32).expand(x.shape)
    for j in range(K):
        acc = acc + xp[:, j : j + T] * w[j]
    return acc.to(x.dtype)


def depthwise_conv1d_bwd_plain(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``_bwd_kernel``: dx (B, T, C) — tap j adds ``w[j] · g[t + pad − j]``,
    a product in the inputs' dtype, to an fp32 sum — and the per-batch fp32
    dw partials (B, K, C), ``Σ_t g[t] · x[t + j − pad]`` of the upcast
    values."""
    K = w.shape[0]
    _check_odd(K)
    T = x.shape[1]
    pad = (K - 1) // 2
    gp = F.pad(g, (0, 0, pad, pad))
    xp = F.pad(x, (0, 0, pad, pad))
    dx = torch.zeros_like(x, dtype=torch.float32)
    for j in range(K):
        dx = dx + gp[:, 2 * pad - j : 2 * pad - j + T] * w[j]
    gf, xpf = g.to(torch.float32), xp.to(torch.float32)
    dwp = torch.stack([(gf * xpf[:, j : j + T]).sum(dim=1) for j in range(K)], dim=1)
    return dx.to(x.dtype), dwp


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_KERNEL_SIZE = 31  # the largest K the kernels unroll, kMaxK in csrc/depthwise_conv.cu

_DW_LIBRARY = CudaLibrary(
    "ssd_depthwise",
    "depthwise_conv.cu",
    {
        "ssd_dw_fwd_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "ssd_dw_fwd_bf16_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "ssd_dw_fwd_ctas": ([_I, _I, _I], _I),
        "ssd_dw_bwd_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "ssd_dw_bwd_bf16_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "ssd_dw_bwd_strips": ([_I, _I, _I, _I], _I),
        "ssd_dw_bwd_bf16_strips": ([_I, _I, _I, _I], _I),
    },
    error_string="ssd_dw_error_string",
)


class _DepthwiseKernel(CudaKernel):
    """Shared checks of the two wrappers, for the kernel instance of one
    dtype; launch and count are :class:`CudaKernel`'s."""

    def __init__(self, dtype: torch.dtype) -> None:
        super().__init__(_DW_LIBRARY, dtype)

    def _shapes(self, x: torch.Tensor, w: torch.Tensor) -> tuple:
        if x.dim() != 3 or min(x.shape) < 1:
            raise ValueError(f"x must be a non-empty (B, T, C) tensor, got {tuple(x.shape)}")
        B, T, C = x.shape
        if w.dim() != 2 or w.shape[1] != C:
            raise ValueError(f"w must be (K, C={C}), got {tuple(w.shape)}")
        K = w.shape[0]
        check_cuda_tensor("x", x, (B, T, C), self.dtype)
        check_cuda_tensor("w", w, (K, C), self.dtype, x.device)
        _check_odd(K)
        if K > MAX_KERNEL_SIZE:
            raise ValueError(f"the depthwise kernels take K ≤ {MAX_KERNEL_SIZE}, got K={K}")
        return B, T, C, K


class DepthwiseFwdKernel(_DepthwiseKernel):
    """Forward stencil of ``csrc/depthwise_conv.cu`` (replaces ``_fwd_kernel``):
    x (B, T, C), w (K, C), b (C,) → y (B, T, C), all of the instance's
    dtype; a thread computes 16 rows of one channel (fp32) or of two
    neighbouring channels as bf16x2 words (bf16) from a window of 16 + K − 1
    rows it loads into registers."""

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        B, T, C, K = self._shapes(x, w)
        check_cuda_tensor("b", b, (C,), self.dtype, x.device)
        y = torch.empty_like(x)
        self.launch(self.entry("ssd_dw_fwd"), x.device,
                     x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, T, C, K)
        return y


class DepthwiseBwdKernel(_DepthwiseKernel):
    """Backward of ``csrc/depthwise_conv.cu`` (replaces ``_bwd_kernel``):
    x, w and the output gradient g (the instance's dtype) → dx (B, T, C)
    and the fp32 partials (B, strips, K + 1, C), one per (batch row, strip
    of 64-row time tiles):
    rows 0 … K − 1 the dw partials ``Σ_t g[t] · x[t + j − pad]``, row K the
    db partial ``Σ_t g[t]``. The kernel picks the strip count for the
    card's SM count; a CTA takes 32 channels (fp32) or 64, two a thread
    (bf16)."""

    def __call__(self, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
        B, T, C, K = self._shapes(x, w)
        check_cuda_tensor("g", g, (B, T, C), self.dtype, x.device)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        strips_fn = getattr(self.library.load(), f"ssd_dw_bwd{DTYPE_SUFFIX[self.dtype]}_strips")
        strips = strips_fn(B, T, C, sms)
        dx = torch.empty_like(x)
        part = torch.empty((B, strips, K + 1, C), dtype=torch.float32, device=x.device)
        self.launch(self.entry("ssd_dw_bwd"), x.device, x.data_ptr(), w.data_ptr(), g.data_ptr(),
                     dx.data_ptr(), part.data_ptr(), B, T, C, K, strips)
        return dx, part


DW_FWD = DepthwiseFwdKernel(torch.float32)
DW_BWD = DepthwiseBwdKernel(torch.float32)
DW_FWD_BF16 = DepthwiseFwdKernel(torch.bfloat16)
DW_BWD_BF16 = DepthwiseBwdKernel(torch.bfloat16)
_FWD, _BWD = (DW_FWD, DW_FWD_BF16), (DW_BWD, DW_BWD_BF16)


# --------------------------------------------------------------------------
# The forward as a custom op: opaque to graph capture, one schema on both
# devices
# --------------------------------------------------------------------------


@torch.library.custom_op(
    "ssd_tpu_torch::depthwise_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, Tensor b) -> Tensor",
)
def _depthwise_fwd_op(x, w, b):
    return depthwise_conv1d_plain(x, w, b)


@_depthwise_fwd_op.register_kernel("cuda")
def _depthwise_fwd_cuda(x, w, b):
    return instance_for(_FWD, "x", x)(x, w, b)


@_depthwise_fwd_op.register_fake
def _depthwise_fwd_fake(x, w, b):
    return torch.empty_like(x)


class _DepthwiseConv1d(torch.autograd.Function):
    """``depthwise_conv1d``'s custom VJP (``_dw_fwd`` / ``_dw_bwd``): dx in
    x's dtype, dw and db rounded to w's and b's."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return torch.ops.ssd_tpu_torch.depthwise_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dwp = depthwise_conv1d_bwd_plain(x, w, g)
            dw, db = dwp.sum(dim=0), g.to(torch.float32).sum(dim=(0, 1))
        else:
            # autograd may hand over any layout; the kernel takes (B, T, C) rows
            dx, part = instance_for(_BWD, "x", x)(x, w, g.contiguous())
            sums = part.sum(dim=(0, 1))  # (K + 1, C): dw's K rows, then db
            dw, db = sums[:-1], sums[-1]
        return dx, dw.to(w.dtype), db.to(ctx.b_dtype)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """'SAME'-padded depthwise conv: x (B, T, C), w (K, C), b (C,) → (B, T, C),
    all fp32 or all bf16.

    Odd K only (``ValueError`` otherwise). CUDA tensors → the kernel instance
    of their dtype (:data:`DW_FWD` / :data:`DW_FWD_BF16` and, in the
    backward, :data:`DW_BWD` / :data:`DW_BWD_BF16`); CPU tensors → the plain
    versions.
    """
    _check_odd(w.shape[0])
    return _DepthwiseConv1d.apply(x, w, b)
