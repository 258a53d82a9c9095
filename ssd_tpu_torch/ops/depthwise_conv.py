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
:func:`depthwise_conv1d_bwd_plain`. There is no fall back: a CUDA tensor
reaches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ssd_tpu_torch.utils.cuda_build import CudaKernel, CudaLibrary, check_cuda_tensor


def _check_odd(K: int) -> None:
    if K % 2 == 0:
        raise ValueError(f"depthwise_conv1d requires an odd kernel size, got K={K}")


# --------------------------------------------------------------------------
# Plain versions (CPU path; the card's reference for the kernels)
# --------------------------------------------------------------------------


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_fwd_kernel``: x (B, T, C), w (K, C), b (C,) → (B, T, C); the bias
    starts the sum and the taps add in order j = 0 … K − 1."""
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
    """``_bwd_kernel``: dx (B, T, C) — tap j adds ``w[j] · g[t + pad − j]`` —
    and the per-batch dw partials (B, K, C), ``Σ_t g[t] · x[t + j − pad]``."""
    K = w.shape[0]
    _check_odd(K)
    T = x.shape[1]
    pad = (K - 1) // 2
    gp = F.pad(g, (0, 0, pad, pad))
    xp = F.pad(x, (0, 0, pad, pad))
    dx = torch.zeros_like(x, dtype=torch.float32)
    for j in range(K):
        dx = dx + gp[:, 2 * pad - j : 2 * pad - j + T] * w[j]
    dwp = torch.stack([(g * xp[:, j : j + T]).sum(dim=1) for j in range(K)], dim=1)
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
        "ssd_dw_bwd_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "ssd_dw_bwd_strips": ([_I, _I, _I, _I], _I),
    },
    error_string="ssd_dw_error_string",
)


class _DepthwiseKernel(CudaKernel):
    """Shared checks of the two wrappers; launch and count are
    :class:`CudaKernel`'s."""

    def __init__(self) -> None:
        super().__init__(_DW_LIBRARY)

    def _shapes(self, x: torch.Tensor, w: torch.Tensor) -> tuple:
        if x.dim() != 3 or min(x.shape) < 1:
            raise ValueError(f"x must be a non-empty (B, T, C) tensor, got {tuple(x.shape)}")
        B, T, C = x.shape
        if w.dim() != 2 or w.shape[1] != C:
            raise ValueError(f"w must be (K, C={C}), got {tuple(w.shape)}")
        K = w.shape[0]
        check_cuda_tensor("x", x, (B, T, C))
        check_cuda_tensor("w", w, (K, C), device=x.device)
        _check_odd(K)
        if K > MAX_KERNEL_SIZE:
            raise ValueError(f"the depthwise kernels take K ≤ {MAX_KERNEL_SIZE}, got K={K}")
        return B, T, C, K


class DepthwiseFwdKernel(_DepthwiseKernel):
    """Forward stencil of ``csrc/depthwise_conv.cu`` (replaces ``_fwd_kernel``):
    x (B, T, C), w (K, C), b (C,) → y (B, T, C)."""

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        B, T, C, K = self._shapes(x, w)
        check_cuda_tensor("b", b, (C,), device=x.device)
        y = torch.empty_like(x)
        self.launch("ssd_dw_fwd_launch", x.device,
                     x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, T, C, K)
        return y


class DepthwiseBwdKernel(_DepthwiseKernel):
    """Backward of ``csrc/depthwise_conv.cu`` (replaces ``_bwd_kernel``):
    x, w and the output gradient g → dx (B, T, C) and the partials
    (B, strips, K + 1, C), one per (batch row, strip of 64-row time tiles):
    rows 0 … K − 1 the dw partials ``Σ_t g[t] · x[t + j − pad]``, row K the
    db partial ``Σ_t g[t]``. The kernel picks the strip count for the
    card's SM count."""

    def __call__(self, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
        B, T, C, K = self._shapes(x, w)
        check_cuda_tensor("g", g, (B, T, C), device=x.device)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        strips = self.library.load().ssd_dw_bwd_strips(B, T, C, sms)
        dx = torch.empty_like(x)
        part = torch.empty((B, strips, K + 1, C), dtype=torch.float32, device=x.device)
        self.launch("ssd_dw_bwd_launch", x.device, x.data_ptr(), w.data_ptr(), g.data_ptr(),
                     dx.data_ptr(), part.data_ptr(), B, T, C, K, strips)
        return dx, part


DW_FWD = DepthwiseFwdKernel()
DW_BWD = DepthwiseBwdKernel()


class _DepthwiseConv1d(torch.autograd.Function):
    """``depthwise_conv1d``'s custom VJP (``_dw_fwd`` / ``_dw_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return depthwise_conv1d_plain(x, w, b)
        return DW_FWD(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dwp = depthwise_conv1d_bwd_plain(x, w, g)
            dw, db = dwp.sum(dim=0), g.to(torch.float32).sum(dim=(0, 1))
        else:
            # autograd may hand over any layout; the kernel takes (B, T, C) rows
            dx, part = DW_BWD(x, w, g.contiguous())
            sums = part.sum(dim=(0, 1))  # (K + 1, C): dw's K rows, then db
            dw, db = sums[:-1], sums[-1]
        return dx, dw.to(w.dtype), db


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """'SAME'-padded depthwise conv: x (B, T, C), w (K, C), b (C,) → (B, T, C).

    Odd K only (``ValueError`` otherwise). CUDA tensors → :data:`DW_FWD` and,
    in the backward, :data:`DW_BWD`; CPU tensors → the plain versions.
    """
    _check_odd(w.shape[0])
    return _DepthwiseConv1d.apply(x, w, b)
