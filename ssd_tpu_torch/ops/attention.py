"""Fused self-attention (PyTorch port of ``ssd_tpu/ops/attention.py``).

``softmax(q·kᵀ·hd^-½ with masked keys at −1e30)``, in fp32, times an
optional (T, T) dropout multiplier, times v — the Pallas kernel's numerics:
the scale multiplies *after* the product and masked keys sit at −1e30,
where flax (and the port's default ``attention_impl: flax`` path) scales q
before the product and masks with ``finfo(float32).min``. The two differ
only in rounding. A fully masked row gets uniform weights either way.

:func:`fused_attention` is a ``torch.autograd.Function`` mirroring the JAX
custom VJP (``_fused_attn``): the backward recomputes the softmax and
returns dq, dk, dv; the key mask and the multiplier get no gradient. The
dropout multiplier is drawn once by the caller, broadcast over batch and
heads (flax's ``broadcast_dropout``), and fed to both directions.

Each direction dispatches on the device of its input: a CUDA tensor goes to
the hand-written kernels of ``csrc/attention.cu`` (:data:`ATTN_FWD`,
:data:`ATTN_BWD`), a CPU tensor to the plain versions
:func:`fused_attention_plain` / :func:`fused_attention_bwd_plain`. There is
no fall back and no size gate: the JAX package routes a T whose per-cell
buffers overflow the TPU's VMEM (``fits_in_vmem``) to flax's attention;
a flash-tiled CUDA kernel has no such limit, so every T reaches the kernel.
On the card no (T, T) tensor is stored for the backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ssd_tpu_torch.utils.cuda_build import CudaKernel, CudaLibrary, check_cuda_tensor

MASKED = -1e30  # score of a masked key, as in the Pallas kernel
MAX_HEAD_DIM = 64  # the register tile's width in csrc/attention.cu (every config's hd fits)


# --------------------------------------------------------------------------
# Plain versions (CPU path; the card's reference for the kernels)
# --------------------------------------------------------------------------


def _weights(q: torch.Tensor, k: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """fp32 softmax of the masked, scaled scores (B, H, T, T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s.masked_fill(key_mask[:, None, None, :] == 0, MASKED)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def fused_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``_attn_fwd_kernel``: q, k, v (B, H, T, hd), key_mask (B, T) (nonzero
    = valid), mult (T, T) or None → (B, H, T, hd)."""
    w = _weights(q, k, key_mask)
    if mult is not None:
        w = w * mult
    return torch.matmul(w, v)


def fused_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    mult: Optional[torch.Tensor],
    g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_attn_bwd_kernel``: the recomputed softmax w, then
    dv = (w∘mult)ᵀ·g, ds = w∘(dW − Σ dW∘w)·scale with dW = (g·vᵀ)∘mult,
    dq = ds·k, dk = dsᵀ·q."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    w = _weights(q, k, key_mask)
    wd = w * mult if mult is not None else w
    dv = torch.matmul(wd.transpose(-1, -2), g)
    dw = torch.matmul(g, v.transpose(-1, -2))
    if mult is not None:
        dw = dw * mult
    ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True)) * scale
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)

_ATTN_LIBRARY = CudaLibrary(
    "ssd_attention",
    "attention.cu",
    {
        "ssd_attn_fwd_launch": ([_P] * 8 + [_S, _I, _I, _I, _I, _F, _P], _I),
        "ssd_attn_bwd_launch": ([_P] * 13 + [_S, _I, _I, _I, _I, _F, _P], _I),
    },
    error_string="ssd_attn_error_string",
)


def _check_view(name: str, t: torch.Tensor, shape: tuple, device) -> list:
    """A (B, H, T, hd) fp32 view read in place: any (b, h, t) strides, unit
    stride along hd (the kernels never copy). Returns its (b, h, t) strides."""
    check_cuda_tensor(name, t, shape, device=device, contiguous=False)
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride along hd (got strides {t.stride()})")
    return list(t.stride()[:3])


def _empty_like_heads(q: torch.Tensor) -> torch.Tensor:
    """(B, H, T, hd) view of (B, T, H, hd) storage: the layout the output
    projection reads without a copy."""
    B, H, T, hd = q.shape
    return torch.empty((B, T, H, hd), dtype=torch.float32, device=q.device).transpose(1, 2)


class _AttentionKernel(CudaKernel):
    """Shared checks of the two wrappers; launch and count are
    :class:`CudaKernel`'s (the backward's two kernels are one launch call)."""

    def __init__(self) -> None:
        super().__init__(_ATTN_LIBRARY)

    def _inputs(self, q, k, v, key_mask, mult) -> tuple:
        if q.dim() != 4 or min(q.shape) < 1:
            raise ValueError(f"q must be a non-empty (B, H, T, hd) tensor, got {tuple(q.shape)}")
        shape = tuple(q.shape)
        B, H, T, hd = shape
        dev = q.device
        strides = [s for name, t in (("q", q), ("k", k), ("v", v))
                   for s in _check_view(name, t, shape, dev)]
        if hd > MAX_HEAD_DIM:
            raise ValueError(f"the attention kernels take hd ≤ {MAX_HEAD_DIM}, got {hd}")
        check_cuda_tensor("key_mask", key_mask, (B, T), torch.int32, dev)
        if mult is not None:
            check_cuda_tensor("mult", mult, (T, T), device=dev)
        return shape, strides


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class AttentionFwdKernel(_AttentionKernel):
    """Forward of ``csrc/attention.cu`` (replaces ``_attn_fwd_kernel``):
    q, k, v (B, H, T, hd) fp32 views, key_mask (B, T) int32, mult (T, T) or
    None → out (B, H, T, hd) (a view of (B, T, H, hd) storage) and the row
    max and row sum (B, H, T) that the backward recomputes the softmax from."""

    def __call__(self, q, k, v, key_mask, mult=None):
        (B, H, T, hd), strides = self._inputs(q, k, v, key_mask, mult)
        out = _empty_like_heads(q)
        row_max = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        row_sum = torch.empty_like(row_max)
        strides += list(out.stride()[:3])
        self.launch(
            "ssd_attn_fwd_launch", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), _ptr(mult),
            out.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(),
            (ctypes.c_longlong * 12)(*strides), B, H, T, hd, 1.0 / math.sqrt(hd),
        )
        return out, row_max, row_sum


class AttentionBwdKernel(_AttentionKernel):
    """Backward of ``csrc/attention.cu`` (replaces ``_attn_bwd_kernel``): two
    launches — dq (which also stores D = rowsum(g∘out)), then dk and dv —
    counted as one backward. → dq, dk, dv (B, H, T, hd)."""

    def __call__(self, q, k, v, out, g, row_max, row_sum, key_mask, mult=None):
        (B, H, T, hd), strides = self._inputs(q, k, v, key_mask, mult)
        for name, t in (("out", out), ("g", g)):
            strides += _check_view(name, t, (B, H, T, hd), q.device)
        for name, t in (("row_max", row_max), ("row_sum", row_sum)):
            check_cuda_tensor(name, t, (B, H, T), device=q.device)
        grads = [_empty_like_heads(q) for _ in range(3)]
        for t in grads:
            strides += list(t.stride()[:3])
        delta = torch.empty_like(row_max)
        dq, dk, dv = grads
        self.launch(
            "ssd_attn_bwd_launch", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            key_mask.data_ptr(), _ptr(mult), row_max.data_ptr(), row_sum.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            (ctypes.c_longlong * 24)(*strides), B, H, T, hd, 1.0 / math.sqrt(hd),
        )
        return dq, dk, dv


ATTN_FWD = AttentionFwdKernel()
ATTN_BWD = AttentionBwdKernel()


class _FusedAttention(torch.autograd.Function):
    """``_fused_attn``'s custom VJP. On the card it saves q, k, v, out and the
    row statistics — no (T, T) tensor."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, mult):
        if q.device.type == "cpu":
            out = fused_attention_plain(q, k, v, key_mask, mult)
            row_max = row_sum = None
        else:
            out, row_max, row_sum = ATTN_FWD(q, k, v, key_mask, mult)
        ctx.save_for_backward(q, k, v, out, row_max, row_sum, key_mask, mult)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, row_max, row_sum, key_mask, mult = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = fused_attention_bwd_plain(q, k, v, key_mask, mult, g)
        else:
            if g.stride(-1) != 1:  # autograd may hand over any layout
                g = g.contiguous()
            dq, dk, dv = ATTN_BWD(q, k, v, out, g, row_max, row_sum, key_mask, mult)
        return dq, dk, dv, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q·kᵀ·hd^-½, keys masked at −1e30)[∘ mult]·v.

    q, k, v: (B, H, T, hd) fp32 (strided views are read in place);
    key_mask: (B, T), nonzero or True = a valid key; mult: the (T, T)
    dropout multiplier shared by every batch row and head, or None.
    """
    return _FusedAttention.apply(q, k, v, key_mask.to(torch.int32).contiguous(), mult)
