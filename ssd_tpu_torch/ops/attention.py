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
:func:`fused_attention_plain` / :func:`fused_attention_bwd_plain`. The
forward is the custom op ``ssd_tpu_torch::attention_fwd`` (PyTorch's
dispatcher picks the device's implementation), so that a captured graph
(``torch.export``) holds it as one node; the backward, which no exported
graph reaches, dispatches in Python. There is
no fall back and no size gate: the JAX package routes a T whose per-cell
buffers overflow the TPU's VMEM (``fits_in_vmem``) to flax's attention;
a flash-tiled CUDA kernel has no such limit, so every T reaches the kernel.
On the card no (T, T) tensor is stored for the backward.

Two dtypes, as the Pallas kernels run in the model's compute dtype: fp32,
and bf16 (``compute_dtype: bfloat16``). In bf16, q, k, v (and g, and the
multiplier, built in bf16: ``1/0.9`` rounds to 1.109375) are bf16; every
product takes them as they are and sums in fp32; the softmax, its row max
and row sum stay fp32; the (multiplied) weights are rounded to bf16 before
``·v``, and the backward rounds ``w ∘ mult`` and ``ds`` to bf16 before its
products; out, dq, dk and dv are bf16. Each dtype has its own kernel
instance and launch count (:data:`ATTN_FWD` / :data:`ATTN_FWD_BF16`,
:data:`ATTN_BWD` / :data:`ATTN_BWD_BF16`); another dtype on the card raises.
A bf16 call that needs a gradient goes through a second custom op,
``ssd_tpu_torch::attention_fwd_train``, which also returns the output in
fp32 before its rounding: the bf16 backward takes D = rowsum(g ∘ out) from
it (bf16 ``out`` would carry a 2⁻⁸ rounding into ds) and saves it in place of
``out``; serving and export keep ``attention_fwd``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ssd_tpu_torch.utils.cuda_build import CudaKernel, CudaLibrary, check_cuda_tensor, instance_for

MASKED = -1e30  # score of a masked key, as in the Pallas kernel
MAX_HEAD_DIM = 64  # the register tile's width in csrc/attention.cu (every config's hd fits)


# --------------------------------------------------------------------------
# Plain versions (CPU path; the card's reference for the kernels)
# --------------------------------------------------------------------------


def _softmax_parts(q: torch.Tensor, k: torch.Tensor, key_mask: torch.Tensor) -> tuple:
    """The masked, scaled scores' exponentials ``e = exp(s − m)`` (B, H, T, T)
    with the row max ``m`` and the row sum ``l = Σ e`` (B, H, T, 1): what the
    forward kernel keeps for the backward. In fp32 whatever the inputs'
    dtype: the products of bf16 q and k sum in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(key_mask[:, None, None, :] == 0, MASKED)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e, m, e.sum(dim=-1, keepdim=True)


def _weights(q: torch.Tensor, k: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """fp32 softmax of the masked, scaled scores (B, H, T, T)."""
    e, _, l = _softmax_parts(q, k, key_mask)
    return e / l


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` and back: the value a product in
    ``dtype`` takes (a no-op in fp32)."""
    return x.to(dtype).float()


def _weighted_values(w: torch.Tensor, mult: Optional[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
    """``(w ∘ mult)·v`` in fp32, the weights rounded to v's dtype first."""
    if mult is not None:
        w = w * mult.float()
    return torch.matmul(_rounded(w, v.dtype), v.float())


def fused_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``_attn_fwd_kernel``: q, k, v (B, H, T, hd), key_mask (B, T) (nonzero
    = valid), mult (T, T) or None → (B, H, T, hd) in q's dtype."""
    return _weighted_values(_weights(q, k, key_mask), mult, v).to(q.dtype)


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
    dq = ds·k, dk = dsᵀ·q; in fp32, with ``w∘mult`` and ``ds`` rounded to
    q's dtype before their products, and the gradients in q's dtype."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    w = _weights(q, k, key_mask)
    m = mult.float() if mult is not None else None
    wd = w * m if m is not None else w
    gf = g.float()
    dv = torch.matmul(_rounded(wd, dt).transpose(-1, -2), gf)
    dw = torch.matmul(gf, v.float().transpose(-1, -2))
    if m is not None:
        dw = dw * m
    ds = _rounded(w * (dw - (dw * w).sum(dim=-1, keepdim=True)) * scale, dt)
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


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
        "ssd_attn_fwd_bf16_launch": ([_P] * 9 + [_S, _S, _I, _I, _I, _I, _F, _P], _I),
        "ssd_attn_bwd_bf16_launch": ([_P] * 13 + [_S, _I, _I, _I, _I, _F, _P], _I),
    },
    error_string="ssd_attn_error_string",
)


def _check_view(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> list:
    """A (B, H, T, hd) view of ``dtype`` read in place: any (b, h, t)
    strides, unit stride along hd (the kernels never copy). Returns its
    (b, h, t) strides."""
    check_cuda_tensor(name, t, shape, dtype, device, contiguous=False)
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride along hd (got strides {t.stride()})")
    return list(t.stride()[:3])


def _empty_like_heads(q: torch.Tensor) -> torch.Tensor:
    """(B, H, T, hd) view of (B, T, H, hd) storage, in q's dtype: the
    layout the output projection reads without a copy."""
    B, H, T, hd = q.shape
    return torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)



class _AttentionKernel(CudaKernel):
    """Shared checks of the two wrappers, for the kernel instance of one
    dtype (q, k, v, g, the outputs and the multiplier; the key mask is
    int32, the row statistics fp32); launch and count are
    :class:`CudaKernel`'s (the backward's two kernels are one launch call)."""

    def __init__(self, dtype: torch.dtype) -> None:
        super().__init__(_ATTN_LIBRARY, dtype)

    def _inputs(self, q, k, v, key_mask, mult) -> tuple:
        if q.dim() != 4 or min(q.shape) < 1:
            raise ValueError(f"q must be a non-empty (B, H, T, hd) tensor, got {tuple(q.shape)}")
        shape = tuple(q.shape)
        B, H, T, hd = shape
        dev = q.device
        strides = [s for name, t in (("q", q), ("k", k), ("v", v))
                   for s in _check_view(name, t, shape, self.dtype, dev)]
        if hd > MAX_HEAD_DIM:
            raise ValueError(f"the attention kernels take hd ≤ {MAX_HEAD_DIM}, got {hd}")
        check_cuda_tensor("key_mask", key_mask, (B, T), torch.int32, dev)
        if mult is not None:
            check_cuda_tensor("mult", mult, (T, T), self.dtype, dev)
        return shape, strides


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class AttentionFwdKernel(_AttentionKernel):
    """Forward of ``csrc/attention.cu`` (replaces ``_attn_fwd_kernel``):
    q, k, v (B, H, T, hd) views, key_mask (B, T) int32, mult (T, T) or
    None → out (B, H, T, hd) (a view of (B, T, H, hd) storage) and the fp32
    row max and row sum (B, H, T) that the backward recomputes the softmax
    from. With ``fp32_out`` (the bf16 instance, for training) it returns
    (out, out32, row max, row sum): out32 is the output in fp32 before its
    bf16 rounding, contiguous (B, H, T, hd), which the bf16 backward takes in
    out's place."""

    def __call__(self, q, k, v, key_mask, mult=None, fp32_out=False):
        (B, H, T, hd), strides = self._inputs(q, k, v, key_mask, mult)
        if fp32_out and self.dtype != torch.bfloat16:
            raise ValueError("fp32_out is for the bf16 instance: the fp32 output is fp32 already")
        out = _empty_like_heads(q)
        row_max = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        row_sum = torch.empty_like(row_max)
        strides += list(out.stride()[:3])
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), _ptr(mult),
                out.data_ptr()]
        out32 = None
        if self.dtype == torch.bfloat16:
            if fp32_out:
                out32 = torch.empty((B, H, T, hd), dtype=torch.float32, device=q.device)
            args += [_ptr(out32), row_max.data_ptr(), row_sum.data_ptr(),
                     (ctypes.c_longlong * 12)(*strides),
                     (ctypes.c_longlong * 3)(*(out32.stride()[:3] if fp32_out else (0, 0, 0)))]
        else:
            args += [row_max.data_ptr(), row_sum.data_ptr(), (ctypes.c_longlong * 12)(*strides)]
        self.launch(self.entry("ssd_attn_fwd"), q.device, *args, B, H, T, hd, 1.0 / math.sqrt(hd))
        return (out, out32, row_max, row_sum) if fp32_out else (out, row_max, row_sum)


class AttentionBwdKernel(_AttentionKernel):
    """Backward of ``csrc/attention.cu`` (replaces ``_attn_bwd_kernel``): two
    launches — dq (which also stores D for the second), then dk and dv —
    counted as one backward. ``out``: the forward's output — for the bf16
    instance the fp32 one its forward returns with ``fp32_out``, from which
    the dq kernel takes D = rowsum(g ∘ out) (the fp32 instance sums D from
    w and dP and reads no out). → dq, dk, dv (B, H, T, hd)."""

    def __call__(self, q, k, v, out, g, row_max, row_sum, key_mask, mult=None):
        (B, H, T, hd), strides = self._inputs(q, k, v, key_mask, mult)
        strides += _check_view("out", out, (B, H, T, hd), torch.float32, q.device)
        strides += _check_view("g", g, (B, H, T, hd), self.dtype, q.device)
        for name, t in (("row_max", row_max), ("row_sum", row_sum)):
            check_cuda_tensor(name, t, (B, H, T), device=q.device)
        grads = [_empty_like_heads(q) for _ in range(3)]
        for t in grads:
            strides += list(t.stride()[:3])
        # fp32: D; bf16: D and 1 / the row sum
        scratch = torch.empty((1 if self.dtype == torch.float32 else 2, B, H, T),
                              dtype=torch.float32, device=q.device)
        dq, dk, dv = grads
        self.launch(
            self.entry("ssd_attn_bwd"), q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            key_mask.data_ptr(), _ptr(mult), row_max.data_ptr(), row_sum.data_ptr(),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            (ctypes.c_longlong * 24)(*strides), B, H, T, hd, 1.0 / math.sqrt(hd),
        )
        return dq, dk, dv


ATTN_FWD = AttentionFwdKernel(torch.float32)
ATTN_BWD = AttentionBwdKernel(torch.float32)
ATTN_FWD_BF16 = AttentionFwdKernel(torch.bfloat16)
ATTN_BWD_BF16 = AttentionBwdKernel(torch.bfloat16)
_FWD, _BWD = (ATTN_FWD, ATTN_FWD_BF16), (ATTN_BWD, ATTN_BWD_BF16)


# --------------------------------------------------------------------------
# The forward as a custom op: opaque to graph capture, one schema on both
# devices (the CPU version computes the row statistics the kernel stores)
# --------------------------------------------------------------------------


@torch.library.custom_op(
    "ssd_tpu_torch::attention_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor key_mask, Tensor? mult) "
           "-> (Tensor, Tensor, Tensor)",
)
def _attention_fwd_op(q, k, v, key_mask, mult):
    e, m, l = _softmax_parts(q, k, key_mask)
    out = _empty_like_heads(q)
    out.copy_(_weighted_values(e / l, mult, v))
    return out, m[..., 0], l[..., 0]


@_attention_fwd_op.register_kernel("cuda")
def _attention_fwd_cuda(q, k, v, key_mask, mult):
    return instance_for(_FWD, "q", q)(q, k, v, key_mask, mult)


@_attention_fwd_op.register_fake
def _attention_fwd_fake(q, k, v, key_mask, mult):
    B, H, T, hd = q.shape
    row_max = q.new_empty((B, H, T), dtype=torch.float32)
    return _empty_like_heads(q), row_max, torch.empty_like(row_max)


@torch.library.custom_op(
    "ssd_tpu_torch::attention_fwd_train", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor key_mask, Tensor? mult) "
           "-> (Tensor, Tensor, Tensor, Tensor)",
)
def _attention_fwd_train_op(q, k, v, key_mask, mult):
    """The forward of a call that needs a gradient: ``attention_fwd``'s out,
    row max and row sum, and beside out its fp32 value before the rounding
    to q's dtype (contiguous (B, H, T, hd)), which the bf16 backward takes D
    from. On the card it is the bf16 instance's (the fp32 one needs none)."""
    e, m, l = _softmax_parts(q, k, key_mask)
    out32 = _weighted_values(e / l, mult, v)
    out = _empty_like_heads(q)
    out.copy_(out32)
    return out, out32, m[..., 0], l[..., 0]


@_attention_fwd_train_op.register_kernel("cuda")
def _attention_fwd_train_cuda(q, k, v, key_mask, mult):
    return ATTN_FWD_BF16(q, k, v, key_mask, mult, fp32_out=True)


@_attention_fwd_train_op.register_fake
def _attention_fwd_train_fake(q, k, v, key_mask, mult):
    B, H, T, hd = q.shape
    row_max = q.new_empty((B, H, T), dtype=torch.float32)
    return (_empty_like_heads(q), q.new_empty((B, H, T, hd), dtype=torch.float32), row_max,
            torch.empty_like(row_max))


class _FusedAttention(torch.autograd.Function):
    """``_fused_attn``'s custom VJP. On the card it saves q, k, v, the output
    (in bf16, its fp32 value before the rounding) and the row statistics — no
    (T, T) tensor."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, mult, train):
        if train and q.dtype == torch.bfloat16:  # the bf16 backward takes D from out in fp32
            out, saved, row_max, row_sum = torch.ops.ssd_tpu_torch.attention_fwd_train(
                q, k, v, key_mask, mult)
        else:
            out, row_max, row_sum = torch.ops.ssd_tpu_torch.attention_fwd(q, k, v, key_mask, mult)
            saved = out
        ctx.save_for_backward(q, k, v, saved, row_max, row_sum, key_mask, mult)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, row_max, row_sum, key_mask, mult = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = fused_attention_bwd_plain(q, k, v, key_mask, mult, g)
        else:
            if g.stride(-1) != 1:  # autograd may hand over any layout
                g = g.contiguous()
            dq, dk, dv = instance_for(_BWD, "q", q)(q, k, v, out, g, row_max, row_sum, key_mask,
                                                    mult)
        return dq, dk, dv, None, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q·kᵀ·hd^-½, keys masked at −1e30)[∘ mult]·v.

    q, k, v: (B, H, T, hd), fp32 or bf16 (strided views are read in
    place); key_mask: (B, T), nonzero or True = a valid key; mult: the
    (T, T) dropout multiplier in q's dtype, shared by every batch row and
    head, or None. The output is in q's dtype.
    """
    train = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FusedAttention.apply(q, k, v, key_mask.to(torch.int32).contiguous(), mult, train)
