"""Conformer EMG encoder (PyTorch port of ``ssd_tpu/models/conformer.py``).

A strided-conv temporal subsampler followed by N Conformer blocks:

* macaron half-residual feed-forward sandwiches (LayerNorm → Linear → SiLU →
  Dropout → Linear → Dropout, scaled by ½),
* multi-head self-attention with a key-padding mask and no positional
  encoding, dropout on the attention weights and on the output,
* conv module: LayerNorm → pointwise 2d → GLU → depthwise(k) → BatchNorm →
  SiLU → pointwise → Dropout,
* per-block final LayerNorm.

The unrolled stack. As in the JAX package, ``train`` is an argument of
every forward, not module state: ``train=True`` turns on dropout (drawn from
the caller's ``generator``) and ``MaskedBatchNorm``'s batch statistics.
Public functions keep the JAX package's channel-last ``(B, T, F)`` layout;
convolutions transpose inside. LayerNorms use flax's epsilon (1e-6), not
torch's default.

``compute_dtype`` is flax's ``dtype=``, not ``torch.autocast``: parameters
stay fp32, and each convolution and Dense layer (:class:`Conv1d`,
:class:`Dense`) casts its input, weight and bias to the compute dtype and
returns it, while every LayerNorm (:class:`LayerNorm`) computes and returns
fp32. So under bf16 the residual stream changes dtype where the JAX
package's does: ``block_0``'s adds run in bf16 on the subsampler's output,
every later block's promote to fp32 on ``final_ln``'s. ``scan_layers: true``
feeds the blocks an fp32 carry (the JAX package's ``nn.scan`` needs a
dtype-stable carry), so the port, which has only the unrolled layout, casts
the subsampler's output to fp32 there; with fp32 compute that is a no-op.
``pipeline_microbatches > 0`` runs the blocks through
``parallel/pipeline.py``: with the same fp32 carry, GPipe over the
``model`` ranks when the trainer placed the model over pipeline stages,
else in order (one process, serving, evaluation).

``remat`` / ``remat_policy`` / ``attn_remat`` are the JAX package's
``nn.remat`` of a block (or of the attention alone) as
``torch.utils.checkpoint`` (:func:`_remat`): ``full`` keeps only the
block's input, ``dots`` also every matrix product (``mm`` / ``addmm`` /
``bmm`` / ``baddbmm``, ``jax.checkpoint_policies.checkpoint_dots``),
``dots_no_batch`` only the 2-D ones (``mm`` / ``addmm``); convolutions and
the fused attention and depthwise ops are recomputed under every policy.
The recompute draws the forward's dropout masks again from the caller's
generator and leaves ``MaskedBatchNorm``'s running statistics alone, so
gradients and buffers equal an un-rematted step's.

``quantize`` (``ssd_tpu/models/conformer.py:168-200``) covers the FFN's
``w1``/``w2`` and the conv module's ``pw1``/``pw2``: ``int8`` quantizes
them on every call that is not training (a float checkpoint serves
quantized; training is float), ``int8_prequant`` holds them as int8 weights
with per-channel scales (``ops/quant.py``'s :class:`QuantDense`, loaded
from :func:`~ssd_tpu_torch.ops.quant.prequantize_state_dict`'s output) and
raises in training.

Two config keys pick the implementation of two ops without changing the
parameters, so a checkpoint of either choice loads into the other:
``attention_impl`` (``flax``: the composite softmax attention; ``fused``:
``ops/attention.py``, the CUDA kernels on the card) and ``depthwise_impl``
(``lax``: ``nn.Conv1d``; ``pallas``: ``ops/depthwise_conv.py``, the CUDA
stencil on the card, on the channel-last activation).
"""

from __future__ import annotations

import functools
import logging
import threading
from dataclasses import dataclass

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ssd_tpu_torch.ops.attention import fused_attention
from ssd_tpu_torch.ops.depthwise_conv import depthwise_conv1d
from ssd_tpu_torch.ops.dropout import dropout, keep_multiplier, stream
from ssd_tpu_torch.parallel import collectives as col
from ssd_tpu_torch.parallel.pipeline import pipelined_stack
from ssd_tpu_torch.ops.quant import QuantDense, int8_linear

_LN_EPS = 1e-6  # flax nn.LayerNorm default

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class EncoderConfig:
    """Mirrors ``ssd_tpu.models.conformer.EncoderConfig`` key for key.

    ``build_model`` rejects values that select a path outside the port.
    ``sequence_parallel`` is recorded here; the trainer's ``parallel:
    {sequence: true}`` turns it on over a ``model`` axis above 1
    (``parallel/partition.py:shard_model``), and it changes nothing on one
    device.
    """

    input_dim: int
    d_model: int = 256
    num_layers: int = 6
    num_heads: int = 4
    ffn_dim: int = 512
    depthwise_conv_kernel_size: int = 15
    dropout: float = 0.1
    subsample_factor: int = 4
    conv_norm: str = "batch"  # batch | layer
    compute_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "full"
    attention_impl: str = "flax"  # flax | fused (same parameters)
    attn_remat: bool = False
    depthwise_impl: str = "lax"  # lax | pallas (same parameters)
    quantize: str = "none"
    sequence_parallel: bool = False
    scan_layers: bool = False
    pipeline_microbatches: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def conv_meta(self) -> list[dict]:
        """(kernel, stride, padding) per subsampler conv — length arithmetic."""
        metas = []
        remaining = self.subsample_factor
        while remaining > 1:
            metas.append({"kernel_size": 5, "stride": 2, "padding": 2})
            remaining //= 2
        if not metas:
            metas.append({"kernel_size": 1, "stride": 1, "padding": 0})
        return metas


def subsampled_lengths(lengths: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """Replays ``floor((L + 2p − k)/s) + 1`` per conv (floor division)."""
    out = lengths
    for m in cfg.conv_meta():
        out = (out + 2 * m["padding"] - m["kernel_size"]).div(
            m["stride"], rounding_mode="floor"
        ) + 1
    return out


def _length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths → (B, t) bool validity mask."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype)``: input, weight and bias cast to
    ``dtype``, the product and the output in it; the parameters stay fp32.

    ``quantize="int8"`` is the JAX package's ``int8_dot_general`` hook: when
    not training, the cast input and weight are quantized on the fly and
    multiplied in int8 (``ops/quant.py``), the result cast to ``dtype`` and
    the bias added in it; training runs the float product."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 quantize: str = "none"):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.quantize = quantize

    def forward(self, x: torch.Tensor, train: bool = False, bias: bool = True) -> torch.Tensor:
        """``bias=False``: the product alone (a row-parallel layer adds its
        bias after the sum over ``model``)."""
        dt = self.compute_dtype
        if self.quantize == "int8" and not train:
            y = int8_linear(x.to(dt), self.weight.to(dt)).to(dt)
            return y + self.bias.to(dt) if bias else y
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt) if bias else None)


def _dense(in_features: int, out_features: int, dtype: torch.dtype, quantize: str) -> nn.Module:
    """An eligible Dense layer (``ssd_tpu/models/conformer.py:_dense_cls``):
    :class:`QuantDense` under ``int8_prequant``, else :class:`Dense` with
    the ``int8`` hook or without."""
    if quantize == "int8_prequant":
        return QuantDense(in_features, out_features, dtype)
    return Dense(in_features, out_features, dtype, quantize)


class Conv1d(nn.Conv1d):
    """flax ``nn.Conv(dtype=dtype)`` on ``(B, C, T)``: input, weight and bias
    cast to ``dtype``, the output in it; the parameters stay fp32."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics and output
    whatever the input's dtype, flax's epsilon."""

    def __init__(self, d: int):
        super().__init__(d, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32))


class Conv1dSubsampler(nn.Module):
    """Temporal ×2ᵏ subsampling with stride-2 convs + ReLU (k=5, p=2)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.metas = cfg.conv_meta()
        convs = {}
        in_dim = cfg.input_dim
        for i, m in enumerate(self.metas):
            convs[f"conv_{i}"] = Conv1d(
                in_dim, cfg.d_model, m["kernel_size"], stride=m["stride"], padding=m["padding"],
                dtype=cfg.dtype,
            )
            in_dim = cfg.d_model
        self.convs = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)  # (B, F, T)
        for m, conv in zip(self.metas, self.convs.values()):
            x = conv(x)
            if m["stride"] > 1:
                x = F.relu(x)
        return x.transpose(1, 2)


def _drop(x: torch.Tensor, rate: float, train: bool, generator,
          region: str = "replicated") -> torch.Tensor:
    return dropout(x, rate, stream(generator, region)) if train else x


# --------------------------------------------------------------------------
# Tensor / sequence parallelism (``parallel/partition.py:shard_model`` sets
# ``par``, the ParallelContext, on the modules that take part)
# --------------------------------------------------------------------------


def _stream_region(par) -> str:
    """Dropout region of the residual stream: sharded when T is."""
    return "sharded" if par is not None and par.sequence else "replicated"


def _enter_tp(x: torch.Tensor, par) -> torch.Tensor:
    """Into a column-parallel layer: the full-T input (gathered when T is
    sharded), its gradient summed over ``model``; ``x`` in one process."""
    if par is None:
        return x
    return col.gather_seq(x, par.model_group) if par.sequence else col.copy_to(x, par.model_group)


def _exit_tp(partial: torch.Tensor, bias: torch.Tensor, par) -> torch.Tensor:
    """Out of a row-parallel layer: the sum over ``model`` (scattered on T
    under sequence parallelism), then the bias, once. In one process
    ``partial`` is the layer's whole output, its bias added already."""
    if par is None:
        return partial
    if par.sequence:
        y = col.scatter_seq(partial, par.model_group)
    else:
        y = col.reduce_from(partial, par.model_group)
    return y + bias.to(y.dtype)


def _local_mask(pad_mask: torch.Tensor, par) -> torch.Tensor:
    """This rank's T-shard of the (padded) mask under sequence parallelism."""
    if par is None or not par.sequence:
        return pad_mask
    ts = pad_mask.shape[1] // par.model
    return pad_mask[:, par.model_rank * ts:(par.model_rank + 1) * ts]


# --------------------------------------------------------------------------
# Rematerialization
# --------------------------------------------------------------------------

_RECOMPUTE = threading.local()  # .active: inside a checkpointed region's recompute

# remat_policy → the aten products a checkpointed block keeps (None: nothing)
_SAVED_PRODUCTS = {
    "full": None,
    "dots": {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default},
    "dots_no_batch": {torch.ops.aten.mm.default, torch.ops.aten.addmm.default},
}


def recomputing() -> bool:
    """Whether a checkpointed region is being recomputed for the backward."""
    return getattr(_RECOMPUTE, "active", False)


def _save_products(ops: frozenset, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, x: torch.Tensor, generator: Optional[torch.Generator],
           policy: str = "full") -> torch.Tensor:
    """``fn(x)`` under ``torch.utils.checkpoint`` (non-reentrant), keeping
    what ``policy`` names (:data:`_SAVED_PRODUCTS`). The explicit dropout
    generator is not among the RNG states ``checkpoint`` preserves, so the
    recompute sets it back to its state before the forward ran ``fn`` (the
    same masks) and then forward again to where the step left it."""
    before = generator.get_state() if generator is not None else None
    calls = [0]

    def run(x):
        calls[0] += 1
        if calls[0] == 1:
            return fn(x)
        after = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(before)
        _RECOMPUTE.active = True
        try:
            return fn(x)
        finally:
            _RECOMPUTE.active = False
            if generator is not None:
                generator.set_state(after)

    ops = _SAVED_PRODUCTS[policy]
    kwargs = {}
    if ops is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, functools.partial(_save_products, ops))
    return checkpoint(run, x, use_reentrant=False, **kwargs)


class _FeedForward(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, quantize: str = "none"):
        super().__init__()
        self.dropout = dropout
        self.par = None
        self.ln = LayerNorm(d_model)
        self.w1 = _dense(d_model, ffn_dim, dtype, quantize)
        self.w2 = _dense(ffn_dim, d_model, dtype, quantize)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        par = self.par
        # under TP w1 is column-parallel (this rank's FFN columns), w2 row-parallel
        h = F.silu(self.w1(_enter_tp(self.ln(x), par), train))
        h = _drop(h, self.dropout, train, generator, "sharded")
        y = _exit_tp(self.w2(h, train, bias=par is None), self.w2.bias, par)
        return _drop(y, self.dropout, train, generator, _stream_region(par))


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose batch statistics ignore padded frames
    (``ssd_tpu/models/conformer.py:MaskedBatchNorm``).

    ``train=True``: single-pass masked E[x²] − E[x]² in fp32, clamped at 0 —
    the biased variance, not ``nn.BatchNorm1d``'s unbiased one, and over
    valid frames only. Gradients flow through the batch mean and variance,
    as JAX autodiff's do. The running statistics move with flax's momentum
    convention, ``ra = 0.9·ra + 0.1·batch``, under ``no_grad``.
    ``train=False`` normalizes with the running statistics. Either way
    ``inv = rsqrt(var + eps)·scale`` and ``x·inv + (bias − mean·inv)``, the
    per-channel affine computed in fp32 and applied in x's dtype. The
    recompute of a checkpointed block (:func:`recomputing`) leaves the
    running statistics as the forward left them.

    Over a mesh (``par``) the masked sums and the count are all-reduced
    with their gradient (``torch.distributed.nn.functional.all_reduce``)
    over ``data``, and over ``model`` too when T is sharded: the statistics
    of the global batch, as the JAX package's are under GSPMD, and the same
    running statistics on every rank.
    """

    def __init__(self, d: int, epsilon: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.par = None
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("mean", torch.zeros(d))
        self.register_buffer("var", torch.ones(d))

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False
    ) -> torch.Tensor:
        if train:
            m = mask[:, :, None].to(torch.float32)
            xf = x.to(torch.float32)
            if self.par is None:
                cnt = torch.clamp(m.sum(), min=1.0)
                mean = (xf * m).sum(dim=(0, 1)) / cnt
                ex2 = (xf.square() * m).sum(dim=(0, 1)) / cnt
            else:
                mean, ex2, cnt = self._global_moments(xf, m)
            var = torch.clamp(ex2 - mean.square(), min=0.0)
            if not recomputing():
                with torch.no_grad():
                    mo = self.momentum
                    self.mean.copy_(mo * self.mean + (1 - mo) * mean)
                    self.var.copy_(mo * self.var + (1 - mo) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.weight
        return x * inv.to(x.dtype) + (self.bias - mean * inv).to(x.dtype)

    def _global_moments(self, xf: torch.Tensor, m: torch.Tensor):
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        c = xf.shape[-1]
        sums = torch.cat([(xf * m).sum(dim=(0, 1)), (xf.square() * m).sum(dim=(0, 1)),
                          m.sum().reshape(1)])
        par = self.par
        if par.sequence:  # the whole mesh: every data row and T-shard
            sums = all_reduce(sums, group=dist.group.WORLD)
        elif par.data > 1:
            sums = all_reduce(sums, group=par.data_group)
        cnt = torch.clamp(sums[2 * c], min=1.0)
        return sums[:c] / cnt, sums[c:2 * c] / cnt, cnt


class _ConvModule(nn.Module):
    def __init__(
        self,
        d_model: int,
        kernel_size: int,
        conv_norm: str,
        dropout: float = 0.0,
        depthwise_impl: str = "lax",
        dtype: torch.dtype = torch.float32,
        quantize: str = "none",
    ):
        super().__init__()
        self.conv_norm = conv_norm
        self.dropout = dropout
        self.depthwise_impl = depthwise_impl
        self.par = None
        self.ln = LayerNorm(d_model)
        self.pw1 = _dense(d_model, 2 * d_model, dtype, quantize)
        self.dw = Conv1d(
            d_model, d_model, kernel_size, padding=(kernel_size - 1) // 2, groups=d_model,
            dtype=dtype,
        )
        if conv_norm == "batch":
            self.bn = MaskedBatchNorm(d_model)
        else:
            self.cn = LayerNorm(d_model)
        self.pw2 = _dense(d_model, d_model, dtype, quantize)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None
    ) -> torch.Tensor:
        par = self.par
        pad_mask = _local_mask(pad_mask, par)
        a, b = self.pw1(self.ln(x), train).chunk(2, dim=-1)
        x = a * torch.sigmoid(b)  # GLU
        # zero padded frames so the depthwise conv sees the same zeros a
        # shorter bucket would — exact padding invariance
        x = x.masked_fill(~pad_mask[:, :, None], 0.0)
        # a T-shard convolves with (K − 1)/2 frames of each neighbour around
        # it and keeps its own frames
        h = (self.dw.kernel_size[0] - 1) // 2 if par is not None and par.sequence else 0
        if h:
            x = col.halo(x, h, par.model_group)
        if self.depthwise_impl == "pallas":
            # the stencil runs channel-last; self.dw only holds weight
            # (C, 1, K) and bias (C,), nn.Conv's names (DepthwiseConv1d's)
            dt = self.dw.compute_dtype
            w = self.dw.weight[:, 0, :].t().contiguous().to(dt)
            x = depthwise_conv1d(x.to(dt), w, self.dw.bias.to(dt))
        else:
            x = self.dw(x.transpose(1, 2)).transpose(1, 2)
        if h:
            x = x[:, h:x.shape[1] - h]
        x = self.bn(x, pad_mask, train) if self.conv_norm == "batch" else self.cn(x)
        return _drop(self.pw2(F.silu(x), train), self.dropout, train, generator,
                     _stream_region(par))


class _MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` semantics: q divided by √hd
    (rounded to the compute dtype) before the dot, masked keys set to the
    compute dtype's ``finfo.min`` (a fully masked row becomes uniform, never
    NaN), the softmax in the compute dtype as ``jax.nn.softmax`` takes it
    (in bf16: the exponentials rounded to bf16, their sum taken in fp32 and
    rounded, the quotient rounded). With ``impl="fused"`` the same
    projections feed ``ops.attention``'s fused attention instead (the Pallas
    kernel's numerics: scale after the dot, masked keys at −1e30, an fp32
    softmax).

    Training dropout on the weights is flax's default ``broadcast_dropout``:
    ONE (T, T) keep-mask shared by every batch row and head, applied to the
    softmax weights before ``·v``.

    Under tensor parallelism (``parallel/partition.py``) the projections
    hold this rank's heads, ``num_heads`` counts them, and ``forward``
    returns ``out``'s partial product without its bias (the caller sums
    over ``model`` and adds it)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, impl: str = "flax",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.impl = impl
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by num_heads={num_heads}")
        self.num_heads = num_heads
        self.query = Dense(d_model, d_model, dtype)
        self.key = Dense(d_model, d_model, dtype)
        self.value = Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None,
        partial: bool = False,
    ) -> torch.Tensor:
        B, T, _ = x.shape
        H = self.num_heads
        q = self.query(x)
        hd = q.shape[-1] // H
        q = q.view(B, T, H, hd).transpose(1, 2)  # (B, H, T, hd)
        k = self.key(x).view(B, T, H, hd).transpose(1, 2)
        v = self.value(x).view(B, T, H, hd).transpose(1, 2)
        mult = None
        if train and self.dropout > 0.0:
            mult = keep_multiplier((T, T), self.dropout, stream(generator, "shared"), v.device,
                                   v.dtype)
        if self.impl == "fused":
            ctx = fused_attention(q, k, v, pad_mask, mult)
        else:
            root = hd ** 0.5
            if q.dtype != torch.float32:  # flax: jnp.sqrt(depth).astype(dtype)
                root = torch.tensor(root, dtype=q.dtype)
            q = q / root
            scores = torch.matmul(q, k.transpose(-1, -2))  # (B, H, T, T)
            big_neg = torch.finfo(scores.dtype).min
            scores = scores.masked_fill(~pad_mask[:, None, None, :], big_neg)
            if scores.dtype == torch.float32:
                w = torch.softmax(scores, dim=-1)
            else:  # jax.nn.softmax op by op, jnp.sum upcasting its reduction
                e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
                w = e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(e.dtype)
            ctx = torch.matmul(w if mult is None else w * mult, v)
        return self.out(ctx.transpose(1, 2).reshape(B, T, H * hd), bias=not partial)


class _SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, impl: str = "flax",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.par = None
        self.ln = LayerNorm(d_model)
        self.mha = _MultiHeadAttention(d_model, num_heads, dropout, impl, dtype)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None
    ) -> torch.Tensor:
        par = self.par
        # under TP full T and this rank's heads; `out` row-parallel
        x = self.mha(_enter_tp(self.ln(x), par), pad_mask, train, generator,
                     partial=par is not None)
        x = _exit_tp(x, self.mha.out.bias, par)
        return _drop(x, self.dropout, train, generator, _stream_region(par))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        p, dt, q = cfg.dropout, cfg.dtype, cfg.quantize
        # attention-only remat, unless the whole block is rematerialized
        self.attn_remat = cfg.attn_remat and not cfg.remat
        self.ffn1 = _FeedForward(cfg.d_model, cfg.ffn_dim, p, dt, q)
        self.attn = _SelfAttention(cfg.d_model, cfg.num_heads, p, cfg.attention_impl, dt)
        self.conv = _ConvModule(
            cfg.d_model, cfg.depthwise_conv_kernel_size, cfg.conv_norm, p, cfg.depthwise_impl, dt,
            q,
        )
        self.ffn2 = _FeedForward(cfg.d_model, cfg.ffn_dim, p, dt, q)
        self.final_ln = LayerNorm(cfg.d_model)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None
    ) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x, train, generator)
        if self.attn_remat and torch.is_grad_enabled():
            x = x + _remat(lambda h: self.attn(h, pad_mask, train, generator), x, generator)
        else:
            x = x + self.attn(x, pad_mask, train, generator)
        x = x + self.conv(x, pad_mask, train, generator)
        x = x + 0.5 * self.ffn2(x, train, generator)
        return self.final_ln(x)


_ATTN_REMAT_WARNED = False


def _warn_attn_remat(cfg: EncoderConfig) -> None:
    """The JAX package's warning, once a process, that ``attn_remat`` does
    nothing under ``remat``."""
    global _ATTN_REMAT_WARNED
    if cfg.remat and cfg.attn_remat and not _ATTN_REMAT_WARNED:
        _ATTN_REMAT_WARNED = True
        logger.warning(
            "attn_remat=True is subsumed by remat=True (the whole block "
            "is rematerialized); the attention-only knob has no effect."
        )


class EMGConformerEncoder(nn.Module):
    """Subsampler + Conformer stack. Returns (hidden, out_lengths)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        _warn_attn_remat(cfg)
        self.cfg = cfg
        self.par = None
        self.subsample = Conv1dSubsampler(cfg)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor | None = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        x = self.subsample(x)
        t_out = x.shape[1]
        if lengths is None:
            lengths = torch.full((x.shape[0],), t_out * c.subsample_factor, device=x.device)
        out_lengths = torch.clamp(subsampled_lengths(lengths, c), 0, t_out)
        pad_mask = _length_mask(out_lengths, t_out)
        if c.scan_layers:  # the JAX package's scan carry: fp32 into block_0
            x = x.to(torch.float32)
        par = self.par
        if par is not None and par.sequence:
            # T-shards over `model`: T′ padded to a multiple of the degree
            # (as GSPMD pads it), the padding masked like any padded frame
            t_pad = -(-t_out // par.model) * par.model
            x = col.split_seq(F.pad(x, (0, 0, 0, t_pad - t_out)), par.model_group)
            pad_mask = _length_mask(out_lengths, t_pad)
        if c.pipeline_microbatches > 0:  # fp32 carry; GPipe over `model` stages
            x = pipelined_stack(c, self.blocks, x, pad_mask, train, generator, par)
        else:
            x = self._unrolled(x, pad_mask, train, generator)
        if par is not None and par.sequence:  # whole rows again for the heads
            x = col.gather_rows(x, par.model_group)[:, :t_out]
            pad_mask = pad_mask[:, :t_out]
        # zero padded frames: downstream decoders consume masked positions
        x = x.masked_fill(~pad_mask[:, :, None], 0.0)
        return x.float(), out_lengths

    def _unrolled(self, x, pad_mask, train, generator):
        c = self.cfg
        for block in self.blocks:
            if c.remat and torch.is_grad_enabled():
                x = _remat(functools.partial(block, pad_mask=pad_mask, train=train,
                                             generator=generator), x, generator, c.remat_policy)
            else:
                x = block(x, pad_mask, train, generator)
        return x


def init_flax_style(model: nn.Module, generator: torch.Generator) -> None:
    """flax initializers in place: lecun-normal (truncated) kernels, zero
    biases, unit LayerNorm / BatchNorm scales, BN running stats (0, 1).

    A fresh torch module uses kaiming-uniform; matching flax's init keeps a
    randomly initialized port statistically like a fresh JAX model.
    """
    # lecun_normal = variance_scaling(1, fan_in, truncated_normal): the
    # truncation at ±2σ shrinks the std by 0.8796, which flax compensates
    stddev_fix = 0.87962566103423978
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                w = mod.weight
                fan_in = w[0].numel()  # in_features, or in/groups × K
                std = (1.0 / fan_in) ** 0.5 / stddev_fix
                t = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
                w.copy_(t * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, MaskedBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
