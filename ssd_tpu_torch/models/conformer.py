"""Conformer EMG encoder (PyTorch port of ``ssd_tpu/models/conformer.py``).

A strided-conv temporal subsampler followed by N Conformer blocks:

* macaron half-residual feed-forward sandwiches (LayerNorm → Linear → SiLU →
  Dropout → Linear → Dropout, scaled by ½),
* multi-head self-attention with a key-padding mask and no positional
  encoding, dropout on the attention weights and on the output,
* conv module: LayerNorm → pointwise 2d → GLU → depthwise(k) → BatchNorm →
  SiLU → pointwise → Dropout,
* per-block final LayerNorm.

The unrolled stack in fp32. As in the JAX package, ``train`` is an argument
of every forward, not module state: ``train=True`` turns on dropout (drawn
from the caller's ``generator``) and ``MaskedBatchNorm``'s batch statistics.
Public functions keep the JAX package's channel-last ``(B, T, F)`` layout;
convolutions transpose inside. LayerNorms use flax's epsilon (1e-6), not
torch's default.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.ops.dropout import dropout, keep_multiplier

_LN_EPS = 1e-6  # flax nn.LayerNorm default


@dataclass(frozen=True)
class EncoderConfig:
    """Mirrors ``ssd_tpu.models.conformer.EncoderConfig`` key for key.

    Only the keys that change inference math on one device are read by the
    port; ``build_model`` rejects values that select a path outside this
    slice and ignores the memory / parallelism knobs.
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
    attention_impl: str = "flax"
    attn_remat: bool = False
    depthwise_impl: str = "lax"
    quantize: str = "none"
    sequence_parallel: bool = False
    scan_layers: bool = False
    pipeline_microbatches: int = 0

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


class Conv1dSubsampler(nn.Module):
    """Temporal ×2ᵏ subsampling with stride-2 convs + ReLU (k=5, p=2)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.metas = cfg.conv_meta()
        convs = {}
        in_dim = cfg.input_dim
        for i, m in enumerate(self.metas):
            convs[f"conv_{i}"] = nn.Conv1d(
                in_dim, cfg.d_model, m["kernel_size"], stride=m["stride"], padding=m["padding"]
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


def _drop(x: torch.Tensor, rate: float, train: bool, generator) -> torch.Tensor:
    return dropout(x, rate, generator) if train else x


class _FeedForward(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.w1 = nn.Linear(d_model, ffn_dim)
        self.w2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        x = _drop(F.silu(self.w1(self.ln(x))), self.dropout, train, generator)
        return _drop(self.w2(x), self.dropout, train, generator)


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose batch statistics ignore padded frames
    (``ssd_tpu/models/conformer.py:MaskedBatchNorm``).

    ``train=True``: single-pass masked E[x²] − E[x]² in fp32, clamped at 0 —
    the biased variance, not ``nn.BatchNorm1d``'s unbiased one, and over
    valid frames only. Gradients flow through the batch mean and variance,
    as JAX autodiff's do. The running statistics move with flax's momentum
    convention, ``ra = 0.9·ra + 0.1·batch``, under ``no_grad``.
    ``train=False`` normalizes with the running statistics. Either way
    ``inv = rsqrt(var + eps)·scale`` and ``x·inv + (bias − mean·inv)``.
    """

    def __init__(self, d: int, epsilon: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
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
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(dim=(0, 1)) / cnt
            ex2 = (xf.square() * m).sum(dim=(0, 1)) / cnt
            var = torch.clamp(ex2 - mean.square(), min=0.0)
            with torch.no_grad():
                mo = self.momentum
                self.mean.copy_(mo * self.mean + (1 - mo) * mean)
                self.var.copy_(mo * self.var + (1 - mo) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.weight
        return x * inv + (self.bias - mean * inv)


class _ConvModule(nn.Module):
    def __init__(self, d_model: int, kernel_size: int, conv_norm: str, dropout: float = 0.0):
        super().__init__()
        self.conv_norm = conv_norm
        self.dropout = dropout
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.dw = nn.Conv1d(
            d_model, d_model, kernel_size, padding=(kernel_size - 1) // 2, groups=d_model
        )
        if conv_norm == "batch":
            self.bn = MaskedBatchNorm(d_model)
        else:
            self.cn = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.pw2 = nn.Linear(d_model, d_model)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None
    ) -> torch.Tensor:
        a, b = self.pw1(self.ln(x)).chunk(2, dim=-1)
        x = a * torch.sigmoid(b)  # GLU
        # zero padded frames so the depthwise conv sees the same zeros a
        # shorter bucket would — exact padding invariance
        x = x.masked_fill(~pad_mask[:, :, None], 0.0)
        x = self.dw(x.transpose(1, 2)).transpose(1, 2)
        x = self.bn(x, pad_mask, train) if self.conv_norm == "batch" else self.cn(x)
        return _drop(self.pw2(F.silu(x)), self.dropout, train, generator)


class _MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` semantics: q scaled by hd^-½
    before the dot, masked keys set to ``finfo(float32).min`` (a fully
    masked row becomes uniform, never NaN), fp32 softmax.

    Training dropout on the weights is flax's default ``broadcast_dropout``:
    ONE (T, T) keep-mask shared by every batch row and head, applied to the
    softmax weights before ``·v``."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by num_heads={num_heads}")
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None
    ) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.query(x).view(B, T, H, hd).transpose(1, 2)  # (B, H, T, hd)
        k = self.key(x).view(B, T, H, hd).transpose(1, 2)
        v = self.value(x).view(B, T, H, hd).transpose(1, 2)
        q = q / (hd ** 0.5)
        scores = torch.matmul(q, k.transpose(-1, -2))  # (B, H, T, T)
        big_neg = torch.finfo(scores.dtype).min
        scores = scores.masked_fill(~pad_mask[:, None, None, :], big_neg)
        w = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        if train and self.dropout > 0.0:
            w = w * keep_multiplier((T, T), self.dropout, generator, w.device, w.dtype)
        ctx = torch.matmul(w, v).transpose(1, 2).reshape(B, T, D)
        return self.out(ctx)


class _SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.mha = _MultiHeadAttention(d_model, num_heads, dropout)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None
    ) -> torch.Tensor:
        x = self.mha(self.ln(x), pad_mask, train, generator)
        return _drop(x, self.dropout, train, generator)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        p = cfg.dropout
        self.ffn1 = _FeedForward(cfg.d_model, cfg.ffn_dim, p)
        self.attn = _SelfAttention(cfg.d_model, cfg.num_heads, p)
        self.conv = _ConvModule(cfg.d_model, cfg.depthwise_conv_kernel_size, cfg.conv_norm, p)
        self.ffn2 = _FeedForward(cfg.d_model, cfg.ffn_dim, p)
        self.final_ln = nn.LayerNorm(cfg.d_model, eps=_LN_EPS)

    def forward(
        self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False, generator=None
    ) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x, train, generator)
        x = x + self.attn(x, pad_mask, train, generator)
        x = x + self.conv(x, pad_mask, train, generator)
        x = x + 0.5 * self.ffn2(x, train, generator)
        return self.final_ln(x)


class EMGConformerEncoder(nn.Module):
    """Subsampler + Conformer stack. Returns (hidden, out_lengths)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
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
        for block in self.blocks:
            x = block(x, pad_mask, train, generator)
        # zero padded frames: downstream decoders consume masked positions
        x = x.masked_fill(~pad_mask[:, :, None], 0.0)
        return x.float(), out_lengths


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
