"""Plain PyTorch reference of the EMG Conformer student: subsampler, Conformer
blocks, projection and CTC heads, written from the model's description and
independent of the measured package (it imports nothing of it).

Parameters live in a flat ``{name: tensor}`` dict whose names and shapes are
the measured model's ``state_dict`` keys (:func:`param_layout`), so one set
of seeded weights loads into both. Arithmetic follows the configuration's
stated precision: every Dense and convolution casts its input, weight and
bias to ``compute_dtype`` (the parameters stay fp32), LayerNorm and the
softmax run in fp32, dropout's keep multiplier is built in the dtype of the
tensor it drops. Where the measured program fuses a step (attention, the
depthwise stencil), this file takes the plain route in fp32 on the values
cast to the compute dtype, and rounds the result back to it.

``quant`` replaces each Dense and convolution's cast inputs by a lower
precision copy (the correctness control: :mod:`benchmark.reference.lowp`).
Dropout and on-device SpecAugment draw from the caller's ``torch.Generator``
in the order the model description fixes (per block: the first FFN's hidden
then output, attention's one (T, T) multiplier then its output, the conv
module's output, the second FFN's hidden then output; then the projection
head, then the CTC head), so a generator seeded alike draws the same masks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def encoder_dims(cfg: dict) -> dict:
    enc = cfg["model"]["encoder"]
    return dict(
        d=int(enc["d_model"]), layers=int(enc["num_layers"]), heads=int(enc["num_heads"]),
        ffn=int(enc["ffn_dim"]), k=int(enc["depthwise_conv_kernel_size"]),
        dropout=float(enc.get("dropout", 0.1)), sub=int(enc.get("subsample_factor", 4)),
        input_dim=int(enc["input_dim"]), proj=int(cfg["model"]["projection_dim"]),
        ctc_dropout=float(cfg["model"].get("ctc_dropout", 0.1)),
        dtype=torch.bfloat16 if enc.get("compute_dtype", "float32") == "bfloat16" else torch.float32,
        scan=bool(enc.get("scan_layers", False)),
    )


def param_layout(cfg: dict, vocab_size: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter and buffer, in the model's order."""
    m = encoder_dims(cfg)
    d, ffn, k = m["d"], m["ffn"], m["k"]
    out: List[Tuple[str, Tuple[int, ...]]] = []
    in_dim = m["input_dim"]
    for i in range(_n_subsample_convs(m["sub"])):
        kk = 5 if m["sub"] > 1 else 1
        out += [(f"encoder.subsample.convs.conv_{i}.weight", (d, in_dim, kk)),
                (f"encoder.subsample.convs.conv_{i}.bias", (d,))]
        in_dim = d

    def dense(name, n_in, n_out):
        return [(f"{name}.weight", (n_out, n_in)), (f"{name}.bias", (n_out,))]

    def norm(name):
        return [(f"{name}.weight", (d,)), (f"{name}.bias", (d,))]

    for b in range(m["layers"]):
        p = f"encoder.blocks.{b}"
        out += norm(f"{p}.ffn1.ln") + dense(f"{p}.ffn1.w1", d, ffn) + dense(f"{p}.ffn1.w2", ffn, d)
        out += norm(f"{p}.attn.ln")
        for q in ("query", "key", "value", "out"):
            out += dense(f"{p}.attn.mha.{q}", d, d)
        out += norm(f"{p}.conv.ln") + dense(f"{p}.conv.pw1", d, 2 * d)
        out += [(f"{p}.conv.dw.weight", (d, 1, k)), (f"{p}.conv.dw.bias", (d,))]
        out += norm(f"{p}.conv.bn") + [(f"{p}.conv.bn.mean", (d,)), (f"{p}.conv.bn.var", (d,))]
        out += dense(f"{p}.conv.pw2", d, d)
        out += norm(f"{p}.ffn2.ln") + dense(f"{p}.ffn2.w1", d, ffn) + dense(f"{p}.ffn2.w2", ffn, d)
        out += norm(f"{p}.final_ln")
    out += dense("projection.proj", d, m["proj"]) + dense("ctc_head.fc", d, vocab_size)
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(".bn.mean") or name.endswith(".bn.var")


def _n_subsample_convs(factor: int) -> int:
    n = 0
    while factor > 1:
        n += 1
        factor //= 2
    return max(n, 1)


def subsampled_lengths(lengths: torch.Tensor, factor: int) -> torch.Tensor:
    out = lengths.to(torch.int64)
    if factor <= 1:
        return out
    for _ in range(_n_subsample_convs(factor)):
        out = torch.div(out + 2 * 2 - 5, 2, rounding_mode="floor") + 1
    return out


class Context:
    """What a forward needs besides parameters and inputs."""

    def __init__(self, cfg: dict, train: bool, generator: Optional[torch.Generator] = None,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.m = encoder_dims(cfg)
        self.train = train
        self.generator = generator
        self.quant = quant

    # ------------------------------------------------------------ pieces
    def cast(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.m["dtype"])
        return self.quant(t) if self.quant is not None else t

    def dense(self, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        dt = self.m["dtype"]
        return F.linear(self.cast(x), self.cast(p[f"{name}.weight"]), p[f"{name}.bias"].to(dt))

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if not self.train or rate == 0.0:
            return x
        return x * self.keep(tuple(x.shape), rate, x.device, x.dtype)

    def keep(self, shape, rate: float, device, dtype) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=device)
        return (u >= rate).to(dtype) / (1.0 - rate)

    @staticmethod
    def ln(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        w = p[f"{name}.weight"]
        return F.layer_norm(x.float(), (w.shape[0],), w, p[f"{name}.bias"], LN_EPS)


def _ffn(c: Context, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(c.dense(p, f"{name}.w1", c.ln(p, f"{name}.ln", x)))
    h = c.drop(h, c.m["dropout"])
    return c.drop(c.dense(p, f"{name}.w2", h), c.m["dropout"])


def _attention(c: Context, p: Params, name: str, x: torch.Tensor, mask: torch.Tensor):
    B, T, d = x.shape
    H = c.m["heads"]
    hd = d // H
    h = c.ln(p, f"{name}.ln", x)

    def heads(q):
        return c.dense(p, f"{name}.mha.{q}", h).view(B, T, H, hd).transpose(1, 2)

    q, k, v = heads("query"), heads("key"), heads("value")
    mult = None
    if c.train and c.m["dropout"] > 0:
        mult = c.keep((T, T), c.m["dropout"], x.device, v.dtype)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    w = torch.softmax(scores, dim=-1)
    if mult is not None:
        w = w * mult.float()
    ctx = torch.matmul(w, v.float()).to(v.dtype)
    out = c.dense(p, f"{name}.mha.out", ctx.transpose(1, 2).reshape(B, T, d))
    return c.drop(out, c.m["dropout"])


def _batch_norm(c: Context, p: Params, name: str, x: torch.Tensor, mask: torch.Tensor):
    if c.train:
        m = mask[:, :, None].float()
        xf = x.float()
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(dim=(0, 1)) / cnt
        var = torch.clamp((xf.square() * m).sum(dim=(0, 1)) / cnt - mean.square(), min=0.0)
        with torch.no_grad():
            p[f"{name}.mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            p[f"{name}.var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    else:
        mean, var = p[f"{name}.mean"], p[f"{name}.var"]
    inv = torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"]
    return x * inv.to(x.dtype) + (p[f"{name}.bias"] - mean * inv).to(x.dtype)


def _conv_module(c: Context, p: Params, name: str, x: torch.Tensor, mask: torch.Tensor):
    dt = c.m["dtype"]
    a, b = c.dense(p, f"{name}.pw1", c.ln(p, f"{name}.ln", x)).chunk(2, dim=-1)
    h = (a * torch.sigmoid(b)).masked_fill(~mask[:, :, None], 0.0)
    w = p[f"{name}.dw.weight"]
    y = F.conv1d(h.to(dt).float().transpose(1, 2), w.to(dt).float(),
                 p[f"{name}.dw.bias"].to(dt).float(), padding=(w.shape[-1] - 1) // 2,
                 groups=w.shape[0]).transpose(1, 2).to(dt)
    y = _batch_norm(c, p, f"{name}.bn", y, mask)
    return c.drop(c.dense(p, f"{name}.pw2", F.silu(y)), c.m["dropout"])


def encode(c: Context, p: Params, feats: torch.Tensor, lengths: torch.Tensor):
    """(B, T, F) features and (B,) frame counts → ((B, T', d) fp32, (B,) T' counts)."""
    m = c.m
    dt = m["dtype"]
    x = feats.transpose(1, 2)
    for i in range(_n_subsample_convs(m["sub"])):
        name = f"encoder.subsample.convs.conv_{i}"
        stride, pad = (2, 2) if m["sub"] > 1 else (1, 0)
        x = F.conv1d(c.cast(x), c.cast(p[f"{name}.weight"]), p[f"{name}.bias"].to(dt),
                     stride=stride, padding=pad)
        if stride > 1:
            x = F.relu(x)
    x = x.transpose(1, 2)
    t_out = x.shape[1]
    out_lengths = torch.clamp(subsampled_lengths(lengths, m["sub"]), 0, t_out)
    mask = torch.arange(t_out, device=x.device)[None, :] < out_lengths[:, None]
    if m["scan"]:
        x = x.float()
    for b in range(m["layers"]):
        n = f"encoder.blocks.{b}"
        x = x + 0.5 * _ffn(c, p, f"{n}.ffn1", x)
        x = x + _attention(c, p, f"{n}.attn", x, mask)
        x = x + _conv_module(c, p, f"{n}.conv", x, mask)
        x = x + 0.5 * _ffn(c, p, f"{n}.ffn2", x)
        x = c.ln(p, f"{n}.final_ln", x)
    return x.masked_fill(~mask[:, :, None], 0.0).float(), out_lengths


def heads(c: Context, p: Params, enc: torch.Tensor):
    """(log-probs (B, T', V) fp32, student representation (B, T', P) fp32);
    the projection head draws its dropout before the CTC head."""
    student = c.dense(p, "projection.proj", c.drop(enc, c.m["dropout"])).float()
    logits = c.dense(p, "ctc_head.fc", c.drop(enc, c.m["ctc_dropout"])).float()
    return F.log_softmax(logits, dim=-1), student


def log_probs(cfg: dict, p: Params, feats: torch.Tensor, lengths: torch.Tensor,
              quant=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving forward: eval mode, no dropout."""
    c = Context(cfg, train=False, quant=quant)
    enc, out_lengths = encode(c, p, feats, lengths)
    return heads(c, p, enc)[0], out_lengths
