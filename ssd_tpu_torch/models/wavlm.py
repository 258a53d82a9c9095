"""WavLM, the frozen distillation teacher (PyTorch port of
``ssd_tpu/models/wavlm.py``).

The inference graph of ``microsoft/wavlm-base-plus`` (the teacher is frozen
and in eval mode; no dropout, layer drop or masking):

* a 7-layer strided conv feature encoder, a per-channel norm over time on
  layer 0, exact (erf) GELU;
* the feature projection (LayerNorm → Linear 512 → 768);
* the grouped positional conv embedding (kernel 128, 16 groups; the
  checkpoint's weight norm folded at load), its last frame trimmed because
  the kernel is even, GELU;
* 12 post-LN transformer layers with WavLM's gated relative position bias:
  log-bucketed relative positions (320 buckets, max distance 800, computed
  in float64 numpy as the JAX package does) embedded per head in layer 0
  and shared down the stack, gated per layer by a sigmoid of each head's
  hidden state.

``hidden_states[i]`` follows HF: index 0 is before layer 0, index L after
layer L−1. Module and parameter names are HF's ``WavLMModel``'s, so an HF
state dict (``wavlm.`` prefix stripped, weight norm folded) loads
directly. The padded-batch path (``n_samples``) masks layer 0's norm
statistics, zeroes the invalid frames ahead of the positional conv and
masks the attention keys, so that each utterance's valid frames match its
unpadded forward. The per-channel norm's variance is ``E[x²] − E[x]²``, as
in the JAX package (not ``nn.GroupNorm``'s two-pass variance).

Weights come from a local ``.safetensors`` file or a directory holding
one, read by the port's own reader (:func:`load_safetensors`); there is no
hub access, and a name with nothing local raises ``FileNotFoundError``.
"""

from __future__ import annotations

import json
import logging
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class WavLMConfig:
    """Defaults = microsoft/wavlm-base-plus."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    do_normalize: bool = True  # waveform zero-mean/unit-var (HF processor)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def relative_position_buckets(
    q_len: int, k_len: int, num_buckets: int, max_distance: int
) -> np.ndarray:
    """(q_len, k_len) int32 bucket ids (WavLM's ``_relative_positions_bucket``),
    in float64 numpy: a float32 log moves buckets at their edges."""
    context = np.arange(q_len)[:, None]
    memory = np.arange(k_len)[None, :]
    rel = memory - context

    half = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * half
    rel_abs = np.abs(rel)

    max_exact = half // 2
    is_small = rel_abs < max_exact
    with np.errstate(divide="ignore"):
        large = np.log(np.maximum(rel_abs, 1) / max_exact) / np.log(max_distance / max_exact)
    large = (max_exact + large * (half - max_exact)).astype(np.int64)
    large = np.minimum(large, half - 1)

    buckets += np.where(is_small, rel_abs, large)
    return buckets.astype(np.int32)


def conv_output_lengths(cfg: WavLMConfig, n_samples):
    """Valid frame counts through the conv pyramid: L → (L − k)//s + 1 per
    layer. Works on ints, numpy arrays and tensors."""
    L = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        L = (L - k) // s + 1
    return L


# --------------------------------------------------------------------------
# Modules (HF names)
# --------------------------------------------------------------------------


class _MaskedChannelNorm(nn.Module):
    """GroupNorm with one group a channel, statistics over time on valid
    frames only (``valid``: (B,) frame counts), variance ``E[x²] − E[x]²``.
    ``nn.GroupNorm``'s parameter names."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x``: (B, C, T)."""
        if valid is None:
            mean = x.mean(dim=-1, keepdim=True)
            mean_sq = (x * x).mean(dim=-1, keepdim=True)
        else:
            mask = torch.arange(x.shape[-1], device=x.device)[None, None, :] < valid[:, None, None]
            n = torch.clamp(valid, min=1).to(x.dtype)[:, None, None]
            xm = torch.where(mask, x, 0.0)
            mean = xm.sum(dim=-1, keepdim=True) / n
            mean_sq = (xm * xm).sum(dim=-1, keepdim=True) / n
        var = mean_sq - mean * mean
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None] + self.bias[:, None]


class _ConvLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, i: int):
        super().__init__()
        in_dim = cfg.conv_dim[i - 1] if i > 0 else 1
        self.conv = nn.Conv1d(in_dim, cfg.conv_dim[i], cfg.conv_kernel[i],
                              stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        if i == 0:
            self.layer_norm = _MaskedChannelNorm(cfg.conv_dim[0])


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_layers = nn.ModuleList(_ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, x: torch.Tensor, n_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) waveform → (B, T, conv_dim[-1])."""
        h = x[:, None, :]
        valid = n_samples
        for i, layer in enumerate(self.conv_layers):
            h = layer.conv(h)
            if valid is not None:
                valid = (valid - self.cfg.conv_kernel[i]).div(
                    self.cfg.conv_stride[i], rounding_mode="floor") + 1
            if i == 0:
                h = layer.layer_norm(h, valid)
            h = F.gelu(h)
        return h.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class _PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.trim = k % 2 == 0
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x.transpose(1, 2))
        if self.trim:  # the even kernel's same-pad trim
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)


class _GatedRelPosAttention(nn.Module):
    """Self-attention with WavLM's gated relative position bias (eval mode)."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.num_heads, self.head_dim = H, cfg.head_dim
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.gru_rel_pos_linear = nn.Linear(cfg.head_dim, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, D = x.shape
        H, hd = self.num_heads, self.head_dim
        q = self.q_proj(x).view(B, T, H, hd)
        k = self.k_proj(x).view(B, T, H, hd)
        v = self.v_proj(x).view(B, T, H, hd)

        # the gate: sigmoid projections of each head's hidden state
        gated_hidden = x.view(B, T, H, hd).transpose(1, 2)  # (B, H, T, hd)
        proj = self.gru_rel_pos_linear(gated_hidden).view(B, H, T, 2, 4).sum(-1)
        gate = torch.sigmoid(proj)
        gate_a, gate_b = gate[..., 0:1], gate[..., 1:2]  # (B, H, T, 1)
        gate_output = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
        gated_bias = gate_output * position_bias[None]  # (B, H, T, T)

        scores = torch.einsum("bthd,bshd->bhts", q * hd ** -0.5, k) + gated_bias
        if pad_mask is not None:
            scores = torch.where(pad_mask[:, None, None, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, D)
        return self.out_proj(out)


class _FeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    """Post-LN transformer layer (``do_stable_layer_norm=False``)."""

    def __init__(self, cfg: WavLMConfig, i: int):
        super().__init__()
        self.attention = _GatedRelPosAttention(cfg, has_relative_position_bias=i == 0)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, position_bias, pad_mask):
        x = self.layer_norm(x + self.attention(x, position_bias, pad_mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))


class WavLMModel(nn.Module):
    """The WavLM inference graph; :meth:`forward` returns the hidden states
    (HF indexing)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_values: torch.Tensor, n_samples: Optional[torch.Tensor] = None,
                last: Optional[int] = None) -> List[torch.Tensor]:
        """``hidden_states[0 … last]`` (all of them by default) of a (B, L)
        waveform batch; ``n_samples`` (B,) valid sample counts turn on the
        padded-batch path."""
        c = self.cfg
        last = c.num_hidden_layers if last is None else last
        x = self.feature_projection(self.feature_extractor(input_values, n_samples))
        pad_mask = None
        if n_samples is not None:
            n_frames = conv_output_lengths(c, n_samples)
            pad_mask = torch.arange(x.shape[1], device=x.device)[None, :] < n_frames[:, None]
            # the unpadded forward's same-pad conv sees zeros past the edge
            x = torch.where(pad_mask[:, :, None], x, 0.0)
        x = self.encoder.layer_norm(x + self.encoder.pos_conv_embed(x))

        T = x.shape[1]
        buckets = torch.from_numpy(
            relative_position_buckets(T, T, c.num_buckets, c.max_bucket_distance)
        ).to(device=x.device, dtype=torch.long)
        embed = self.encoder.layers[0].attention.rel_attn_embed.weight
        position_bias = embed[buckets].permute(2, 0, 1)  # (H, T, T)

        hidden_states = [x]
        for layer in self.encoder.layers[:last]:
            x = layer(x, position_bias, pad_mask)
            hidden_states.append(x)
        return hidden_states


# --------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: Path) -> Dict[str, np.ndarray]:
    """Read a ``.safetensors`` file: an 8-byte little-endian header length,
    a JSON header of ``{name: {dtype, shape, data_offsets}}``, then the raw
    little-endian buffers. BF16 tensors come back as float32 (exact)."""
    with Path(path).open("rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(data, dtype="<u2", count=(end - start) // 2, offset=start)
            arr = (bits.astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
            arr = np.frombuffer(data, dtype=dt, count=(end - start) // dt.itemsize, offset=start)
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(shape)
    return out


def save_safetensors(tensors: Mapping[str, np.ndarray], path: Path) -> None:
    """Write ``tensors`` as a ``.safetensors`` file (the layout
    :func:`load_safetensors` reads; the header padded to 8 bytes)."""
    header: Dict[str, dict] = {}
    offset = 0
    arrays = []
    for name, value in tensors.items():
        arr = np.ascontiguousarray(value)
        if arr.dtype.newbyteorder("=") not in _ST_NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {arr.dtype}")
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        header[name] = {"dtype": _ST_NAMES[arr.dtype.newbyteorder("=")], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with Path(path).open("wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for arr in arrays:
            f.write(arr.tobytes())


def _fold_weight_norm(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The positional conv's weight norm (``weight = g · v / ‖v‖`` over dims
    0 and 1) folded into a plain weight, in the checkpoint's float32 as the
    JAX package folds it; either of PyTorch's two layouts."""
    out = dict(state)
    base = "encoder.pos_conv_embed.conv."
    for g_name, v_name in (("weight_g", "weight_v"),
                           ("parametrizations.weight.original0",
                            "parametrizations.weight.original1")):
        if base + g_name in out:
            g, v = np.asarray(out.pop(base + g_name)), np.asarray(out.pop(base + v_name))
            norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
            out[base + "weight"] = g * v / np.maximum(norm, 1e-12)
    return out


def convert_state_dict(state: Mapping[str, np.ndarray], model: WavLMModel) -> Dict[str, torch.Tensor]:
    """An HF ``WavLMModel`` state dict (numpy or tensors; a ``wavlm.`` prefix
    stripped; keys the model does not have ignored) → ``model``'s state
    dict. A missing key raises ``KeyError``."""
    state = {k.removeprefix("wavlm."): (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                        else np.asarray(v)) for k, v in state.items()}
    state = _fold_weight_norm(state)
    out = {}
    for key, ref in model.state_dict().items():
        if key not in state:
            raise KeyError(f"WavLM weights lack {key!r}")
        value = torch.from_numpy(np.array(state[key], dtype=np.float32))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"WavLM weight {key!r} has shape {tuple(value.shape)}, "
                             f"expected {tuple(ref.shape)}")
        out[key] = value
    return out


def _local_safetensors(model_name_or_path: str) -> Path:
    path = Path(model_name_or_path).expanduser()
    if path.is_file() and path.suffix == ".safetensors":
        return path
    if path.is_dir():
        candidates = sorted(path.glob("*.safetensors"))
        if candidates:
            return candidates[0]
    raise FileNotFoundError(
        f"No local WavLM weights at {model_name_or_path!r}: a local .safetensors file, or a "
        "directory holding one, is needed (the port does not download from a model hub)"
    )


# --------------------------------------------------------------------------
# Teacher
# --------------------------------------------------------------------------


class WavLMTeacher:
    """Frozen WavLM feature extractor: waveform → the layer-``layer`` states,
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: WavLMConfig, state_dict: Mapping[str, torch.Tensor], layer: int = 9,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.layer = layer
        self.device = resolve_device(device)
        model = WavLMModel(cfg)
        model.load_state_dict(state_dict)
        for p in model.parameters():
            p.requires_grad_(False)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_pretrained(cls, model_name_or_path: str, layer: int = 9,
                        cfg: Optional[WavLMConfig] = None,
                        device: str | torch.device = "cuda") -> "WavLMTeacher":
        """Load from a local ``.safetensors`` file or a directory holding one."""
        cfg = cfg or WavLMConfig()
        state = load_safetensors(_local_safetensors(model_name_or_path))
        return cls(cfg, convert_state_dict(state, WavLMModel(cfg)), layer=layer, device=device)

    def _normalize(self, waveform: np.ndarray) -> np.ndarray:
        if not self.cfg.do_normalize:
            return waveform
        mean = waveform.mean()
        var = waveform.var()
        return (waveform - mean) / np.sqrt(var + 1e-7)

    @torch.inference_mode()
    def extract(self, waveform: np.ndarray) -> np.ndarray:
        """(samples,) float32 mono at 16 kHz → (frames, hidden) float32."""
        w = self._normalize(np.asarray(waveform, np.float32))
        x = torch.from_numpy(np.ascontiguousarray(w[None])).to(self.device)
        out = self.model(x, last=self.layer)[self.layer]
        return out[0].float().cpu().numpy()

    @torch.inference_mode()
    def extract_batch(self, waveforms: List[np.ndarray],
                      sample_bucket: int = 16000) -> List[np.ndarray]:
        """Batched, padded extraction: each waveform normalized on its own,
        zero-padded to the batch's longest rounded up to ``sample_bucket``
        (1 s at 16 kHz), run through the masked forward; each utterance's
        valid (frames_i, hidden) slice, from one device → host copy of the
        batch's longest valid span."""
        if not waveforms:
            return []
        ws = [self._normalize(np.asarray(w, np.float32)) for w in waveforms]
        n = np.asarray([w.shape[0] for w in ws], np.int64)
        L_pad = max(sample_bucket,
                    ((int(n.max()) + sample_bucket - 1) // sample_bucket) * sample_bucket)
        batch = np.zeros((len(ws), L_pad), np.float32)
        for i, w in enumerate(ws):
            batch[i, : w.shape[0]] = w
        x = torch.from_numpy(batch).to(self.device)
        out = self.model(x, torch.from_numpy(n).to(self.device), last=self.layer)[self.layer]
        frames = conv_output_lengths(self.cfg, n)
        out_np = out[:, : int(frames.max())].float().cpu().numpy()
        return [out_np[i, : int(frames[i])] for i in range(len(ws))]
