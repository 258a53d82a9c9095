"""Dynamic int8 (W8A8) Dense products for quantized serving (PyTorch port
of ``ssd_tpu/ops/quant.py``).

The scheme is the JAX package's, step for step, so that the same inputs give
the same int8 values, scales and int32 sums:

* activations: symmetric per-token scales, the amax over the contracting
  (last) dimension, computed on every call;
* weights: symmetric per-output-channel scales, the amax over the input
  dimension — dim 1 of the port's ``(out, in)`` weight;
* ``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x / scale), ±127)``
  with round half to even, everything in fp32 and every quotient a true
  division, on the card as on the CPU;
* the int8 × int8 product summed in int32, then rescaled as
  ``(acc · x_scale) · w_scale`` in fp32, cast to the output dtype, and the
  bias added in that dtype.

:func:`int8_matmul` is the product. On a CUDA tensor it is
``torch._int_mm`` (cuBLASLt's int8 GEMM, the counterpart of the JAX
package's ``lax.dot_general`` with ``preferred_element_type=int32``, an XLA
product outside any Pallas kernel); on a CPU tensor its plain version, an
exact float64 product (``|sum| ≤ 127² · K < 2³¹ < 2⁵³``), which equals it
bit for bit. ``_int_mm`` takes more than 16 rows and K and N multiples of
8: fewer rows are padded with zero rows, which quantize to 0, and sliced off.

``quantize: int8`` quantizes the eligible Dense layers (:data:`QUANT_ELIGIBLE`)
on every inference call and trains float; ``int8_prequant`` holds each
eligible weight as int8 with its per-channel scale (:class:`QuantDense`,
:func:`prequantize_state_dict`), converted once at load, and refuses to
train.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_QMAX = 127.0
_EPS = 1e-8
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows

# Dense layers the int8 path covers (the conformer FFN and the conv
# module's pointwise products), as in the JAX package
QUANT_ELIGIBLE = ("w1", "w2", "pw1", "pw2")

INFERENCE_ONLY = (
    "quantize=int8_prequant is inference-only (the param tree holds int8 "
    "kernels); train with quantize: none"
)


class _Launches:
    """How often :func:`int8_matmul` ran ``torch._int_mm`` on the card."""

    def __init__(self) -> None:
        self.launches = 0


INT_MM = _Launches()


def quantize_per_axis(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``dim``: ``(q int8, scale fp32)``,
    the scale keeping ``dim`` as size 1."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=dim, keepdim=True)
    # a tensor divisor: PyTorch on CUDA multiplies by the reciprocal of a
    # Python-number divisor, which rounds some scales one ulp off the true
    # quotient that JAX and the CPU compute
    scale = torch.clamp(amax, min=_EPS) / torch.full_like(amax, _QMAX)
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b (N, K)ᵀ int8 → (M, N) int32``, exactly, in float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64).t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b (N, K)ᵀ int8 → (M, N) int32``: ``torch._int_mm``
    on a CUDA tensor, :func:`int8_matmul_plain` on a CPU one."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if not a.is_cuda:
        return int8_matmul_plain(a, b)
    M, K = a.shape
    if K % 8 or b.shape[0] % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got K={K}, N={b.shape[0]}")
    if M < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - M))
    out = torch._int_mm(a.contiguous(), b.t())
    INT_MM.launches += 1
    return out[:M]


def int8_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """W8A8 ``x @ weightᵀ`` (the port's ``F.linear`` without bias): both
    operands quantized on the fly, fp32 result (``int8_dot_general``).
    ``x`` is ``(..., in)``, ``weight`` ``(out, in)``."""
    w_q, w_s = quantize_per_axis(weight, dim=1)  # (out, in), (out, 1)
    return int8_prequant_linear(x, w_q, w_s[:, 0])


def prequantize_weight(weight: torch.Tensor, compute_dtype: torch.dtype | None = None):
    """Float ``(out, in)`` weight → ``(int8 q, fp32 scale (out,))``, after the
    compute-dtype cast the Dense layer would apply (``prequantize_kernel``)."""
    if compute_dtype is not None:
        weight = weight.to(compute_dtype)
    q, scale = quantize_per_axis(weight, dim=1)
    return q, scale[:, 0].to(torch.float32)


def int8_prequant_linear(x: torch.Tensor, q_weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q_weight)ᵀ``: per-token int8 activations against an
    int8 ``(out, in)`` weight and its ``(out,)`` scale; fp32 result
    (``int8_prequant_dot``)."""
    lead, K = x.shape[:-1], x.shape[-1]
    x_q, x_s = quantize_per_axis(x.reshape(-1, K), dim=-1)  # (M, K), (M, 1)
    acc = int8_matmul(x_q, q_weight)
    out = acc.to(torch.float32) * x_s * scale[None, :]  # (acc · x_scale) · w_scale, JAX's order
    return out.reshape(*lead, q_weight.shape[0])


class QuantDense(nn.Module):
    """The ``int8_prequant`` Dense layer: an int8 ``weight`` ``(out, in)``
    and an fp32 per-output-channel ``scale`` (buffers: nothing to train, and
    a captured graph holds them as constants), and the fp32 ``bias``. The
    input is cast to the compute dtype, the product rescaled in fp32, cast
    to the compute dtype, and the bias added in it."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("weight", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones((out_features,), dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, train: bool = False, bias: bool = True) -> torch.Tensor:
        """``bias=False``: the product alone, as ``Dense`` takes it."""
        if train:
            raise ValueError(INFERENCE_ONLY)
        dt = self.compute_dtype
        y = int8_prequant_linear(x.to(dt), self.weight, self.scale).to(dt)
        return y + self.bias.to(dt) if bias else y


_ELIGIBLE_WEIGHT = re.compile(r"(^|\.)(%s)\.weight$" % "|".join(QUANT_ELIGIBLE))


def prequantize_state_dict(
    state: Mapping[str, torch.Tensor], compute_dtype: torch.dtype | None = None
) -> Dict[str, torch.Tensor]:
    """Every eligible float Dense ``weight`` of a state dict → int8, with a
    ``scale`` beside it (``prequantize_tree``); a weight that is int8
    already is kept with its scale, everything else passes unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if _ELIGIBLE_WEIGHT.search(key) and value.dim() == 2 and value.dtype != torch.int8:
            q, scale = prequantize_weight(value, compute_dtype)
            out[key] = q
            out[key[: -len("weight")] + "scale"] = scale
        else:
            out[key] = value
    return out


def maybe_prequantize(state: Mapping[str, torch.Tensor], encoder_cfg) -> Mapping[str, torch.Tensor]:
    """The load-time conversion keyed on the model config: the prequantized
    state dict when ``quantize == "int8_prequant"`` (after the compute-dtype
    cast, so outputs match the dynamic int8 path), the state unchanged
    otherwise. ``encoder_cfg`` is an ``EncoderConfig`` or the config dict."""
    if isinstance(encoder_cfg, Mapping):
        quantize = encoder_cfg.get("quantize", "none")
        dtype = (torch.bfloat16 if encoder_cfg.get("compute_dtype", "float32") == "bfloat16"
                 else torch.float32)
    else:
        quantize, dtype = encoder_cfg.quantize, encoder_cfg.dtype
    if quantize != "int8_prequant":
        return state
    return prequantize_state_dict(state, dtype)
