"""The yardstick's arithmetic: the card's peaks, the model's operations
from its shapes, and the least time of the attention kernels' work.

Operations count 2 per multiply-add of every matrix product and
convolution; elementwise work, normalisation, the log-mel front end and
the losses are left out. A training step counts 3 × the forward (forward,
then the backward's two products a forward product); rematerialisation's
second forward is not counted, so it shows as lost utilisation.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12


def conv_out(t: int, kernel: int = 5, stride: int = 2, pad: int = 2) -> int:
    return (t + 2 * pad - kernel) // stride + 1


def subsampled(frames: int, factor: int) -> int:
    while factor > 1:
        frames = conv_out(frames)
        factor //= 2
    return frames


def forward_flops(dims: Dict, B: int, frames: int, vocab: int, projection: bool) -> int:
    """Operations of one forward at ``B`` rows of ``frames`` input frames
    (padded shapes): subsampler, blocks, CTC head, and the projection head
    when ``projection``."""
    d, ffn, k = dims["d"], dims["ffn"], dims["k"]
    total, t, f_in = 0, frames, dims["input_dim"]
    factor = dims["sub"]
    while factor > 1:
        t = conv_out(t)
        total += 2 * B * t * f_in * 5 * d
        f_in = d
        factor //= 2
    per_block = (
        2 * (2 * 2 * B * t * d * ffn)  # two FFNs, two products each
        + 4 * 2 * B * t * d * d  # q, k, v, out
        + 2 * 2 * B * t * t * d  # q·kᵀ and w·v over all heads
        + 2 * B * t * d * 2 * d + 2 * B * t * d * k + 2 * B * t * d * d  # conv module
    )
    total += dims["layers"] * per_block + 2 * B * t * d * vocab
    if projection:
        total += 2 * B * t * d * dims["proj"]
    return total


def attention_least_s(B: int, H: int, T: int, hd: int, backward: bool, dropout: bool,
                      elem_bytes: int = 2, peak: float = PEAK_FLOPS["bfloat16"]) -> float:
    """Least time of one fused attention call (forward, or forward and
    backward): 4 (forward) and 10 (backward) · B·H·T²·hd operations against
    q, k, v, out read and written once (backward: q, k, v, g in, dq, dk, dv
    out), the int32 key mask and the (T, T) multiplier."""
    n = B * H * T * hd
    extra = 4 * B * T + (elem_bytes * T * T if dropout else 0)
    fwd = max(4 * B * H * T * T * hd / peak, (elem_bytes * 4 * n + extra) / PEAK_BYTES_PER_S)
    if not backward:
        return fwd
    bwd = max(10 * B * H * T * T * hd / peak, (elem_bytes * 7 * n + extra) / PEAK_BYTES_PER_S)
    return fwd + bwd
