"""The correctness control: the reference put in the program's place one
precision below what the configuration states. A bf16 configuration's
control rounds every Dense and convolution input to fp8 (e4m3, one scale a
tensor, as fp8 training recipes scale); an fp32 configuration's runs the
reference's products in TF32."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite e4m3 value


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through e4m3 at a per-tensor scale, in ``t``'s dtype; the
    gradient passes straight through."""
    amax = torch.clamp(t.detach().abs().amax().float(), min=1e-12)
    scale = FP8_MAX / amax
    q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    return t + (q - t).detach()


@contextlib.contextmanager
def tf32():
    """TF32 products in matmuls and cuDNN convolutions, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def control(compute_dtype: str):
    """(quant function or None, context manager) of the control one step
    below ``compute_dtype``."""
    if compute_dtype == "bfloat16":
        return fp8, contextlib.nullcontext()
    return None, tf32()
