"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. A
missing card is an error, never a quiet fall back to the CPU: a server that
silently ran on the host would look healthy and be two orders of magnitude
slower.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` → a checked :class:`torch.device`.

    Raises ``RuntimeError`` when CUDA is asked for and no card is visible.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: expected cuda or cpu")
    return dev
