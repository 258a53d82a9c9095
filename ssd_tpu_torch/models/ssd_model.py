"""Combined student model: encoder + projection head + CTC head (port of
``ssd_tpu/models/ssd_model.py``).

``build_model`` reads the same config keys with the same defaults and the
same validation as the JAX package. ``attention_impl: fused`` and
``depthwise_impl: pallas`` select the port's fused attention and depthwise
stencil (CUDA kernels on the card), with the same parameters. Values that
select a path the port does not have yet raise ``NotImplementedError``
naming the ROADMAP item that will; memory and parallelism knobs that leave
single-device inference math unchanged (``remat``, ``remat_policy``,
``attn_remat``, ``sequence_parallel``, ``scan_layers``) are accepted and
ignored — the weight bridge unstacks a ``scan_layers`` tree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ssd_tpu_torch.models.conformer import EMGConformerEncoder, EncoderConfig
from ssd_tpu_torch.models.heads import CTCHead, ProjectionHead


class SSDModel(nn.Module):
    def __init__(
        self,
        encoder_cfg: EncoderConfig,
        projection_dim: int,
        vocab_size: int,
        ctc_dropout: float = 0.1,
    ):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.encoder = EMGConformerEncoder(encoder_cfg)
        # the projection head drops with the encoder's rate, the CTC head
        # with model.ctc_dropout (ssd_tpu/models/ssd_model.py:33-44)
        self.projection = ProjectionHead(encoder_cfg.d_model, projection_dim, encoder_cfg.dropout)
        self.ctc_head = CTCHead(encoder_cfg.d_model, vocab_size, ctc_dropout)

    def forward(
        self,
        emg: torch.Tensor,
        lengths: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (log_probs (B,T',V), out_lengths (B,), student_repr (B,T',P)).

        ``train=True`` draws dropout from ``generator`` and updates the
        MaskedBatchNorm running statistics in place."""
        enc, out_lengths = self.encoder(emg, lengths, train, generator)
        student = self.projection(enc, train, generator)
        return self.ctc_head(enc, train, generator), out_lengths, student

    def ctc_log_probs(
        self, emg: torch.Tensor, lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serving forward: (log_probs, out_lengths), without the projection."""
        enc, out_lengths = self.encoder(emg, lengths)
        return self.ctc_head(enc), out_lengths


def _not_ported(key: str, value: Any, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"model.encoder.{key}={value!r} is not ported to ssd_tpu_torch yet "
        f"(ROADMAP.md {item})"
    )


def build_model(cfg: Dict[str, Any], input_dim: int, vocab_size: int) -> SSDModel:
    """Construct from the reference YAML config schema (``train.py:56-83``)."""
    enc = cfg["model"]["encoder"]
    encoder_cfg = EncoderConfig(
        input_dim=input_dim,
        d_model=enc["d_model"],
        num_layers=enc["num_layers"],
        num_heads=enc["num_heads"],
        ffn_dim=enc["ffn_dim"],
        depthwise_conv_kernel_size=enc["depthwise_conv_kernel_size"],
        dropout=enc.get("dropout", 0.1),
        subsample_factor=enc.get("subsample_factor", 4),
        conv_norm=enc.get("conv_norm", "batch"),
        compute_dtype=enc.get("compute_dtype", "float32"),
        remat=enc.get("remat", False),
        remat_policy=enc.get("remat_policy", "full"),
        attn_remat=enc.get("attn_remat", False),
        attention_impl=enc.get("attention_impl", "flax"),
        depthwise_impl=enc.get("depthwise_impl", "lax"),
        quantize=enc.get("quantize", "none"),
        sequence_parallel=enc.get("sequence_parallel", False),
        scan_layers=enc.get("scan_layers", False),
        pipeline_microbatches=int(enc.get("pipeline_microbatches", 0)),
    )
    if encoder_cfg.remat_policy not in ("full", "dots", "dots_no_batch"):
        raise ValueError(
            f"model.encoder.remat_policy must be 'full', 'dots', or "
            f"'dots_no_batch', got {encoder_cfg.remat_policy!r}"
        )
    if encoder_cfg.quantize not in ("none", "int8", "int8_prequant"):
        raise ValueError(
            f"model.encoder.quantize must be 'none', 'int8', or "
            f"'int8_prequant', got {encoder_cfg.quantize!r}"
        )
    if encoder_cfg.quantize != "none":
        raise _not_ported("quantize", encoder_cfg.quantize, "queue 1 item 9")
    if encoder_cfg.compute_dtype == "bfloat16":
        raise _not_ported("compute_dtype", "bfloat16", "queue 1 item 8")
    if encoder_cfg.pipeline_microbatches > 0:
        raise _not_ported(
            "pipeline_microbatches", encoder_cfg.pipeline_microbatches, "queue 1 item 10"
        )
    return SSDModel(
        encoder_cfg=encoder_cfg,
        projection_dim=cfg["model"]["projection_dim"],
        vocab_size=vocab_size,
        ctc_dropout=cfg["model"].get("ctc_dropout", 0.1),
    )
