"""Combined student model: encoder + projection head + CTC head (port of
``ssd_tpu/models/ssd_model.py``).

``build_model`` reads the same config keys with the same defaults and the
same validation as the JAX package. ``attention_impl: fused`` and
``depthwise_impl: pallas`` select the port's fused attention and depthwise
stencil (CUDA kernels on the card), with the same parameters.
``compute_dtype: bfloat16`` runs the encoder and both heads' Dense layers in
bf16 the way the JAX package's flax ``dtype=`` does (parameters fp32,
log-probs and the student representation fp32); ``remat``,
``remat_policy`` and ``attn_remat`` rematerialize blocks in the backward;
``scan_layers`` feeds the blocks an fp32 carry, as the JAX package's scan
does (the weight bridge unstacks a ``scan_layers`` tree); ``quantize:
int8`` / ``int8_prequant`` serve the FFN and pointwise Dense layers in int8
(``ops/quant.py``; an ``int8_prequant`` model loads a state dict that
``prequantize_state_dict`` converted).
``pipeline_microbatches > 0`` is validated as the JAX package validates it
(``parallel/pipeline.py:validate_pipeline_config``) and runs the blocks with
an fp32 carry: GPipe over the ``model`` ranks when the trainer places the
model over pipeline stages, else in order, so a pipelined checkpoint serves,
streams, exports and evaluates in one process. ``sequence_parallel``
shards the blocks' per-position regions on T when the trainer places the
model over a ``model`` axis above 1 (``parallel/partition.py:shard_model``);
on one device it changes nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ssd_tpu_torch.models.conformer import EMGConformerEncoder, EncoderConfig
from ssd_tpu_torch.models.heads import CTCHead, ProjectionHead
from ssd_tpu_torch.parallel.pipeline import validate_pipeline_config


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
        dt = encoder_cfg.dtype
        self.projection = ProjectionHead(
            encoder_cfg.d_model, projection_dim, encoder_cfg.dropout, dt)
        self.ctc_head = CTCHead(encoder_cfg.d_model, vocab_size, ctc_dropout, dt)

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
    validate_pipeline_config(encoder_cfg)
    return SSDModel(
        encoder_cfg=encoder_cfg,
        projection_dim=cfg["model"]["projection_dim"],
        vocab_size=vocab_size,
        ctc_dropout=cfg["model"].get("ctc_dropout", 0.1),
    )
