"""Weight bridge: the JAX package's flax trees → the port's ``state_dict``.

``state_dict_from_flax(params, batch_stats, encoder_cfg)`` takes the
``params`` and ``batch_stats`` collections as nested dicts of numpy arrays
(what an orbax restore or ``jax.device_get`` yields) and returns the
tensors ``SSDModel.load_state_dict`` expects:

* Dense ``(in, out)`` → Linear ``(out, in)``;
* ``nn.Conv`` ``(K, in, out)`` → Conv1d ``(out, in, K)``;
* depthwise ``(K, 1, C)`` → grouped Conv1d ``(C, 1, K)``;
* MHA ``query/key/value`` kernels ``(D, H, hd)`` with biases ``(H, hd)`` →
  Linear ``(H·hd, D)``; ``out`` ``(H, hd, D)`` → Linear ``(D, H·hd)``;
* LayerNorm / MaskedBatchNorm ``scale``/``bias`` → ``weight``/``bias``,
  BN ``batch_stats`` ``mean``/``var`` → buffers;
* the ``scan_layers`` stacked ``blocks/block`` layout, unstacked in numpy;
* an ``int8_prequant`` tree's int8 ``kernel`` ``(in, out)`` and ``scale``
  ``(out,)`` → an int8 ``weight`` ``(out, in)`` and the ``scale``
  (``ops/quant.py``'s ``QuantDense``).

Pure numpy + torch: nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ssd_tpu_torch.models.conformer import EncoderConfig


def _unstack(tree: Mapping[str, Any], num_layers: int) -> Dict[str, Any]:
    """``blocks/block`` with a leading (L,) axis → ``block_0 … block_{L-1}``."""
    if "blocks" not in tree:
        return dict(tree)

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    out = {k: v for k, v in tree.items() if k != "blocks"}
    for i in range(num_layers):
        out[f"block_{i}"] = take(tree["blocks"]["block"], i)
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"])
    if kernel.dtype == np.int8:  # an int8_prequant leaf: int8 kernel + scale
        return {"weight": torch.from_numpy(np.ascontiguousarray(kernel.T)),
                "scale": _t(p["scale"]), "bias": _t(p["bias"])}
    return {"weight": _t(kernel.T), "bias": _t(p["bias"])}


def _conv(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    # (K, in, out) → (out, in, K); depthwise (K, 1, C) → (C, 1, K) alike
    return {"weight": _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0))), "bias": _t(p["bias"])}


def _norm(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _mha(p: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"])  # (D, H, hd)
        out[name] = {
            "weight": _t(k.reshape(k.shape[0], -1).T),
            "bias": _t(np.asarray(p[name]["bias"]).reshape(-1)),
        }
    k = np.asarray(p["out"]["kernel"])  # (H, hd, D)
    out["out"] = {"weight": _t(k.reshape(-1, k.shape[-1]).T), "bias": _t(p["out"]["bias"])}
    return out


def _flatten(prefix: str, node, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(node, torch.Tensor):
        out[prefix] = node
        return
    for k, v in node.items():
        _flatten(f"{prefix}.{k}" if prefix else k, v, out)


def state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any], encoder_cfg: EncoderConfig
) -> Dict[str, torch.Tensor]:
    """flax ``SSDModel`` params + batch_stats → the port's ``state_dict``."""
    enc_p = _unstack(params["encoder"], encoder_cfg.num_layers)
    enc_s = _unstack((batch_stats or {}).get("encoder", {}), encoder_cfg.num_layers)

    tree: Dict[str, Any] = {
        "encoder": {
            "subsample": {
                "convs": {name: _conv(p) for name, p in enc_p["subsample"].items()}
            },
            "blocks": {},
        },
        "projection": {"proj": _dense(params["projection"]["proj"])},
        "ctc_head": {"fc": _dense(params["ctc_head"]["fc"])},
    }
    for i in range(encoder_cfg.num_layers):
        bp = enc_p[f"block_{i}"]
        conv = {
            "ln": _norm(bp["conv"]["ln"]),
            "pw1": _dense(bp["conv"]["pw1"]),
            "dw": _conv(bp["conv"]["dw"]),
            "pw2": _dense(bp["conv"]["pw2"]),
        }
        if encoder_cfg.conv_norm == "batch":
            stats = enc_s[f"block_{i}"]["conv"]["bn"]
            conv["bn"] = {**_norm(bp["conv"]["bn"]), "mean": _t(stats["mean"]), "var": _t(stats["var"])}
        else:
            conv["cn"] = _norm(bp["conv"]["cn"])
        tree["encoder"]["blocks"][str(i)] = {
            "ffn1": {k: (_norm if k == "ln" else _dense)(bp["ffn1"][k]) for k in ("ln", "w1", "w2")},
            "attn": {"ln": _norm(bp["attn"]["ln"]), "mha": _mha(bp["attn"]["mha"])},
            "conv": conv,
            "ffn2": {k: (_norm if k == "ln" else _dense)(bp["ffn2"][k]) for k in ("ln", "w1", "w2")},
            "final_ln": _norm(bp["final_ln"]),
        }
    out: Dict[str, torch.Tensor] = {}
    _flatten("", tree, out)
    return out
