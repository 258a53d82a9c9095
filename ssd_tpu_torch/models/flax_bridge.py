"""Weight bridge between the JAX package's flax trees and the port's
``state_dict``, in both directions, with the optimizer state.

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

``flax_from_state_dict`` is its inverse, unrolled or ``blocks/block``
stacked as the target config's ``scan_layers`` / ``pipeline_microbatches``
ask (``stacked_layout``). ``optimizer_from_optax`` and
``optax_from_optimizer`` carry the optimizer state across: optax's AdamW
moments (mapped per tensor as the weights are, transposes included) and
counts, and ``MultiSteps``' window, to and from the port's
``Optimizer.state_dict()`` (``training/schedules.py``).

Pure numpy + torch: nothing here imports JAX.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]],
    encoder_cfg: EncoderConfig,
) -> Dict[str, torch.Tensor]:
    """flax ``SSDModel`` params + batch_stats → the port's ``state_dict``.

    ``batch_stats=None`` maps a tree shaped like ``params`` alone (an AdamW
    moment, an accumulated gradient): the parameters, no BN buffers."""
    enc_p = _unstack(params["encoder"], encoder_cfg.num_layers)
    enc_s = None if batch_stats is None else _unstack(batch_stats.get("encoder", {}),
                                                      encoder_cfg.num_layers)

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
            conv["bn"] = _norm(bp["conv"]["bn"])
            if enc_s is not None:
                stats = enc_s[f"block_{i}"]["conv"]["bn"]
                conv["bn"].update(mean=_t(stats["mean"]), var=_t(stats["var"]))
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


# ------------------------------------------------------------ the inverse


def stacked_layout(encoder: Mapping[str, Any]) -> bool:
    """Whether a config's ``model.encoder`` block puts the JAX package's
    blocks in the stacked ``blocks/block`` tree: ``scan_layers`` or
    ``pipeline_microbatches > 0``."""
    return bool(encoder.get("scan_layers", False)) or int(
        encoder.get("pipeline_microbatches", 0) or 0) > 0


def _stack(tree: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """``block_0 … block_{L-1}`` → ``blocks/block`` with a leading (L,) axis."""

    def stack(*nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return np.stack(nodes)

    out = {k: v for k, v in tree.items() if not k.startswith("block_")}
    out["blocks"] = {"block": stack(*(tree[f"block_{i}"] for i in range(num_layers)))}
    return out


def _a(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.numpy().copy() if t.dtype == torch.int8 else t.to(torch.float32).numpy().copy()


def _dense_inv(m: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(_a(m["weight"]).T), "bias": _a(m["bias"])}
    if "scale" in m:  # int8_prequant
        out["scale"] = _a(m["scale"])
    return out


def _conv_inv(m: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    # (out, in, K) → (K, in, out); depthwise (C, 1, K) → (K, 1, C) alike
    return {"kernel": np.ascontiguousarray(np.transpose(_a(m["weight"]), (2, 1, 0))),
            "bias": _a(m["bias"])}


def _norm_inv(m: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {"scale": _a(m["weight"]), "bias": _a(m["bias"])}


def _mha_inv(m: Mapping[str, Any], num_heads: int) -> Dict[str, Dict[str, np.ndarray]]:
    out = {}
    for name in ("query", "key", "value"):
        w = _a(m[name]["weight"])  # (H·hd, D)
        out[name] = {"kernel": np.ascontiguousarray(w.T.reshape(w.shape[1], num_heads, -1)),
                     "bias": _a(m[name]["bias"]).reshape(num_heads, -1)}
    w = _a(m["out"]["weight"])  # (D, H·hd)
    out["out"] = {"kernel": np.ascontiguousarray(w.T.reshape(num_heads, -1, w.shape[0])),
                  "bias": _a(m["out"]["bias"])}
    return out


def _nest(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def flax_from_state_dict(
    state_dict: Mapping[str, torch.Tensor], encoder_cfg: EncoderConfig, stacked: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's ``state_dict`` → flax ``params`` and ``batch_stats`` trees
    of numpy arrays, the inverse of :func:`state_dict_from_flax`; ``stacked``
    gives the ``blocks/block`` layout. A dict of the parameters alone (an
    AdamW moment) gives empty ``batch_stats``."""
    sd = _nest(state_dict)
    enc = sd["encoder"]
    enc_p: Dict[str, Any] = {
        "subsample": {name: _conv_inv(m) for name, m in enc["subsample"]["convs"].items()}}
    enc_s: Dict[str, Any] = {}
    for i in range(encoder_cfg.num_layers):
        b = enc["blocks"][str(i)]
        conv = {"ln": _norm_inv(b["conv"]["ln"]), "pw1": _dense_inv(b["conv"]["pw1"]),
                "dw": _conv_inv(b["conv"]["dw"]), "pw2": _dense_inv(b["conv"]["pw2"])}
        if encoder_cfg.conv_norm == "batch":
            bn = b["conv"]["bn"]
            conv["bn"] = _norm_inv(bn)
            if "mean" in bn:
                enc_s[f"block_{i}"] = {"conv": {"bn": {"mean": _a(bn["mean"]),
                                                       "var": _a(bn["var"])}}}
        else:
            conv["cn"] = _norm_inv(b["conv"]["cn"])
        enc_p[f"block_{i}"] = {
            "ffn1": {k: (_norm_inv if k == "ln" else _dense_inv)(b["ffn1"][k])
                     for k in ("ln", "w1", "w2")},
            "attn": {"ln": _norm_inv(b["attn"]["ln"]),
                     "mha": _mha_inv(b["attn"]["mha"], encoder_cfg.num_heads)},
            "conv": conv,
            "ffn2": {k: (_norm_inv if k == "ln" else _dense_inv)(b["ffn2"][k])
                     for k in ("ln", "w1", "w2")},
            "final_ln": _norm_inv(b["final_ln"]),
        }
    if stacked:
        enc_p = _stack(enc_p, encoder_cfg.num_layers)
        enc_s = _stack(enc_s, encoder_cfg.num_layers) if enc_s else {}
    params = {"encoder": enc_p, "projection": {"proj": _dense_inv(sd["projection"]["proj"])},
              "ctc_head": {"fc": _dense_inv(sd["ctc_head"]["fc"])}}
    return params, ({"encoder": enc_s} if enc_s else {})


# ------------------------------------------------------- optimizer state


def _optax_parts(opt_state: Any) -> Dict[str, Mapping[str, Any]]:
    """The nodes of an optax ``[MultiSteps(]chain([clip,] adamw)[)]`` state
    as an orbax restore gives them (dicts and lists): ``adam`` (count, mu,
    nu) and, under gradient accumulation, ``multi`` (mini_step,
    gradient_step, acc_grads)."""
    parts: Dict[str, Mapping[str, Any]] = {}

    def walk(node):
        if isinstance(node, Mapping):
            if "mini_step" in node:
                parts["multi"] = node
                walk(node["inner_opt_state"])
            elif {"mu", "nu"} <= set(node):
                parts["adam"] = node
        elif isinstance(node, (list, tuple)):
            for child in node:
                walk(child)

    walk(opt_state)
    if "adam" not in parts:
        raise ValueError("no AdamW state (count, mu, nu) in the optimizer state")
    return parts


def optimizer_from_optax(
    opt_state: Any, template: Mapping[str, Any], names: Sequence[str],
    encoder_cfg: EncoderConfig,
) -> Dict[str, Any]:
    """An optax state of the JAX package's optimizer → the port's
    ``Optimizer.state_dict()``. ``template`` is the state dict of a port
    ``Optimizer`` over the same parameters (its param groups are kept);
    ``names`` are the parameters' names in its order
    (``model.named_parameters()``).

    Adam's ``mu`` / ``nu`` / ``count`` → ``exp_avg`` / ``exp_avg_sq`` /
    ``step``; ``MultiSteps``' ``mini_step`` / ``gradient_step`` /
    ``acc_grads`` → ``mini_step`` / ``update_count`` / ``acc``. Without
    ``MultiSteps`` (``grad_accum`` 1) no window is open and the update count
    is Adam's."""
    parts = _optax_parts(opt_state)
    adam = parts["adam"]
    mu = state_dict_from_flax(adam["mu"], None, encoder_cfg)
    nu = state_dict_from_flax(adam["nu"], None, encoder_cfg)
    count = int(np.asarray(adam["count"]))
    adamw = {
        "state": {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                      "exp_avg": mu[n], "exp_avg_sq": nu[n]} for i, n in enumerate(names)},
        "param_groups": copy.deepcopy(template["adamw"]["param_groups"]),
    }
    multi = parts.get("multi")
    if multi is None:
        return {"adamw": adamw, "update_count": count, "mini_step": 0, "acc": None}
    acc = state_dict_from_flax(multi["acc_grads"], None, encoder_cfg)
    return {"adamw": adamw, "update_count": int(np.asarray(multi["gradient_step"])),
            "mini_step": int(np.asarray(multi["mini_step"])), "acc": [acc[n] for n in names]}


def optax_from_optimizer(
    state: Mapping[str, Any], names: Sequence[str], encoder_cfg: EncoderConfig,
    stacked: bool = False,
) -> Dict[str, Any]:
    """The port's ``Optimizer.state_dict()`` → the leaves of the JAX
    package's optax state, as flax trees of numpy arrays: ``mu``, ``nu``,
    ``count`` (Adam), ``update_count`` (the schedule's count and
    ``MultiSteps``' ``gradient_step``), ``mini_step`` and ``acc_grads``
    (None without gradient accumulation). ``names`` are the parameters'
    names in the optimizer's order."""
    per = state["adamw"]["state"]

    def tree(tensors):
        return flax_from_state_dict(dict(zip(names, tensors)), encoder_cfg, stacked)[0]

    acc = state["acc"]
    return {"mu": tree(per[i]["exp_avg"] for i in range(len(names))),
            "nu": tree(per[i]["exp_avg_sq"] for i in range(len(names))),
            "count": int(per[0]["step"]), "update_count": int(state["update_count"]),
            "mini_step": int(state["mini_step"]),
            "acc_grads": None if acc is None else tree(acc)}
