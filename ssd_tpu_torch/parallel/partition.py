"""Parameter placement over the mesh: tensor parallelism over ``model`` and
FSDP over ``data`` (port of ``ssd_tpu/parallel/partition.py``).

:func:`param_placement` is the JAX package's ``param_pspec`` for the port's
parameter names and (out, in) ``Dense`` weights. It views a weight in flax's
layout (``Dense`` ``(in, out)``, attention ``query/key/value`` ``(D, H,
hd)``, ``out`` ``(H, hd, D)``, convolutions ``(K, in, out)``), applies the
JAX rules there and maps the chosen dims back:

* the FFN's ``w1`` is column-parallel (its rows, the FFN dim), ``w2``
  row-parallel (its columns) with its bias replicated;
* attention ``query`` / ``key`` / ``value`` split by head (their rows and
  biases), ``out`` is row-parallel;
* everything else is replicated over ``model``;
* FSDP (``fsdp_data > 1``) also shards the largest dim the TP rule left
  whole that ``fsdp_data`` divides, on leaves of at least
  :data:`FSDP_MIN_SIZE` elements; batch statistics never.

:func:`shard_model` applies it: the TP slices replace the parameters (plain
local tensors; the forward brackets each sharded pair with the
``parallel/collectives.py`` regions), then FSDP2's ``fully_shard`` over the
``data`` sub-mesh, one unit a Conformer block and one for the rest, with
``shard_placement_fn`` returning the rule's dim.

Under the GPipe schedule (``ctx.pipeline``, ``parallel/pipeline.py``) the
``model`` ranks are stages, the JAX ``param_pspec(..., pipeline=True)``:
stage s keeps the blocks it runs and holds the others' parameters as
empty tensors (so every rank has the same parameter list, and the
optimizer's moments of a block live on its stage only); everything else is
replicated over ``model``, no TP rule applies, and FSDP2 over ``data``
shards each stage's own blocks and the replicated rest.

Known divergence from the JAX placement: FSDP2 shards every parameter. A
leaf the rule leaves replicated (small, batch statistics aside, or without
a dim ``fsdp_data`` divides) is sharded on dim 0, unevenly where it must
be. Memory moves a little; the numbers do not.

The checkpoint stays unsharded: :func:`full_state_dict` and
:func:`gather_for` rebuild each tensor (``DTensor.full_tensor`` over
``data``, an all-gather over ``model`` on the TP dim) and
:func:`local_piece` cuts a full tensor back to this rank's piece, so a
checkpoint moves between topologies.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ssd_tpu_torch.parallel.mesh import DATA_AXIS, ParallelContext

# Leaves smaller than this stay replicated under the FSDP rule: sharding a
# 288-float bias saves nothing and costs a collective's latency per use.
FSDP_MIN_SIZE = 1024


class Placement(NamedTuple):
    """Dims of the port's tensor sharded over ``model`` and over ``data``."""

    tp: Optional[int] = None
    fsdp: Optional[int] = None


def _flax_view(names: Sequence[str], shape: Tuple[int, ...], num_heads: int):
    """(flax names, flax shape, flax dim → port dim) of one port parameter."""
    leaf = names[-1] if names else ""
    if leaf in ("weight", "bias") and len(names) > 1:
        mod = names[-2]
        if mod in ("query", "key", "value") and "mha" in names:
            if leaf == "weight":  # (H·hd, D) ↔ (D, H, hd)
                hd = shape[0] // num_heads
                return [*names[:-1], "kernel"], (shape[1], num_heads, hd), (1, 0, 0)
            return [*names[:-1], "bias"], (num_heads, shape[0] // num_heads), (0, 0)
        if mod == "out" and "mha" in names and leaf == "weight":  # (D, H·hd) ↔ (H, hd, D)
            hd = shape[1] // num_heads
            return [*names[:-1], "kernel"], (num_heads, hd, shape[0]), (1, 1, 0)
        if leaf == "weight" and len(shape) == 2:  # Dense (out, in) ↔ (in, out)
            return [*names[:-1], "kernel"], (shape[1], shape[0]), (1, 0)
        if leaf == "weight" and len(shape) == 3:  # Conv (out, in, K) ↔ (K, in, out)
            return [*names[:-1], "kernel"], tuple(reversed(shape)), (2, 1, 0)
    return list(names), tuple(shape), tuple(range(len(shape)))


def _tp_spec(names: Sequence[str], ndim: int) -> List[Optional[str]]:
    """The JAX package's ``_tp_pspec_base`` over a flax view ("model" or
    None a dim)."""
    spec: List[Optional[str]] = [None] * ndim
    leaf = names[-1] if names else ""
    if "w1" in names:
        if leaf == "kernel" and ndim == 2:
            spec[1] = "model"
        elif leaf == "bias" and ndim == 1:
            spec[0] = "model"
    elif "w2" in names:
        if leaf == "kernel" and ndim == 2:
            spec[0] = "model"
    elif "mha" in names:
        if any(n in ("query", "key", "value") for n in names):
            if leaf == "kernel" and ndim == 3:
                spec[1] = "model"
            elif leaf == "bias" and ndim == 2:
                spec[0] = "model"
        elif "out" in names and leaf == "kernel" and ndim == 3:
            spec[0] = "model"
    return spec


def _fsdp_dim(spec: List[Optional[str]], names: Sequence[str], shape: Tuple[int, ...],
              fsdp_data: int) -> Optional[int]:
    """The JAX package's ``_with_fsdp``: the largest dim the TP rule left
    whole that ``fsdp_data`` divides, first on ties."""
    if fsdp_data <= 1 or "batch_stats" in names or not shape:
        return None
    if int(np.prod(shape)) < FSDP_MIN_SIZE:
        return None
    best = -1
    for d, size in enumerate(shape):
        if spec[d] is None and size % fsdp_data == 0 and (best < 0 or size > shape[best]):
            best = d
    return None if best < 0 else best


def param_placement(name: str, shape: Sequence[int], model_par: int, fsdp_data: int = 0,
                    num_heads: int = 1, buffer: bool = False,
                    pipeline: bool = False) -> Placement:
    """Where one port tensor is sharded: :class:`Placement` of port dims.

    ``name`` is the port's ``state_dict`` key, ``shape`` its full shape,
    ``num_heads`` the encoder's (attention weights merge the head axis).
    ``buffer=True`` marks the BatchNorm statistics (the JAX
    ``batch_stats``), which stay replicated. ``pipeline=True``: the
    ``model`` axis holds pipeline stages, so no TP rule applies (the stage
    split is by block, :func:`shard_model`)."""
    names = name.split(".")
    if buffer:
        names = ["batch_stats"] + names
    fnames, fshape, to_port = _flax_view(names, tuple(int(s) for s in shape), num_heads)
    spec = [None] * len(fshape) if buffer or pipeline else _tp_spec(fnames, len(fshape))
    tp = next((to_port[d] for d, s in enumerate(spec) if s == "model"), None)
    fsdp = _fsdp_dim(spec, fnames, fshape, fsdp_data)
    return Placement(tp=tp if model_par > 1 else None,
                     fsdp=None if fsdp is None else to_port[fsdp])


def check_tp_divisibility(cfg_model: dict, model_par: int) -> bool:
    """True when the encoder dims divide the tensor-parallel degree."""
    enc = cfg_model["encoder"]
    return int(enc["ffn_dim"]) % model_par == 0 and int(enc["num_heads"]) % model_par == 0


def shard_model(model: nn.Module, ctx: Optional[ParallelContext]) -> nn.Module:
    """Place ``model`` (unsharded, on the rank's device) over the mesh, in
    place: TP slices over ``model``, the parallel regions switched on, then
    FSDP2 over ``data`` when ``ctx.fsdp``. One process (``ctx`` None) or a
    1×1 mesh without FSDP leaves it as it is."""
    model._parallel = ctx
    model._tp_dims = {}
    model._sp_partial = set()
    model._stage_of = {}
    if ctx is None:
        return model
    enc_cfg = model.encoder_cfg
    if ctx.pipeline:
        _place_stages(model, ctx)
    elif ctx.model > 1:
        if not check_tp_divisibility({"encoder": {"ffn_dim": enc_cfg.ffn_dim,
                                                  "num_heads": enc_cfg.num_heads}}, ctx.model):
            raise ValueError(
                f"parallel.model={ctx.model} must divide ffn_dim and num_heads "
                f"({enc_cfg.ffn_dim}, {enc_cfg.num_heads})"
            )
        for name, p in list(model.named_parameters()):
            pl = param_placement(name, p.shape, ctx.model, 0, enc_cfg.num_heads)
            if pl.tp is None:
                continue
            mod_name, leaf = name.rsplit(".", 1)
            mod = model.get_submodule(mod_name)
            piece = p.detach().chunk(ctx.model, pl.tp)[ctx.model_rank].clone()
            setattr(mod, leaf, nn.Parameter(piece, requires_grad=p.requires_grad))
            model._tp_dims[name] = pl.tp
        for block in model.encoder.blocks:
            block.attn.mha.num_heads = enc_cfg.num_heads // ctx.model
            for mod in (block.ffn1, block.ffn2, block.attn, block.conv):
                mod.par = ctx
        model.encoder.par = ctx
        if ctx.sequence:
            # a block's parameters that TP left whole run in its T-sharded
            # regions: each rank's gradient covers its T-shard only, and
            # sync_grads sums them over `model`
            model._sp_partial = {n for n, _ in model.named_parameters()
                                 if n.startswith("encoder.blocks.") and n not in model._tp_dims}
    if ctx.data > 1 or ctx.sequence:
        for block in model.encoder.blocks:
            if hasattr(block.conv, "bn"):
                block.conv.bn.par = ctx
    if ctx.fsdp:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import DTensor, Replicate, Shard

        dims = {}
        for name, p in model.named_parameters():
            full = list(model._stage_of[name][1] if name in model._stage_of else p.shape)
            if name in model._tp_dims:
                full[model._tp_dims[name]] *= ctx.model
            d = param_placement(name, full, ctx.model, ctx.data, enc_cfg.num_heads,
                                pipeline=bool(ctx.pipeline)).fsdp
            dims[id(p)] = 0 if d is None else d

        def placement(p: nn.Parameter):
            return Shard(dims.get(id(p), 0))

        data_mesh = ctx.mesh[DATA_AXIS]
        # another stage's blocks hold empty tensors: FSDP2 leaves them alone,
        # and they become replicated DTensors so that every parameter the
        # optimizer steps is one (its foreach kernels refuse a mix)
        empty = set()
        for name, p in list(model.named_parameters()):
            if name in model._stage_of and model._stage_of[name][0] != ctx.model_rank:
                mod_name, leaf = name.rsplit(".", 1)
                q = nn.Parameter(DTensor.from_local(p.detach(), data_mesh, [Replicate()],
                                                    run_check=False),
                                 requires_grad=p.requires_grad)
                setattr(model.get_submodule(mod_name), leaf, q)
                empty.add(q)
        for block in model.encoder.blocks:
            if not any(p in empty for p in block.parameters()):
                fully_shard(block, mesh=data_mesh, shard_placement_fn=placement)
        fully_shard(model, mesh=data_mesh, shard_placement_fn=placement,
                    **({"ignored_params": empty} if empty else {}))
    return model


def _place_stages(model: nn.Module, ctx: ParallelContext) -> None:
    """GPipe placement: this stage keeps its blocks; another stage's
    block parameters become empty tensors, recorded in ``model._stage_of``
    (name → (stage, full shape)) for :func:`gather_for` / :func:`local_piece`."""
    from ssd_tpu_torch.parallel.pipeline import check_stages, stage_of

    blocks = model.encoder.blocks
    check_stages(len(blocks), ctx.model)
    for i, block in enumerate(blocks):
        stage = stage_of(i, len(blocks), ctx.model)
        for name, p in list(block.named_parameters()):
            model._stage_of[f"encoder.blocks.{i}.{name}"] = (stage, tuple(p.shape))
            if stage != ctx.model_rank:
                mod_name, leaf = name.rsplit(".", 1)
                setattr(block.get_submodule(mod_name), leaf,
                        nn.Parameter(p.detach().new_empty(0), requires_grad=p.requires_grad))
    model.encoder.par = ctx


# --------------------------------------------------------------------------
# Gradients
# --------------------------------------------------------------------------


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage), else the tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def _flat_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` in place over ``group`` with one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def sync_grads(model: nn.Module) -> None:
    """After ``backward``: sum the T-shard partial gradients over ``model``
    (sequence parallelism), then average every gradient over ``data``
    (FSDP2 has already reduce-scattered its own). A missing gradient counts
    as zeros, on every rank alike."""
    ctx: Optional[ParallelContext] = getattr(model, "_parallel", None)
    if ctx is None:
        return
    params = list(model.named_parameters())
    for _, p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if ctx.sequence:
        _flat_all_reduce([local_tensor(p.grad) for n, p in params if n in model._sp_partial],
                         ctx.model_group)
    if ctx.data > 1 and not ctx.fsdp:
        grads = [p.grad for _, p in params]
        _flat_all_reduce(grads, ctx.data_group)
        torch._foreach_div_(grads, float(ctx.data))


def grad_norm_fn(model: nn.Module) -> Optional[Callable[[List[torch.Tensor]], torch.Tensor]]:
    """The global gradient norm over the mesh for the optimizer's clip, each
    parameter counted once: squares of TP shards and of pipeline stages'
    blocks summed over ``model``, of FSDP shards over ``data``, replicated
    copies taken once. ``None`` in one process and on a 1×1 mesh: the
    optimizer's own norm of the local tensors, so one rank steps as one
    process does."""
    ctx: Optional[ParallelContext] = getattr(model, "_parallel", None)
    if ctx is None or ctx.world == 1:
        return None
    # a TP shard or a pipeline stage's block: its squares summed over `model`
    over_model = set(model._tp_dims) | set(model._stage_of)
    kinds = [(n in over_model, hasattr(p, "to_local")) for n, p in model.named_parameters()]

    kind = torch.tensor([(0 if tp else 2) + (0 if fs else 1) for tp, fs in kinds])
    onehot = torch.nn.functional.one_hot(kind, 4).to(torch.float32)

    def norm(grads: List[torch.Tensor]) -> torch.Tensor:
        sq = torch.stack(torch._foreach_norm([local_tensor(g) for g in grads])).float().square()
        # [tp & fsdp, tp only, fsdp only, replicated] sums of squares
        parts = sq @ onehot.to(sq.device)
        if ctx.data > 1:
            both = parts[[0, 2]].contiguous()
            dist.all_reduce(both, group=ctx.data_group)
            parts[[0, 2]] = both
        if ctx.model > 1:
            both = parts[[0, 1]].contiguous()
            dist.all_reduce(both, group=ctx.model_group)
            parts[[0, 1]] = both
        return parts.sum().sqrt()

    return norm


# --------------------------------------------------------------------------
# Full (unsharded) state
# --------------------------------------------------------------------------


def gather_for(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """The full tensor of parameter ``name``'s piece ``t`` (a parameter, its
    gradient or an optimizer moment), on the CPU. Collective: every rank
    calls it in the same order."""
    ctx: Optional[ParallelContext] = getattr(model, "_parallel", None)
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    dim = getattr(model, "_tp_dims", {}).get(name)
    if ctx is not None and dim is not None and ctx.model > 1:
        parts = [torch.empty_like(t) for _ in range(ctx.model)]
        dist.all_gather(parts, t.contiguous(), group=ctx.model_group)
        t = torch.cat(parts, dim)
    stage = getattr(model, "_stage_of", {}).get(name)
    if ctx is not None and stage is not None:  # a block: from its stage
        owner, shape = stage
        if ctx.model_rank != owner:
            t = torch.empty(shape, dtype=t.dtype, device=t.device)
        t = t.contiguous()
        dist.broadcast(t, dist.get_global_rank(ctx.model_group, owner), group=ctx.model_group)
    return t.to("cpu", copy=True)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The unsharded ``state_dict`` on every rank (CPU tensors)."""
    return {k: gather_for(model, k, v) for k, v in model.state_dict().items()}


def local_piece(model: nn.Module, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the full tensor ``full`` of parameter ``name``,
    laid out as ``like`` (the parameter): the TP chunk, then the FSDP shard
    as a DTensor of ``like``'s mesh and placement."""
    ctx: Optional[ParallelContext] = getattr(model, "_parallel", None)
    dim = getattr(model, "_tp_dims", {}).get(name)
    if ctx is not None and dim is not None and ctx.model > 1:
        full = full.chunk(ctx.model, dim)[ctx.model_rank]
    from torch.distributed.tensor import DTensor

    stage = getattr(model, "_stage_of", {}).get(name)
    if ctx is not None and stage is not None and stage[0] != ctx.model_rank:
        piece = full.new_empty(0, device=like.device)  # another stage's block
        if not hasattr(like, "to_local"):
            return piece
        return DTensor.from_local(piece, like.device_mesh, like.placements, run_check=False)
    if not hasattr(like, "to_local"):
        return full.to(device=like.device, dtype=full.dtype).clone()

    (shard,) = like.placements
    d, n = shard.dim, like.device_mesh.size()
    size = math.ceil(full.shape[d] / n)
    start = min(like.device_mesh.get_local_rank() * size, full.shape[d])
    piece = full.narrow(d, start, max(0, min(size, full.shape[d] - start)))
    piece = piece.to(device=like.to_local().device).contiguous()
    return DTensor.from_local(piece, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())

