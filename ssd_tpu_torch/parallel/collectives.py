"""Tensor- and sequence-parallel regions as autograd functions over the
``model`` group (Megatron-LM's mappings, on plain local tensors).

The JAX package annotates shardings and lets GSPMD insert the collectives;
here each region boundary is explicit, and each forward collective has the
backward that makes the gradient of the whole mesh equal the unsharded
model's:

=====================  ===========================  ==========================
function               forward                      backward
=====================  ===========================  ==========================
:func:`copy_to`        identity                     all-reduce
:func:`reduce_from`    all-reduce                   identity
:func:`gather_seq`     all-gather on T              reduce-scatter on T
:func:`scatter_seq`    reduce-scatter on T          all-gather on T
:func:`split_seq`      this rank's T-shard          all-gather on T
:func:`gather_rows`    all-gather on T              this rank's T-shard
:func:`halo`           all-gather on T, a window    reduce-scatter on T
=====================  ===========================  ==========================

``copy_to`` / ``reduce_from`` bracket a column- then row-parallel pair when
the residual stream is replicated over ``model``; ``gather_seq`` /
``scatter_seq`` replace them when it is T-sharded (sequence parallelism).
``split_seq`` enters the T-sharded stream from a replicated tensor (the
subsampler's output) and ``gather_rows`` leaves it for the replicated heads.
A group of one rank makes every function the identity.

The custom ops (fused attention, the depthwise stencil) see only local
tensors: the attention the rank's heads on full T, the stencil a T-shard
with ``(K − 1)/2`` frames of halo on each side (:func:`halo`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=xt.dtype, device=xt.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=xt.dtype, device=xt.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if _size(group) > 1:
        x = x.contiguous()
        dist.all_reduce(x, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _shard(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _shard(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _GatherSeq.apply(x, dim, group)


def scatter_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _ScatterSeq.apply(x, dim, group)


def split_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _SplitSeq.apply(x, dim, group)


def gather_rows(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _GatherRows.apply(x, dim, group)


def halo(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """(B, Ts, C) → (B, h + Ts + h, C): this T-shard with ``h`` frames of
    each neighbour around it (zeros at the ends of the sequence, the 'SAME'
    padding). The shards are gathered (:func:`gather_seq`) and the window
    sliced, so a shard shorter than ``h`` needs no other path; the
    gradient outside the window is zero and the backward's reduce-scatter
    sums each frame's window gradients at its owner. The window is
    contiguous, as the stencil kernel takes it."""
    full = torch.nn.functional.pad(gather_seq(x, group), (0, 0, h, h))
    start = dist.get_rank(group) * x.shape[1]
    return full[:, start:start + x.shape[1] + 2 * h].contiguous()
