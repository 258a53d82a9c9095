"""GPipe pipeline parallelism for the Conformer stack (port of
``ssd_tpu/parallel/pipeline.py``).

``parallel.pipeline_microbatches: M > 0`` turns the mesh's ``model`` axis
into S pipeline stages: stage s holds blocks ``s·L/S … (s+1)·L/S − 1``
(``parallel/partition.py:shard_model`` leaves the other blocks' parameters
empty on it), each data rank's rows are cut into M microbatches, and the
microbatches stream through the stages.

Schedule: plain GPipe, all forwards before all backwards. ``M + S − 1``
forward ticks: at tick t stage s runs microbatch ``j = t − s`` through its
blocks, then every stage posts its send to s + 1 and its receive from
s − 1 together (``dist.batch_isend_irecv``; both sides of a pair agree on
the tick). The last stage's outputs are broadcast over ``model``, so the
heads and the loss run on every stage alike (the JAX package's ``psum`` of
the last stage's rows). The backward mirrors it in M + S − 1 ticks, the last
stage first, microbatches in reverse order, each stage's backward driven by
an explicit ``torch.autograd.backward`` of the microbatch it stashed, so no
stage waits on an order autograd picked. Stage 0's input gradient is
broadcast back over ``model``: every stage's front end gets the whole
gradient, and the replicated parameters' gradients are equal on every stage
without a sum. The stages' parameters accumulate their gradients directly;
the bubble is ``(S − 1)/(M + S − 1)`` of the ticks.

The carry is fp32 (the JAX ``scan_stack`` casts it before the first block,
as ``scan_layers`` does). Under ``remat`` every block is recomputed whole
(``jax.checkpoint`` without a policy there): ``remat_policy`` does not apply.
Dropout inside the blocks draws from the stage's own stream
(``RngStreams.sharded``, which varies over data and model ranks); the
front end and the heads draw the ``replicated`` stream, the same on every
stage of a data rank, so the stages compute the same loss.

Without a ``model`` axis above 1 (one process, serving, evaluation) the same
parameters run through :func:`sequential_stack`, so a pipelined checkpoint
serves anywhere. Restrictions, as in the JAX package:
:func:`validate_pipeline_config` (``conv_norm: layer``, not with
``scan_layers`` or ``sequence``) and, at run time, ``num_layers`` divisible
by S and each data rank's rows by M (:func:`check_stages`,
:func:`check_rows`).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ssd_tpu_torch.ops.dropout import stream


def validate_pipeline_config(enc_cfg) -> None:
    """Static (mesh-independent) pipeline restrictions — raise early."""
    if enc_cfg.pipeline_microbatches <= 0:
        return
    if enc_cfg.conv_norm != "layer":
        raise ValueError(
            "pipeline parallelism requires model.encoder.conv_norm: layer "
            "(BatchNorm batch statistics do not commute with microbatching)"
        )
    if enc_cfg.scan_layers:
        raise ValueError(
            "pipeline_microbatches and scan_layers are mutually exclusive "
            "(the pipeline declares the same stacked blocks/block layout)"
        )
    if enc_cfg.sequence_parallel:
        raise ValueError(
            "pipeline parallelism consumes the 'model' mesh axis; disable "
            "parallel.sequence (tensor/sequence parallelism) to pipeline"
        )


def _apply_blocks(cfg, blocks: Sequence[torch.nn.Module], x: torch.Tensor, mask: torch.Tensor,
                  train: bool, generator) -> torch.Tensor:
    """``blocks`` in order over ``x``; under ``remat`` each block whole."""
    from ssd_tpu_torch.models.conformer import _remat

    for block in blocks:
        if cfg.remat and torch.is_grad_enabled():
            x = _remat(functools.partial(block, pad_mask=mask, train=train, generator=generator),
                       x, generator, "full")
        else:
            x = block(x, mask, train, generator)
    return x


def sequential_stack(cfg, blocks: Sequence[torch.nn.Module], x: torch.Tensor,
                     mask: torch.Tensor, train: bool, generator=None) -> torch.Tensor:
    """The blocks over ``x`` with an fp32 carry: the execution without
    stages (the JAX ``scan_stack``) and each stage's inner loop."""
    return _apply_blocks(cfg, blocks, x.to(torch.float32), mask, train, generator)


def stage_of(block: int, num_layers: int, stages: int) -> int:
    """The stage that holds block ``block``: each holds ``num_layers /
    stages`` consecutive blocks."""
    return block // (num_layers // stages)


def check_stages(num_layers: int, stages: int) -> None:
    """The JAX schedule's check that the stages split the blocks evenly."""
    if num_layers % stages:
        raise ValueError(
            f"pipeline: num_layers={num_layers} not divisible by "
            f"{stages} stages (mesh 'model' axis)"
        )


def check_rows(rows: int, microbatches: int) -> None:
    """The JAX schedule's check that the microbatches split the rows evenly."""
    if rows % microbatches:
        raise ValueError(
            f"pipeline: batch {rows} on this data rank not divisible by "
            f"microbatches {microbatches}"
        )


_READY_GROUPS: set = set()


def _ready(group, device: torch.device) -> None:
    """One collective over ``group`` before its first point-to-point ops
    (NCCL wants every rank of a group in its first call)."""
    key = id(group)
    if key not in _READY_GROUPS:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        _READY_GROUPS.add(key)


def _exchange(send: Optional[torch.Tensor], send_to: int, recv: Optional[torch.Tensor],
              recv_from: int, group) -> None:
    """One tick's sends and receives, posted together and waited for."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, send_to), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node: ``x`` (this data rank's rows,
    fp32) in, the last stage's output on every stage out. The forward keeps
    each microbatch's stage graph; the backward drives them in GPipe's
    reverse order and returns stage 0's input gradient on every stage."""

    @staticmethod
    def forward(ctx, x, mask, run: Callable, microbatches: int, group, build_graph: bool):
        S, s = dist.get_world_size(group), dist.get_rank(group)
        M = microbatches
        xs, masks = x.chunk(M), mask.chunk(M)
        mb_shape = xs[0].shape
        stash: List = [None] * M
        outs: List = [None] * M
        recv = None
        if S > 1:
            _ready(group, x.device)
        for t in range(M + S - 1):
            j = t - s
            if 0 <= j < M:
                inp = xs[j] if s == 0 else recv
                if build_graph:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = run(inp, masks[j])
                    stash[j] = (inp, y)
                else:
                    y = run(inp, masks[j])
                outs[j] = y.detach().contiguous()
            send = outs[j] if s < S - 1 and 0 <= j < M else None
            recv = (torch.empty(mb_shape, dtype=torch.float32, device=x.device)
                    if s > 0 and 0 <= t - (s - 1) < M else None)
            _exchange(send, s + 1, recv, s - 1, group)
        out = (torch.cat(outs) if s == S - 1
               else torch.empty(x.shape, dtype=torch.float32, device=x.device))
        if S > 1:
            dist.broadcast(out, dist.get_global_rank(group, S - 1), group=group)
        ctx.stash, ctx.group, ctx.M, ctx.mb_shape = stash, group, M, mb_shape
        return out

    @staticmethod
    def backward(ctx, grad_out):
        group, M, stash = ctx.group, ctx.M, ctx.stash
        S, s = dist.get_world_size(group), dist.get_rank(group)
        grads = grad_out.contiguous().chunk(M)
        g_in: List = [None] * M
        recv = None
        for t in range(M + S - 1):
            k = t - (S - 1 - s)  # this stage's k-th backward: microbatch M − 1 − k
            j = M - 1 - k
            if 0 <= k < M:
                g = grads[j] if s == S - 1 else recv
                inp, y = stash[j]
                with torch.enable_grad():
                    torch.autograd.backward(y, g)
                g_in[j] = inp.grad.contiguous()
                stash[j] = None
            send = g_in[j] if s > 0 and 0 <= k < M else None
            k_next = t - (S - 2 - s)  # stage s + 1's k at this tick
            recv = (torch.empty(ctx.mb_shape, dtype=torch.float32, device=grad_out.device)
                    if s < S - 1 and 0 <= k_next < M else None)
            _exchange(send, s - 1, recv, s + 1, group)
        ctx.stash = None
        gx = (torch.cat(g_in) if s == 0
              else torch.empty(grad_out.shape, dtype=torch.float32, device=grad_out.device))
        if S > 1:
            dist.broadcast(gx, dist.get_global_rank(group, 0), group=group)
        return gx, None, None, None, None, None


def gpipe(cfg, blocks: Sequence[torch.nn.Module], x: torch.Tensor, mask: torch.Tensor,
          train: bool, generator, microbatches: int, group) -> torch.Tensor:
    """The GPipe schedule over ``group`` (the ``model`` ranks of this data
    rank, one a stage): ``blocks`` is the whole stack, of which this stage
    runs those :func:`stage_of` gives it. Returns the stack's output for
    this data rank's rows on every stage. The gradient reaches the blocks
    only through ``x``, which must require it in training (the front end's
    output does)."""
    S, s = dist.get_world_size(group), dist.get_rank(group)
    M = int(microbatches) or 1
    check_stages(len(blocks), S)
    check_rows(x.shape[0], M)
    own = [b for i, b in enumerate(blocks) if stage_of(i, len(blocks), S) == s]
    gen = stream(generator, "sharded")

    def run(inp, m):
        return _apply_blocks(cfg, own, inp, m, train, gen)

    build_graph = torch.is_grad_enabled() and x.requires_grad
    return _GPipe.apply(x.to(torch.float32), mask, run, M, group, build_graph)


def pipelined_stack(cfg, blocks: Sequence[torch.nn.Module], x: torch.Tensor,
                    mask: torch.Tensor, train: bool, generator, par) -> torch.Tensor:
    """The block stack of a ``pipeline_microbatches > 0`` encoder: GPipe over
    ``par``'s ``model`` group when it holds stages, else
    :func:`sequential_stack`."""
    if par is None or not par.pipeline:
        return sequential_stack(cfg, blocks, x, mask, train, generator)
    return gpipe(cfg, blocks, x, mask, train, generator, par.pipeline, par.model_group)
