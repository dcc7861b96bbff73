"""Pipeline parallelism: the GPipe stage loop over the ranks of a group.

Twin of ``src/repro/distributed/pipeline.py``. Rank ``s`` of ``n_stage``
ranks is stage ``s``: the batch streams through in ``n_micro``
microbatches over ``n_micro + n_stage - 1`` ticks, stage ``s`` working on
microbatch ``t - s`` at tick ``t``; a stage hands its output to the next
rank by point-to-point send and receive, and the last stage's outputs are
broadcast to every rank, as the reference's ``psum`` shares them.

The result is differentiable: an autograd function around each hand-off
sends the gradient back up the pipeline, so each rank's parameter slice
and stage 0's input get their gradients. Every rank computes the same
loss from the shared output (the reference's replicated result), and the
broadcast passes the last rank's cotangent only, so the gradients are
those of the sequential stack, each on the rank that holds its stage
(a sum over the ranks gives the whole tree). Messages carry the
microbatch index as their tag (forward ``m``, backward ``n_micro + m``).

gloo's point-to-point send and receive take no CUDA tensor: with a gloo
group a CUDA hand-off is staged through host memory there, and only
there, and ``HOST_STAGED`` counts those copies (a collective — the
broadcast — takes CUDA tensors in gloo).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.training.optimizer import tree_map

# CUDA tensors staged through host memory for a gloo send or receive
HOST_STAGED = 0


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _send(t: torch.Tensor, dst: int, tag: int, group) -> None:
    global HOST_STAGED
    import torch.distributed as dist
    if _staged(t, group):
        HOST_STAGED += 1
        t = t.cpu()
    dist.send(t.contiguous(), dst=dst, group=group, tag=tag)


def _recv(like: torch.Tensor, src: int, tag: int, group) -> torch.Tensor:
    global HOST_STAGED
    import torch.distributed as dist
    if _staged(like, group):
        HOST_STAGED += 1
        buf = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buf, src=src, group=group, tag=tag)
        return buf.to(like.device)
    buf = torch.empty_like(like)
    dist.recv(buf, src=src, group=group, tag=tag)
    return buf


class _Recv(torch.autograd.Function):
    """Forward: receive microbatch ``m`` from the previous stage (the
    anchor only puts the node in the graph); backward: send its gradient
    back to that stage."""

    @staticmethod
    def forward(ctx, anchor, like, src, tag, back_tag, group):
        ctx.src, ctx.back_tag, ctx.group = src, back_tag, group
        return _recv(like, src, tag, group)

    @staticmethod
    def backward(ctx, grad):
        _send(grad, ctx.src, ctx.back_tag, ctx.group)
        return None, None, None, None, None, None


class _Send(torch.autograd.Function):
    """Forward: send microbatch ``m`` to the next stage, returning a
    zero that the caller folds into its output (so backward reaches this
    node); backward: receive the gradient of what was sent."""

    @staticmethod
    def forward(ctx, x, dst, tag, back_tag, group):
        ctx.dst, ctx.back_tag, ctx.group = dst, back_tag, group
        ctx.like = torch.empty_like(x)
        _send(x.detach(), dst, tag, group)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return (_recv(ctx.like, ctx.dst, ctx.back_tag, ctx.group),
                None, None, None, None)


class _ShareLast(torch.autograd.Function):
    """Broadcast the last stage's outputs to every rank; backward passes
    the last rank's cotangent (each rank holds the same loss) and gives
    the other ranks' stand-in a zero, which reaches their sends."""

    @staticmethod
    def forward(ctx, x, src, is_src, group):
        import torch.distributed as dist
        ctx.is_src = is_src
        out = x.detach().clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_src else torch.zeros_like(grad),
                None, None, None)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, group=None,
                   n_micro: int = 4) -> torch.Tensor:
    """Run ``x`` through ``n_stage`` stages, one a rank (GPipe schedule).

    Args:
      stage_fn: (params_for_stage, microbatch) -> microbatch output of the
        same shape; the same computation on every stage.
      stage_params: a tree of tensors with leading dim ``n_stage`` (the
        same on every rank); rank ``s`` applies slice ``s``.
      x: (batch, ...) global input, the same on every rank;
        ``batch % n_micro == 0``.
      group: the pipeline's process group (None: the default group).
      n_micro: microbatches in flight.

    Returns: (batch, ...) output of the whole stack, on every rank.
    """
    import torch.distributed as dist
    stage, n_stage = dist.get_rank(group), dist.get_world_size(group)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    mb = b // n_micro
    last = n_stage - 1
    params = tree_map(lambda t: t[stage], stage_params)
    micros = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    like = micros[0].detach()
    anchor = x.new_zeros((), requires_grad=True)
    outs = [None] * n_micro
    sent = x.new_zeros(())

    def peer(s):      # a stage's rank in the default group's numbering
        return dist.get_global_rank(group, s) if group is not None else s

    for t in range(n_micro + n_stage - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue
        inp = (micros[m] if stage == 0 else
               _Recv.apply(anchor, like, peer(stage - 1), m, n_micro + m,
                           group))
        out = stage_fn(params, inp)
        if stage < last:
            sent = sent + _Send.apply(out, peer(stage + 1), m, n_micro + m,
                                      group)
        else:
            outs[m] = out
    held = (torch.cat(outs) if stage == last else
            torch.zeros((b,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device) + sent)
    return _ShareLast.apply(held, peer(last), stage == last, group)
