"""Gradient compression for the data-parallel all-reduce.

Twin of ``src/repro/distributed/compression.py``. Int8 stochastic-rounding
compression: each data-parallel rank computes the gradient of its own
batch shard, quantizes it to int8 at a per-tensor scale shared by an
``all_reduce(MAX)``, the sum runs on the int8 payload (widened to int32,
``all_reduce(SUM)``), and the sum is dequantized and averaged. Stochastic
rounding keeps the estimator unbiased.

  * ``compressed_dp_grads`` — the data-parallel path over a process group;
  * ``simulate_compression`` — the numerics-only transfer function applied
    to an already-reduced gradient (the one-device train step's
    ``compress_grads``).

Keys replay ``jax.random`` bit for bit (``core.prng``): the leaves are
visited in ``jax.tree.flatten`` order (dict keys sorted), leaf ``i`` of
``simulate_compression`` rounds under ``split(key, n_leaves)[i]``, and of
``compressed_dp_grads`` under ``fold_in(fold_in(key, i), rank)``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import prng
from repro_torch.training.optimizer import tree_leaves


def _stochastic_round(x: torch.Tensor, key: prng.Key) -> torch.Tensor:
    floor = torch.floor(x)
    up = prng.uniform(key, tuple(x.shape), device=x.device) < (x - floor)
    return floor + up.to(torch.float32)


def quantize_int8(g: torch.Tensor, key: prng.Key,
                  scale: torch.Tensor) -> torch.Tensor:
    q = _stochastic_round(g.to(torch.float32) / scale, key)
    # jnp.clip's order: max then min
    return torch.minimum(torch.maximum(q, q.new_tensor(-127.0)),
                         q.new_tensor(127.0)).to(torch.int8)


def _abs_max(g32: torch.Tensor) -> torch.Tensor:
    return torch.maximum(g32.abs().max(), g32.new_tensor(1e-12))


def _rebuild(tree: Any, leaves: list) -> Any:
    """``tree`` with its leaves (in ``tree_leaves`` order) replaced."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        return next(it)

    return walk(tree)


def simulate_compression(grads: Any, key: prng.Key) -> Any:
    """The int8 quant/dequant transfer, leaf by leaf (one device)."""
    leaves = tree_leaves(grads)
    keys = prng.split(key, len(leaves))
    out = []
    for g, k in zip(leaves, keys):
        scale = _abs_max(g.to(torch.float32)) / 127.0
        q = quantize_int8(g, k, scale)
        out.append((q.to(torch.float32) * scale).to(g.dtype))
    return _rebuild(grads, out)


def compressed_dp_grads(grad_fn: Callable[[Any, Any], Any], params: Any,
                        batch: Any, group=None,
                        key: prng.Key = None) -> Any:
    """Mean gradient over the ranks of ``group`` (the default group when
    None) with the int8-compressed all-reduce.

    ``grad_fn(params, local_batch) -> grads`` runs on each rank; ``batch``
    is the global batch (a dict of tensors, or a tensor), of which rank
    ``r`` of ``n`` takes rows ``[r * b / n, (r + 1) * b / n)``; ``params``
    are the same on every rank. Every rank returns the same mean."""
    import torch.distributed as dist
    if key is None:
        raise ValueError("compressed_dp_grads needs a key")
    rank, n = dist.get_rank(group), dist.get_world_size(group)

    def local(x):
        if isinstance(x, dict):
            return {k: local(v) for k, v in x.items()}
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split over {n} ranks")
        return x[rank * (b // n):(rank + 1) * (b // n)]

    grads = grad_fn(params, local(batch))
    out = []
    for i, g in enumerate(tree_leaves(grads)):
        g32 = g.to(torch.float32)
        m = _abs_max(g32)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        scale = m / 127.0
        q = quantize_int8(g32, prng.fold_in(prng.fold_in(key, i), rank),
                          scale)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
        out.append((tot.to(torch.float32) * scale / n).to(g.dtype))
    return _rebuild(grads, out)
