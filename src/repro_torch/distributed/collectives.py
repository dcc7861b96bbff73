"""The explicit collectives of the tensor- and expert-parallel forward.

Activations of a forward on a live mesh stay local tensors, each rank
holding its block; these helpers move them, each over one or more named
mesh axes (outermost first, as a spec names them):

  * ``all_reduce(x, axes, op)`` — the sum or the max over the ranks that
    share this rank's other coordinates (``op`` "sum" or "max"; a new
    tensor, ``x`` is left as it was);
  * ``all_gather(x, dim, axes)`` — the ranks' blocks concatenated along
    ``dim`` in coordinate order (outermost axis slowest), exact;
  * ``block(x, dim, axes, lm)`` — this rank's block of a whole tensor
    along ``dim`` (no communication);
  * ``relayout(x, held, want, lm)`` — a block under one spec as the
    block under another (the two above, per dimension).

Each calls the collective of ``torch.distributed`` on the tensor itself,
under NCCL and under gloo alike: gloo's ``all_reduce`` (sum and max) and
``all_gather_into_tensor`` take CUDA tensors of float32, bfloat16, int8
and int32 (PyTorch 2.11, CUDA 12.8, on the H100), so nothing is staged
through host memory here (unlike gloo's send and receive,
``distributed/pipeline.py``). ``COUNTS`` counts the calls and the bytes
each rank contributes.

``LiveMesh`` is the rank's view of a live ``DeviceMesh``: axis sizes, its
coordinates, the flat index of its block over a tuple of axes.
``live_mesh(rules)`` returns it for installed rules over a live mesh of
more than one rank, else None: a ``VirtualMesh`` (shape only) and a
one-rank group run every path as on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (AxisVal, ShardingRules,
                                              VirtualMesh, mesh_axis_sizes)

COUNTS = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def axes_of(ax: AxisVal) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axes (None: ())."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclasses.dataclass(frozen=True)
class LiveMesh:
    mesh: object                  # torch.distributed DeviceMesh
    sizes: Dict[str, int]
    coords: Dict[str, int]

    def size(self, ax: AxisVal) -> int:
        n = 1
        for a in axes_of(ax):
            n *= self.sizes[a]
        return n

    def index(self, ax: AxisVal) -> int:
        """This rank's flat block index over ``ax`` (outermost first)."""
        k = 0
        for a in axes_of(ax):
            k = k * self.sizes[a] + self.coords[a]
        return k


def live_mesh(rules: Optional[ShardingRules]) -> Optional[LiveMesh]:
    if rules is None or isinstance(rules.mesh, VirtualMesh):
        return None
    sizes = mesh_axis_sizes(rules.mesh)
    if all(s == 1 for s in sizes.values()):
        return None
    coords = dict(zip(rules.mesh.mesh_dim_names,
                      rules.mesh.get_coordinate()))
    return LiveMesh(rules.mesh, sizes, coords)


def _count(kind: str, x: torch.Tensor) -> None:
    COUNTS[kind] += 1
    COUNTS["bytes"] += x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, axes: AxisVal, lm: LiveMesh,
               op: str = "sum") -> torch.Tensor:
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = x.contiguous().clone()
    for a in axes_of(axes):
        if lm.sizes[a] > 1:
            _count("all_reduce", out)
            dist.all_reduce(out, op=red, group=lm.mesh.get_group(a))
    return out


def all_gather(x: torch.Tensor, dim: int, axes: AxisVal,
               lm: LiveMesh) -> torch.Tensor:
    """Blocks along ``dim`` in coordinate order: the innermost axis is
    gathered first, so the outermost varies slowest."""
    import torch.distributed as dist
    dim = dim % x.ndim
    for a in reversed(axes_of(axes)):
        n = lm.sizes[a]
        if n == 1:
            continue
        _count("all_gather", x)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, src, group=lm.mesh.get_group(a))
        x = out.movedim(0, dim)
    return x.contiguous()


def block(x: torch.Tensor, dim: int, axes: AxisVal,
          lm: LiveMesh) -> torch.Tensor:
    n = lm.size(axes)
    if n == 1:
        return x
    step = x.shape[dim] // n
    return x.narrow(dim, lm.index(axes) * step, step)


def relayout(x: torch.Tensor, held, want, lm: LiveMesh) -> torch.Tensor:
    """``x``, this rank's block under spec ``held``, as its block under
    spec ``want``: per dimension an all-gather over the axes ``held``
    splits it by, then this rank's block of the axes ``want`` splits it
    by, where the two differ."""
    for d, (h, w) in enumerate(zip(held, want)):
        if axes_of(h) == axes_of(w):
            continue
        if h is not None:
            x = all_gather(x, d, h, lm)
        if w is not None:
            x = block(x, d, w, lm)
    return x
