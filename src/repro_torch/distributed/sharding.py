"""Logical-axis sharding: one rules table maps model-space names to mesh axes.

Twin of ``src/repro/distributed/sharding.py``. Parameters carry
logical-axis tuples (``models.model.param_specs``); ``ShardingRules``
resolves a tuple of names and a shape to a spec over the mesh axes. A
spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names (the dimension split
over several axes, outermost first), the counterpart of the reference's
``PartitionSpec``. ``placements(spec, mesh)`` turns it into the DTensor
``Shard(d)``/``Replicate()`` of every dimension of a live
``torch.distributed.device_mesh.DeviceMesh``.

Default rules (DESIGN.md §7):
  * batch    -> ('pod', 'data')   data parallel over pods x data axis
  * heads/kv_heads/mlp/experts/vocab -> 'model'   tensor/expert parallel
  * embed    -> ('pod', 'data') on *parameters* (ZeRO/FSDP)
  * seq      -> None (replicated) normally; 'data' for long-context SP

A dimension whose size does not divide its mesh axes resolves to None
(replicated), e.g. qwen2's 14 heads on a 16-way model axis, and a mesh
axis is used at most once in a spec. ``_resolve`` reads only
``mesh.shape`` (name -> size), so a devices-free ``VirtualMesh`` and a
live mesh of the same shape resolve alike; ``mesh_axis_sizes`` gives
that mapping for a ``DeviceMesh``, which has no such attribute.

``shard(x, *names)`` is the activation constraint of the models, at the
reference's call sites. Under rules over a live mesh of more than one
rank (``collectives.live_mesh``) activations are local tensors, each
rank holding its block of the spec the port computes (``port_spec``):
the resolved activation spec, except that the port computes the
sequence axes ``seq``, ``qseq`` and ``frames`` whole on every rank. The
reference shards ``qseq`` over ``model`` where the heads do not divide
it (qwen2's 14 heads on a 4-way axis: context-parallel attention) and
``seq`` over ``data`` with ``seq_sharded=True``; the port computes those
replicated, which gives the same numbers. A dimension the rules
replicate because it does not divide is computed whole as well.
``shard(x, *names, held=spec)`` moves a block held under ``spec`` to
the port spec: an all-gather where ``held`` splits a dimension the
target keeps whole, a slice where the target splits one ``held`` keeps
whole (``collectives.all_gather`` / ``block``). Without ``held`` the
models assert that the computation already left ``x`` in the target
layout (the column- and row-parallel linears, the vocab-sharded head and
the local attention heads do), and ``shard`` returns it as it is. With
no rules, rules over a ``VirtualMesh`` or a one-rank group it is the
identity.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

# the one canonical axis vocabulary, outermost first: 'pod' = pipeline /
# cross-pod, 'data' = data parallel (+ FSDP), 'model' = tensor/expert
# parallel
MESH_AXES = ("pod", "data", "model")

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a live ``DeviceMesh``, or of anything with a
    ``.shape`` mapping (a ``VirtualMesh``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present on this mesh, canonical order."""
    shape = mesh_axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def tp_axis(mesh) -> Optional[str]:
    """The tensor/expert-parallel axis, or None (pure-DP mesh)."""
    return "model" if "model" in mesh_axis_sizes(mesh) else None


def pp_axis(mesh) -> Optional[str]:
    """The pipeline axis, or None (single-pod mesh)."""
    return "pod" if "pod" in mesh_axis_sizes(mesh) else None


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """Shape-only mesh stand-in: resolves specs without any devices, for
    configs whose parameters cannot be materialized (deepseek-v2-236b,
    zamba2-7b). ``axis_sizes`` keys must come from ``MESH_AXES``."""

    axis_sizes: Tuple[Tuple[str, int], ...]

    @staticmethod
    def make(**sizes: int) -> "VirtualMesh":
        bad = [a for a in sizes if a not in MESH_AXES]
        if bad:
            raise ValueError(
                f"unknown mesh axes {bad}: the canonical vocabulary is "
                f"{MESH_AXES} (distributed.sharding)")
        ordered = tuple((a, int(sizes[a])) for a in MESH_AXES if a in sizes)
        return VirtualMesh(axis_sizes=ordered)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axis_sizes)

    @property
    def devices(self) -> np.ndarray:   # parity with a mesh's size accounting
        n = 1
        for _, s in self.axis_sizes:
            n *= s
        return np.empty((n,), object)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object          # a DeviceMesh or a VirtualMesh
    activation: Dict[str, AxisVal]
    param: Dict[str, AxisVal]

    # lower = assigned first. 'seq'/'qseq' resolve last so they only take a
    # mesh axis left free by heads/experts
    PRIORITY = {"seq": 9, "qseq": 8, "frames": 9}

    def _resolve(self, table: Dict[str, AxisVal], names, shape) -> Spec:
        sizes = mesh_axis_sizes(self.mesh)
        order = sorted(range(len(shape)),
                       key=lambda i: self.PRIORITY.get(names[i] or "", 1))
        spec = [None] * len(shape)
        used = set()
        for i in order:
            name, dim = names[i], shape[i]
            ax = table.get(name)
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            if any(a in used for a in axes):
                continue  # an axis can appear only once in a spec
            size = 1
            for a in axes:
                size *= sizes[a]
            if dim % size != 0:
                continue  # non-divisible -> replicate (e.g. 14 heads)
            used.update(axes)
            spec[i] = axes[0] if len(axes) == 1 else axes
        return tuple(spec)

    def activation_spec(self, names, shape) -> Spec:
        return self._resolve(self.activation, names, shape)

    def param_spec(self, names, shape) -> Spec:
        return self._resolve(self.param, names, shape)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dimension) of a spec on a live
    ``DeviceMesh``: ``Shard(d)`` where tensor dimension ``d`` is split
    over that mesh dimension, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec) if s is not None
                and axis in ((s,) if isinstance(s, str) else s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_slice(spec: Spec, shape, mesh, coords: Dict[str, int]) -> tuple:
    """The index (a tuple of slices) of the shard that the rank at mesh
    coordinates ``coords`` (axis name -> index) holds under ``spec``: a
    dimension split over several axes takes them outermost first."""
    sizes = mesh_axis_sizes(mesh)
    idx = []
    for d, s in enumerate(spec):
        if s is None:
            idx.append(slice(None))
            continue
        axes = (s,) if isinstance(s, str) else s
        n, k = 1, 0
        for a in axes:
            n, k = n * sizes[a], k * sizes[a] + coords[a]
        step = shape[d] // n
        idx.append(slice(k * step, (k + 1) * step))
    return tuple(idx)


def default_rules(mesh, *, seq_sharded: bool = False,
                  fsdp_params: bool = True,
                  seq_axis: AxisVal = None) -> ShardingRules:
    dp: AxisVal = dp_axes(mesh)
    if len(dp) == 1:
        dp = dp[0]
    if seq_axis is None and seq_sharded and "data" in mesh_axis_sizes(mesh):
        seq_axis = "data"
    act = {
        "batch": dp,
        "seq": seq_axis,
        # query-seq of attention scores: takes 'model' only when the head
        # dims can't (resolver priority)
        "qseq": "model",
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "state": None,
        "frames": None,
    }
    par = {
        # ZeRO/FSDP: parameters sharded over the DP axes on their largest
        # replicated dim
        "embed": dp if fsdp_params else None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "layers": None,
        "state": None,
        "conv": None,
        "classes": None,
        "patch": None,
    }
    return ShardingRules(mesh=mesh, activation=act, param=par)


_STATE = threading.local()


def set_rules(rules: Optional[ShardingRules]) -> None:
    _STATE.rules = rules


def get_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


class use_rules:
    """Context manager installing sharding rules for a forward."""

    def __init__(self, rules: Optional[ShardingRules]):
        self.rules = rules

    def __enter__(self):
        self.prev = get_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self.prev)


# logical axes the port computes whole on every rank (see module doc)
WHOLE_AXES = ("seq", "qseq", "frames")


def port_spec(rules: ShardingRules, names, shape) -> Spec:
    """The activation spec the port computes: ``activation_spec`` with the
    ``WHOLE_AXES`` dimensions replicated."""
    spec = rules.activation_spec(names, shape)
    return tuple(None if n in WHOLE_AXES else s for n, s in zip(names, spec))


def shard(x: torch.Tensor, *names: Optional[str],
          held: Optional[Spec] = None) -> torch.Tensor:
    """The activation constraint by logical dim names (see module doc):
    ``x`` held under spec ``held`` (None: already in the target layout)
    brought to this rank's block of ``port_spec(names)``."""
    from repro_torch.distributed import collectives as col
    rules = get_rules()
    lm = col.live_mesh(rules)
    if lm is None or held is None:
        return x
    gshape = tuple(d * lm.size(h) for d, h in zip(x.shape, held))
    return col.relayout(x, held, port_spec(rules, names, gshape), lm)
