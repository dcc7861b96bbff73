"""Deploy pass: pre-quantize every CIM-routed weight once per SAC policy.

Twin of the single-device part of ``src/repro/core/deploy.py``: the macro
is weight-stationary, so every CIM-routed dense dict ``{"w": (..., K, N)}``
gets a resident plane ``wq<bits>`` (int8) and its per-slice scale
``ws<bits>`` (in the config dtype), keyed by the deployed bit-width. MoE
expert banks (raw ``(E, d_in, d_out)`` tensors, stacked over layers) get
sibling ``<bank>_q<bits>``/``<bank>_s<bits>`` planes with one f32 scale
per layer slice, the per-tensor scale ``models.moe._expert_dense`` uses.
``deploy(fault=, guard=)`` attaches the ABFT checksum ``wc<bits>`` of the
clean plane (``checksum_plane``: one int32 column, or G per-segment
columns) and then masks each dense plane with stuck-at bitcells
(``core.faults.stuck_bit_plane``, one key per plane in walk order); expert
banks get neither, as in the reference.

Tensor-parallel placement (``deploy(rules=, param_axes=)``): every plane
is built as in the single-device path, bit for bit (the quantization
happens once, globally), then placed: over a live ``DeviceMesh`` each
plane becomes a DTensor whose placements ``rules.param_spec`` resolves
from the plane's logical axes (``plane_logical_axes``, derived from its
base weight's). ``plan_deploy_sharding`` runs the same resolution over
``models.model.param_specs`` shapes only, on a devices-free
``VirtualMesh``, and returns the reference's report key for key.

Also the parameter bridge of the port:

  * ``params_from_jax(tree)`` turns the JAX params tree, already converted
    to numpy arrays by the caller (the port never imports JAX), into torch
    tensors of the same structure;
  * ``init_params(cfg, generator, device)`` initialises every family
    natively (the card has no JAX): the JAX initialiser's tree and
    distributions — N(0, 1/d_in) weights (the MLA projections and the f32
    router too), zero biases, unit norms (layernorms with a zero bias),
    N(0, 0.02^2) embeddings (and the ViT's cls token and positions, in
    f32); for mamba2 N(0, 0.2^2) conv weights, zero conv bias and dt bias,
    ``A_log = log(linspace(1, 16, H))`` and unit skip gains; for the expert
    banks U(-1/sqrt(d), 1/sqrt(d)) — drawn from a ``torch.Generator``, equal
    in law, not in bits. The hybrid tree stacks its mamba blocks over
    (super-block, layer) and holds one unstacked shared attention+MLP
    block; the encdec tree stacks encoder and decoder blocks apart.

A stacked weight of more than ``SLAB_ELEMS`` elements is drawn one layer
(one (super-block, layer) slice for hybrid) at a time, as the expert
banks are a slab of experts at a time: the f32 temporaries of a whole
stacked deepseek-67b MLP weight would be 23 GB each, of zamba2-7b's
``in_proj`` stack 11 GB. Smaller tensors keep one draw.
``quantize_plane`` quantizes every stacked weight a layer at a time.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng, quant
from repro_torch.core.faults import FaultSpec, stuck_bit_plane
from repro_torch.core.sac import Policy, get_policy
from repro_torch.distributed.sharding import (ShardingRules, VirtualMesh,
                                              mesh_axis_sizes, placements,
                                              tp_axis)

_KEY_ROLE = {
    "q": "attn_qkv", "k": "attn_qkv", "v": "attn_qkv", "o": "attn_out",
    "dq": "attn_qkv", "uq": "attn_qkv", "dkv": "attn_qkv",
    "uk": "attn_qkv", "uv": "attn_qkv",
    "gate": "mlp_in", "up": "mlp_in", "down": "mlp_out",
    "patch": "mlp_in",
    "in_proj": "ssm_in", "out_proj": "ssm_out",
    "router": "router", "head": "head",
}
_EXPERT_BANKS = ("w_gate", "w_up", "w_down")
# elements of one f32 slab: the bank quantizer and the expert product
# convert an int8 or bf16 bank to f32 a slab of experts at a time, and
# init_params draws a stacked dense weight above it a layer at a time
SLAB_ELEMS = 1 << 27


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def _role_for(name: Optional[str], parent: Optional[str]) -> Optional[str]:
    role = _KEY_ROLE.get(name)
    if parent == "cross" and role in ("attn_qkv", "attn_out"):
        return "cross_qkv" if role == "attn_qkv" else "cross_out"
    return role


def guard_segments_of(guard: Any) -> int:
    """Checksum segment count of a guard flag or spec (True: 1)."""
    return int(getattr(guard, "segments", 1) or 1)


def pick_segments(n_cols: int, requested: int) -> int:
    """Largest divisor of the plane's output width at most the requested
    G (equal-width segments)."""
    g = max(1, min(int(requested), n_cols))
    while n_cols % g != 0:
        g -= 1
    return g


def checksum_plane(wq: torch.Tensor, segments: int = 1) -> torch.Tensor:
    """ABFT checksum of a clean int plane: the int32 sum over the output
    axis ``(..., K)``, or over G equal column groups ``(..., K, G)``."""
    w32 = wq.to(torch.int32)
    if segments <= 1:
        return w32.sum(dim=-1, dtype=torch.int32)
    n = wq.shape[-1]
    g = pick_segments(n, segments)
    return w32.reshape(wq.shape[:-1] + (g, n // g)).sum(dim=-1,
                                                        dtype=torch.int32)


def stuck_plane(wq: torch.Tensor, bits: int, fault: FaultSpec,
                key: prng.Key) -> torch.Tensor:
    """``stuck_bit_plane`` of a whole (stacked) plane under one key, drawn
    a layer slice at a time (each slice's flat offset into the draw), so
    the int64 Threefry temporaries are those of one slice: bit for bit the
    whole-plane draw."""
    k, n = wq.shape[-2:]
    if wq.ndim == 2:
        return stuck_bit_plane(wq, bits, fault.stuck_rate, key)
    flat = wq.reshape(-1, k, n)
    out = torch.empty_like(flat)
    for i in range(flat.shape[0]):
        out[i] = stuck_bit_plane(flat[i], bits, fault.stuck_rate, key,
                                 start=i * k * n)
    return out.reshape(wq.shape)


def quantize_plane(w: torch.Tensor, bits: int, reduce_axes: int):
    """Abs-max symmetric quantization over the trailing ``reduce_axes`` axes,
    one scale per leading slice (the scale keeps w's dtype). A tensor with
    leading slices is quantized one slice at a time: the numbers of one
    whole-tensor call, bit for bit (each slice has its own scale), with
    f32 temporaries of one slice."""
    lead = w.shape[:w.ndim - reduce_axes]
    if lead:
        flat = w.reshape((-1,) + w.shape[w.ndim - reduce_axes:])
        wq = torch.empty(flat.shape, dtype=quant.storage_dtype(bits),
                         device=w.device)
        ws = torch.empty((flat.shape[0],), dtype=w.dtype, device=w.device)
        for i in range(flat.shape[0]):
            wq[i], ws[i] = quantize_plane(flat[i], bits, reduce_axes)
        return wq.reshape(w.shape), ws.reshape(lead)
    axes = tuple(range(w.ndim - reduce_axes, w.ndim))
    ws = quant.abs_max_scale(w, bits, axis=axes)
    wq = quant.quantize(w.to(torch.float32), ws, bits).to(quant.storage_dtype(bits))
    return wq, ws.reshape(w.shape[:w.ndim - reduce_axes])


def quantize_bank(bank: torch.Tensor, bits: int):
    """``quantize_plane(bank.to(float32), bits, reduce_axes=3)`` of a
    stacked expert bank (L, E, d_in, d_out), bit for bit, converting one
    slab of experts to f32 at a time (the whole f32 bank of a deepseek-v2
    layer is 5 GB)."""
    lead, (e, d_in, d_out) = bank.shape[:-3], bank.shape[-3:]
    flat = bank.reshape(-1, e, d_in, d_out)
    step = max(1, SLAB_ELEMS // (d_in * d_out))
    wq = torch.empty(flat.shape, dtype=quant.storage_dtype(bits),
                     device=bank.device)
    ws = torch.empty((flat.shape[0],), dtype=torch.float32,
                     device=bank.device)
    for i in range(flat.shape[0]):
        ws[i] = quant.abs_max_scale(torch.stack(
            [flat[i, j:j + step].to(torch.float32).abs().amax()
             for j in range(0, e, step)]), bits)
        for j in range(0, e, step):
            wq[i, j:j + step] = quant.quantize(
                flat[i, j:j + step].to(torch.float32), ws[i], bits)
    return wq.reshape(bank.shape), ws.reshape(lead)


def plane_logical_axes(names, plane: str,
                       segmented: bool = False) -> Optional[tuple]:
    """Logical-axis names of a deployed plane, derived from its base
    weight's: ``wq``/``_q`` keep the weight's own; ``ws`` drops the
    trailing 2 (dense) and ``_s`` the trailing 3 (expert bank); ``wc``
    drops the output-column axis (a segmented checksum keeps a trailing
    unsharded segment dim)."""
    if names is None:
        return None
    names = tuple(names)
    if plane in ("wq", "_q"):
        return names
    if plane == "ws":
        return names[:-2]
    if plane == "_s":
        return names[:-3]
    if plane == "wc":
        return names[:-1] + ((None,) if segmented else ())
    raise ValueError(plane)


def deploy(cfg: ModelConfig, params: Any,
           policy: Optional[Policy] = None,
           fault: Optional[FaultSpec] = None, guard: Any = False,
           rules: Optional[ShardingRules] = None,
           param_axes: Any = None) -> Any:
    """A new params tree with the pre-quantized planes attached (the f32
    ``w`` stays, as in the reference). ``guard`` (True or a spec with
    ``segments``) adds the checksum ``wc<bits>`` of the clean plane;
    ``fault`` with ``stuck_rate > 0`` then masks each dense plane under
    ``fold_in(PRNGKey(fault.seed), i)``, ``i`` the plane's index in the
    walk, which visits every dict's keys in sorted order (the order of
    the reference's stacked-layer trees).

    ``rules`` over a live ``DeviceMesh`` places every plane as a DTensor
    (each rank keeps its shard of the plane it built whole);
    ``param_axes`` is the logical-axes tree of ``params``
    (``models.model.param_specs(cfg)[1]``), derived when omitted."""
    if policy is None:
        policy = get_policy(cfg.cim.policy)
    if policy is None:
        return params
    dtype = dtype_of(cfg)
    segments = guard_segments_of(guard)
    fault_key = (prng.PRNGKey(fault.seed)
                 if fault is not None and fault.stuck_rate > 0.0 else None)
    plane_idx = [0]
    if rules is not None and param_axes is None:
        from repro_torch.models.model import param_specs  # models -> core
        param_axes = param_specs(cfg)[1]
    live = rules is not None and not isinstance(rules.mesh, VirtualMesh)

    def place(x, base_names, plane):
        if not live:
            return x
        names = plane_logical_axes(base_names, plane, segmented=segments > 1)
        if names is None:
            return x
        from torch.distributed.tensor import distribute_tensor
        spec = rules.param_spec(names, tuple(x.shape))
        return distribute_tensor(x, rules.mesh, placements(spec, rules.mesh),
                                 src_data_rank=None)

    def walk(node, axes, name, parent):
        if not isinstance(node, dict):
            return node
        axes = axes if isinstance(axes, dict) else {}
        if "w" in node and not isinstance(node["w"], dict):
            role = _role_for(name, parent)
            spec = policy.spec_for_role(role) if role is not None else None
            if spec is None:
                return dict(node)
            bits = spec.w_bits
            wq, ws = quantize_plane(node["w"].to(dtype), bits, reduce_axes=2)
            extra = {f"ws{bits}": ws}
            if guard:
                extra[f"wc{bits}"] = checksum_plane(wq, segments)
            if fault_key is not None:
                wq = stuck_plane(wq, bits, fault,
                                 prng.fold_in(fault_key, plane_idx[0]))
                plane_idx[0] += 1
            wn = axes.get("w")
            extra = {k: place(v, wn, k[:2]) for k, v in extra.items()}
            return dict(node, **{f"wq{bits}": place(wq, wn, "wq")}, **extra)
        done = {k: walk(node[k], axes.get(k), k, name) for k in sorted(node)}
        out = {k: done[k] for k in node}
        spec = (policy.spec_for_role("moe_expert")
                if any(b in node for b in _EXPERT_BANKS) else None)
        if spec is not None:
            for b in _EXPERT_BANKS:
                if b in node:
                    wq, ws = quantize_bank(node[b], spec.w_bits)
                    out[f"{b}_q{spec.w_bits}"] = place(wq, axes.get(b), "_q")
                    out[f"{b}_s{spec.w_bits}"] = place(ws, axes.get(b), "_s")
        return out

    return walk(params, param_axes, None, None)


def plan_deploy_sharding(cfg: ModelConfig, rules: ShardingRules,
                         policy: Optional[Policy] = None,
                         guard: Any = False) -> dict:
    """The tensor-parallel sharding of a config's deployed planes, from
    ``param_specs`` shapes only (``rules.mesh`` may be a ``VirtualMesh``):
    the same role resolution and ``plane_logical_axes`` derivation as
    ``deploy(rules=)``. Per-plane entries (path, plane key, shape, axes,
    spec, whether the model axis splits it, shard degree, bytes in all
    and per device) and the aggregate the reference reports: every
    CIM-routed plane resolved, and some split over the model axis."""
    from repro_torch.models.model import param_specs   # models -> core
    if policy is None:
        policy = get_policy(cfg.cim.policy)
    if policy is None:
        raise ValueError(
            f"config {cfg.name} has no SAC policy: nothing to deploy")
    segments = guard_segments_of(guard)
    pspecs, paxes = param_specs(cfg)
    tp = tp_axis(rules.mesh)
    mesh_sizes = mesh_axis_sizes(rules.mesh)
    entries = []

    def record(path, plane_key, base_names, plane, shape, itemsize):
        names = plane_logical_axes(base_names, plane, segmented=segments > 1)
        spec = rules.param_spec(names, shape) if names is not None else None
        used = []
        for a in (spec or ()):
            if a is not None:
                used.extend([a] if isinstance(a, str) else list(a))
        degree = 1
        for a in used:
            degree *= mesh_sizes[a]
        total = itemsize * int(np.prod(shape, dtype=np.int64))
        entries.append({
            "path": path, "plane": plane_key,
            "shape": list(shape),
            "logical_axes": list(names) if names is not None else None,
            "spec": [list(a) if isinstance(a, tuple) else a
                     for a in (spec or ())],
            "tp_sharded": tp is not None and tp in used,
            "shard_degree": degree,
            "bytes": total,
            "bytes_per_device": total // degree,
        })

    def walk(node, axes, name, parent, path):
        if not isinstance(node, dict):
            return
        axes = axes if isinstance(axes, dict) else {}
        if "w" in node and not isinstance(node["w"], dict):
            role = _role_for(name, parent)
            spec = policy.spec_for_role(role) if role is not None else None
            if spec is None:
                return
            shape, bits = tuple(node["w"].shape), spec.w_bits
            wn = axes.get("w")
            record(path, f"wq{bits}", wn, "wq", shape,
                   quant.storage_dtype(bits).itemsize)
            record(path, f"ws{bits}", wn, "ws", shape[:-2],
                   dtype_of(cfg).itemsize)
            if guard:
                wc = (shape[:-1] + (pick_segments(shape[-1], segments),)
                      if segments > 1 else shape[:-1])
                record(path, f"wc{bits}", wn, "wc", wc, 4)
            return
        for k in sorted(node):      # the reference's (flattened) order
            walk(node[k], axes.get(k), k, name, f"{path}/{k}" if path else k)
        if any(b in node for b in _EXPERT_BANKS):
            espec = policy.spec_for_role("moe_expert")
            if espec is not None:
                for b in _EXPERT_BANKS:
                    if b in node:
                        bshape = tuple(node[b].shape)
                        p = f"{path}/{b}" if path else b
                        record(p, f"{b}_q{espec.w_bits}", axes.get(b), "_q",
                               bshape,
                               quant.storage_dtype(espec.w_bits).itemsize)
                        record(p, f"{b}_s{espec.w_bits}", axes.get(b), "_s",
                               bshape[:-3], 4)

    walk(pspecs, paxes, None, None, "")
    weight_planes = [e for e in entries if e["plane"].startswith("wq")
                     or "_q" in e["plane"]]
    total = sum(e["bytes"] for e in weight_planes)
    sharded = [e for e in weight_planes if e["shard_degree"] > 1]
    tp_planes = [e for e in weight_planes if e["tp_sharded"]]
    per_dev = sum(e["bytes_per_device"] for e in weight_planes)
    ok = (len(weight_planes) > 0
          and all(e["logical_axes"] is not None for e in entries)
          and (tp is None or len(tp_planes) > 0))
    n = len(weight_planes)
    return {
        "config": cfg.name,
        "mesh": mesh_sizes,
        "tp_axis": tp,
        "segments": segments,
        "planes": len(entries),
        "weight_planes": n,
        "tp_sharded_planes": len(tp_planes),
        "sharded_frac": len(sharded) / n if n else 0.0,
        "tp_sharded_frac": len(tp_planes) / n if n else 0.0,
        "int8_bytes_total": total,
        "int8_bytes_per_device": per_dev,
        "ok": bool(ok),
        "entries": entries,
    }


_PLANE_KEY = re.compile(r"(^wq|_q)\d+$")


def plane_summary(params: Any) -> dict:
    """Count deployed planes and their int8 vs f32 footprint (bytes)."""
    n = int8_bytes = f32_bytes = 0

    def walk(node):
        nonlocal n, int8_bytes, f32_bytes
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif isinstance(leaf, torch.Tensor) and _PLANE_KEY.search(key):
                n += 1
                int8_bytes += leaf.numel() * leaf.element_size()
                f32_bytes += leaf.numel() * 4

    walk(params)
    return {"planes": n, "int8_bytes": int8_bytes, "f32_bytes": f32_bytes}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: no numpy->torch route
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree: Any, device="cpu") -> Any:
    """The JAX params tree (leaves already numpy arrays) as torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_torch(tree).to(device)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Any:
    """Random params of any family, laid out like the reference's tree."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    L, d = cfg.n_layers, cfg.d_model

    def normal(*shape, std, dtype=dt):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def dense(d_in, d_out, bias=False, dtype=dt, lead=(L,)):
        n = int(np.prod(lead))
        if n * d_in * d_out <= SLAB_ELEMS:
            w = normal(*lead, d_in, d_out, std=d_in ** -0.5, dtype=dtype)
        else:                   # a layer at a time (module doc)
            w = torch.empty(lead + (d_in, d_out), dtype=dtype,
                            device=dev)
            flat = w.view(n, d_in, d_out)
            for i in range(n):
                flat[i] = normal(d_in, d_out, std=d_in ** -0.5, dtype=dtype)
        p = {"w": w}
        if bias:
            p["b"] = full(lead + (d_out,), 0.0)
        return p

    def ones(n, lead=(L,)):
        return {"g": full(lead + (n,), 1.0)}

    def ln(lead=(L,)):
        return {"g": full(lead + (d,), 1.0),
                "b": full(lead + (d,), 0.0)}

    def gqa(lead=(L,)):
        nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        return {"q": dense(d, nh * hd, cfg.qkv_bias, lead=lead),
                "k": dense(d, kv * hd, cfg.qkv_bias, lead=lead),
                "v": dense(d, kv * hd, cfg.qkv_bias, lead=lead),
                "o": dense(nh * hd, d, lead=lead)}

    def swiglu(lead=(L,)):
        f = cfg.d_ff
        return {"gate": dense(d, f, lead=lead), "up": dense(d, f, lead=lead),
                "down": dense(f, d, lead=lead)}

    def gelu(lead=(L,)):
        f = cfg.d_ff
        return {"up": dense(d, f, True, lead=lead),
                "down": dense(f, d, True, lead=lead)}

    def mamba(lead=(L,)):
        s = cfg.ssm
        di = s.expand * d
        h = di // s.headdim
        conv_dim = di + 2 * s.ngroups * s.d_state
        f32 = torch.float32
        a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                         device=dev))
        return {
            "mamba": {
                "in_proj": dense(d, 2 * di + 2 * s.ngroups * s.d_state + h,
                                 lead=lead),
                "out_proj": dense(di, d, lead=lead),
                "conv_w": normal(*lead, s.conv_width, conv_dim, std=0.2),
                "conv_b": full(lead + (conv_dim,), 0.0),
                "A_log": a_log.expand(lead + (h,)).clone(),
                "D": full(lead + (h,), 1.0, f32),
                "dt_bias": full(lead + (h,), 0.0, f32),
                "norm_g": full(lead + (di,), 1.0),
            },
            "n": ones(d, lead),
        }

    def top(**trees):
        return {"embed": {"e": normal(cfg.vocab_size, d, std=0.02)},
                "final_norm": {"g": full((d,), 1.0)}, **trees}

    if cfg.family == "vit":
        return _init_vit(cfg, normal, full)
    if cfg.family == "hybrid":
        return top(mamba_blocks=mamba((L // cfg.attn_period,
                                       cfg.attn_period - 1)),
                   shared_attn={"attn": gqa(()), "mlp": swiglu(()),
                                "n1": ones(d, ()), "n2": ones(d, ())})
    if cfg.family == "encdec":
        enc = (cfg.n_enc_layers,)
        return top(enc_blocks={"attn": gqa(enc), "mlp": gelu(enc),
                               "n1": ln(enc), "n2": ln(enc)},
                   dec_blocks={"attn": gqa(), "cross": {
                       "q": dense(d, cfg.n_heads * cfg.hd),
                       "k": dense(d, cfg.n_kv_heads * cfg.hd),
                       "v": dense(d, cfg.n_kv_heads * cfg.hd),
                       "o": dense(cfg.n_heads * cfg.hd, d)},
                       "mlp": gelu(), "n1": ln(), "n2": ln(), "n3": ln()},
                   enc_norm=ln(()))
    if cfg.family == "ssm":
        blocks = mamba()
    elif cfg.family == "moe":
        a, m, f, h = cfg.mla, cfg.moe, cfg.d_ff, cfg.n_heads
        lim = d ** -0.5

        def bank(d_in, d_out):
            # one layer's slab of experts at a time: the f32 draw of a
            # whole deepseek-v2 bank is 5 GB per layer
            w = torch.empty((L, m.n_experts, d_in, d_out), dtype=dt,
                            device=dev)
            step = max(1, SLAB_ELEMS // (d_in * d_out))
            for i in range(L):
                for j in range(0, m.n_experts, step):
                    n = min(step, m.n_experts - j)
                    u = torch.rand((n, d_in, d_out), generator=generator,
                                   device=dev, dtype=torch.float32)
                    w[i, j:j + n] = (u * (2 * lim) - lim).to(dt)
            return w

        blocks = {
            "attn": gqa() if a is None else {
                "dq": dense(d, a.q_lora),
                "uq": dense(a.q_lora, h * (a.nope_head_dim + a.rope_head_dim)),
                "dkv": dense(d, a.kv_lora + a.rope_head_dim),
                "uk": dense(a.kv_lora, h * a.nope_head_dim),
                "uv": dense(a.kv_lora, h * a.v_head_dim),
                "o": dense(h * a.v_head_dim, d)},
            "moe": {"router": dense(d, m.n_experts, dtype=torch.float32),
                    "w_gate": bank(d, f), "w_up": bank(d, f),
                    "w_down": bank(f, d)},
            "n1": ones(d), "n2": ones(d),
        }
        if m.n_shared:
            fs = m.n_shared * f
            blocks["moe"]["shared"] = {"gate": dense(d, fs),
                                       "up": dense(d, fs),
                                       "down": dense(fs, d)}
    elif cfg.family in ("dense", "vlm"):
        blocks = {"attn": gqa(), "mlp": swiglu(), "n1": ones(d),
                  "n2": ones(d)}
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return top(blocks=blocks)


def init_axes(cfg: ModelConfig) -> Any:
    """The logical-axes tree of ``init_params(cfg)``: a tuple of axis
    names (or None) for every leaf, the tree the reference's initialisers
    return beside the parameters, with one leading 'layers' name per
    stacking (two on the hybrid family's mamba blocks)."""
    E = "embed"

    def stack(tree, n=1):
        if isinstance(tree, dict):
            return {k: stack(v, n) for k, v in tree.items()}
        return ("layers",) * n + tuple(tree)

    def dense(din, dout, bias=False):
        a = {"w": (din, dout)}
        if bias:
            a["b"] = (dout,)
        return a

    def ln():
        return {"g": (E,), "b": (E,)}

    def gqa(bias):
        return {"q": dense(E, "heads", bias), "k": dense(E, "kv_heads", bias),
                "v": dense(E, "kv_heads", bias), "o": dense("heads", E)}

    def swiglu():
        return {"gate": dense(E, "mlp"), "up": dense(E, "mlp"),
                "down": dense("mlp", E)}

    def gelu():
        return {"up": dense(E, "mlp", True), "down": dense("mlp", E, True)}

    mamba = {"mamba": {"in_proj": dense(E, "mlp"), "out_proj": dense("mlp", E),
                       "conv_w": ("conv", "mlp"), "conv_b": ("mlp",),
                       "A_log": ("heads",), "D": ("heads",),
                       "dt_bias": ("heads",), "norm_g": ("mlp",)},
             "n": {"g": (E,)}}
    dense_block = {"attn": gqa(cfg.qkv_bias), "mlp": swiglu(),
                   "n1": {"g": (E,)}, "n2": {"g": (E,)}}
    if cfg.family == "vit":
        return {"patch": dense("patch", E, True), "cls": (None, None, E),
                "pos": (None, None, E),
                "blocks": stack({"attn": gqa(cfg.qkv_bias), "mlp": gelu(),
                                 "n1": ln(), "n2": ln()}),
                "head_norm": ln(), "head": dense(E, "classes", True)}
    top = {}
    if cfg.vocab_size:
        top["embed"] = {"e": ("vocab", E)}
    top["final_norm"] = {"g": (E,)}
    if cfg.family in ("dense", "vlm"):
        top["blocks"] = stack(dense_block)
    elif cfg.family == "ssm":
        top["blocks"] = stack(mamba)
    elif cfg.family == "moe":
        attn = (gqa(cfg.qkv_bias) if cfg.mla is None else
                {"dq": dense(E, "state"), "uq": dense("state", "heads"),
                 "dkv": dense(E, "state"), "uk": dense("state", "heads"),
                 "uv": dense("state", "heads"), "o": dense("heads", E)})
        moe = {"router": dense(E, None),
               "w_gate": ("experts", E, "mlp"), "w_up": ("experts", E, "mlp"),
               "w_down": ("experts", "mlp", E)}
        if cfg.moe.n_shared:
            moe["shared"] = swiglu()
        top["blocks"] = stack({"attn": attn, "moe": moe, "n1": {"g": (E,)},
                               "n2": {"g": (E,)}})
    elif cfg.family == "hybrid":
        top["mamba_blocks"] = stack(mamba, 2)
        top["shared_attn"] = dense_block
    elif cfg.family == "encdec":
        cross = {"q": dense(E, "heads"), "k": dense(E, "kv_heads"),
                 "v": dense(E, "kv_heads"), "o": dense("heads", E)}
        top["enc_blocks"] = stack({"attn": gqa(cfg.qkv_bias), "mlp": gelu(),
                                   "n1": ln(), "n2": ln()})
        top["dec_blocks"] = stack({"attn": gqa(cfg.qkv_bias), "cross": cross,
                                   "mlp": gelu(), "n1": ln(), "n2": ln(),
                                   "n3": ln()})
        top["enc_norm"] = ln()
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return top


def _init_vit(cfg: ModelConfig, normal, full) -> Any:
    """ViT params in f32 (``init_vit``'s tree): the patch embedding, cls
    token and positions, stacked pre-norm blocks (non-causal GQA and a
    GELU MLP with biases, two layernorms), the head norm and head."""
    f32 = torch.float32
    L, d, f, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.hd
    patch_dim = cfg.patch_size ** 2 * 3
    n_patches = (cfg.image_size // cfg.patch_size) ** 2

    def dense(d_in, d_out, bias, lead=(L,)):
        p = {"w": normal(*lead, d_in, d_out, std=d_in ** -0.5, dtype=f32)}
        if bias:
            p["b"] = full(lead + (d_out,), 0.0, f32)
        return p

    def ln(lead=(L,)):
        return {"g": full(lead + (d,), 1.0, f32),
                "b": full(lead + (d,), 0.0, f32)}

    nh, kv = cfg.n_heads, cfg.n_kv_heads
    return {
        "patch": dense(patch_dim, d, True, ()),
        "cls": normal(1, 1, d, std=0.02, dtype=f32),
        "pos": normal(1, n_patches + 1, d, std=0.02, dtype=f32),
        "blocks": {
            "attn": {"q": dense(d, nh * hd, cfg.qkv_bias),
                     "k": dense(d, kv * hd, cfg.qkv_bias),
                     "v": dense(d, kv * hd, cfg.qkv_bias),
                     "o": dense(nh * hd, d, False)},
            "mlp": {"up": dense(d, f, True), "down": dense(f, d, True)},
            "n1": ln(), "n2": ln()},
        "head_norm": ln(()),
        "head": dense(d, cfg.n_classes, True, ()),
    }
