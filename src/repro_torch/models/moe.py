"""Mixture-of-experts block: top-k router, capacity dispatch, expert SwiGLU.

Twin of the single-group path of ``src/repro/models/moe.py`` (one dispatch
group, ``groups = 1``; the expert-parallel shard_map paths belong to the
distribution layer, not ported). The router is digital f32 (role
``router``); the experts run as batched products over the whole
``(1, E, C, d)`` dispatch buffer, with ``C = tl * top_k`` in serving
(dropless: a token's experts never depend on how many tokens share the
forward) and the capacity-factor buffer otherwise. The buffer holds every
token of the forward, pad positions and idle decode slots included, as in
the reference: its shape sets the activation scale and the noise draw.

Sim mode runs each expert bank on its deployed int8 plane
(``core.deploy``): the buffer is quantized against its abs-max, the
integer product is exact in f32 (every partial sum of 6-bit operands over
K <= 5120 stays below 2^24), and the macro's readout error is added
output-side as ``sigma * xs * ws * normal(key, y.shape)``, the
``jax.random.normal`` twin of ``core.prng``. The bank is converted to f32
and the noise drawn a slab of experts at a time, which gives the same
numbers as the whole-bank product and draw.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import output_noise_std_int
from repro_torch.core.deploy import SLAB_ELEMS
from repro_torch.models.layers import Ctx, Params, dense, swiglu

_NOISE_SLAB = 1 << 25      # noise elements drawn at once (int64 temporaries)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def _dispatch_indices(flat_e: torch.Tensor, n_experts: int, capacity: int):
    """Position of each assignment within its expert, and the keep mask
    (``pos < capacity``); assignments keep their order within an expert."""
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    run_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat_e.device,
                               dtype=sorted_e.dtype), right=False)
    pos_sorted = torch.arange(tk, device=flat_e.device) - run_start[sorted_e]
    pos = torch.empty((tk,), dtype=torch.int64, device=flat_e.device)
    pos[order] = pos_sorted
    return pos, pos < capacity


def route(ctx: Ctx, p: Params, x2: torch.Tensor, top_k: int):
    """(T, d) tokens -> (gate values (T, k) f32, expert ids (T, k)): softmax
    of the digital f32 router, top-k (descending, ties to the lower id),
    renormalised."""
    logits = dense(ctx, p["router"], x2.to(torch.float32), "router")
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: ties go to the lower expert id, as in
    # jax.lax.top_k (torch.topk leaves the order of ties open)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :top_k], expert_idx[..., :top_k]
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    return gate_vals, expert_idx


def moe_block(ctx: Ctx, p: Params, x: torch.Tensor,
              dropless: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    m = ctx.cfg.moe
    b, s, d = x.shape
    tl = b * s
    x2 = x.reshape(tl, d)
    gate_vals, expert_idx = route(ctx, p, x2, m.top_k)
    if dropless:
        capacity = tl * m.top_k
    else:
        capacity = max(int(tl * m.top_k / m.n_experts * m.capacity_factor),
                       m.top_k)
    flat_e = expert_idx.reshape(-1)
    pos, keep = _dispatch_indices(flat_e, m.n_experts, capacity)
    tok = torch.arange(tl, device=x.device).repeat_interleave(m.top_k)
    e_idx = torch.where(keep, flat_e, 0)
    pos_idx = torch.where(keep, pos, 0)

    # scatter: (E, C, d); kept assignments land on distinct slots, dropped
    # ones add zeros at (0, 0)
    buf = torch.zeros((m.n_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    upd = x2[tok] * keep[:, None].to(x.dtype)
    buf.index_put_((e_idx, pos_idx), upd, accumulate=True)
    buf = buf[None]                                   # (1, E, C, d)

    g = _expert_dense(ctx, buf, p, "w_gate")
    u = _expert_dense(ctx, buf, p, "w_up")
    out = _expert_dense(ctx, silu(g) * u, p, "w_down")[0]

    # combine: each token's k outputs added in the model dtype, in k order
    w = (gate_vals.reshape(-1) * keep).to(x.dtype)[:, None]
    y_assign = (out[e_idx, pos_idx] * w).reshape(tl, m.top_k, d)
    y = torch.zeros((tl, d), dtype=x.dtype, device=x.device)
    for j in range(m.top_k):
        y = y + y_assign[:, j]
    y = y.reshape(b, s, d)
    if m.n_shared:
        y = y + swiglu(ctx, p["shared"], x)
    return y


def _expert_dense(ctx: Ctx, x: torch.Tensor, p: Params,
                  name: str) -> torch.Tensor:
    """(1, E, C, a) x bank (E, a, b) -> (1, E, C, b) through the CIM model
    (see module doc); off mode is a batched product in x's dtype."""
    w = p[name]
    spec = ctx.spec_for("moe_expert")
    if spec is None:
        return torch.einsum("geca,eab->gecb", x, w.to(x.dtype))
    wq = p.get(f"{name}_q{spec.w_bits}")
    if wq is None:
        raise ValueError(
            "deployed sim-mode expert FFN has no pre-quantized weight "
            f"plane for '{name}' at w_bits={spec.w_bits} — run "
            "core.deploy.deploy() with the serving policy")
    ws = p[f"{name}_s{spec.w_bits}"]
    xf = x.to(torch.float32)
    xs = quant.abs_max_scale(xf, spec.in_bits)
    xq = quant.quantize(xf, xs, spec.in_bits).to(torch.float32)
    e, k_dim, n = wq.shape
    step = max(1, SLAB_ELEMS // (k_dim * n))
    y = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                    device=x.device)
    for j in range(0, e, step):
        y[:, j:j + step] = torch.einsum(
            "geca,eab->gecb", xq[:, j:j + step],
            wq[j:j + step].to(torch.float32))
    y = y * xs * ws
    key = ctx.next_key()
    if key is not None:
        sigma = output_noise_std_int(spec, k_dim)
        amp = sigma * xs * ws
        per_e = y.shape[2] * n
        nstep = max(1, _NOISE_SLAB // per_e)
        for j in range(0, e, nstep):
            sl = y[:, j:j + nstep]
            sl += amp * prng.normal(key, tuple(sl.shape), x.device,
                                    start=j * per_e)
    return y.to(x.dtype)
