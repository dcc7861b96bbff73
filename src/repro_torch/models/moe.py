"""Mixture-of-experts block: top-k router, capacity dispatch, expert SwiGLU.

Twin of ``src/repro/models/moe.py``. The router is digital f32 (role
``router``). Tokens dispatch in ``G`` groups (``dispatch_groups``: 1
without rules; under installed rules the data-parallel degree once a
group holds at least 256 tokens, which reads only the mesh's shape and
so holds on one process over a ``VirtualMesh`` too), each group with its
own capacity ``C``: ``tl * top_k`` in serving (dropless: a token's
experts never depend on how many tokens share the forward) and the
capacity-factor buffer otherwise, ``tl`` the group's tokens. The experts
run as batched products over the whole ``(G, E, C, d)`` dispatch buffer,
which holds every token of the forward, pad positions and idle decode
slots included, as in the reference: its shape sets the activation scale
and the noise draw.

On a live mesh (``ctx.tp``, ``models/parallel.py``) the block runs
expert-parallel, as the reference's shard_map path (``_smap_dispatch``,
``_smap_combine``): a rank holds its data group's tokens (when the
groups are the data ranks; with one group the tokens are all-gathered
over the data axes first) and, where ``model`` divides the experts, only
``E / model`` of them (their planes' block of ``deploy(rules=)``). It
scatters only its own experts' rows (no dispatch collective), takes the
bank's abs-max scale as a max all-reduce over every rank holding a part
of the buffer (exact), draws its part's slice of the whole ``(G, E, C,
n)`` noise (``prng.normal(start=)``, the counter of the one-device draw)
and combines by a masked local gather and one sum all-reduce over
``model``. The reference's psum sums each rank's summed outputs (another
float order than one device's); the port all-reduces the weighted output
of each (token, k) assignment, which one rank holds and the others hold
as exact zeros, and then adds a token's k outputs in k order, as one
device does: bit-equal to the grouped one-process forward, for top_k
times the bytes of the psum.

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

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import output_noise_std_int
from repro_torch.core.deploy import SLAB_ELEMS
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import get_rules, mesh_axis_sizes, shard
from repro_torch.models.layers import Ctx, Params, dense, swiglu
from repro_torch.models.parallel import A73

_NOISE_SLAB = 1 << 25      # noise elements drawn at once (int64 temporaries)
# the dispatch of the latest moe_block call in this process: its groups and
# the part of the (G, E, C, d) buffer this rank held (``gathered``: one
# group over the all-gathered batch)
last_dispatch: dict = {}
_BANK_AXES = {"w_gate": ("experts", "embed", "mlp"),
              "w_up": ("experts", "embed", "mlp"),
              "w_down": ("experts", "mlp", "embed")}


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


def dispatch_groups(t: int, top_k: int) -> int:
    """The reference's dispatch groups for ``t`` tokens: under installed
    rules the data-parallel degree when it divides ``t`` and a group holds
    at least ``max(256, top_k)`` tokens, else 1 (a shape-only reading of
    the mesh: a ``VirtualMesh`` groups alike)."""
    rules = get_rules()
    if rules is None:
        return 1
    sizes = mesh_axis_sizes(rules.mesh)
    groups = 1
    for a in col.axes_of(rules.activation.get("batch")):
        groups *= sizes[a]
    if t % groups or t // groups < max(256, top_k):
        return 1
    return groups


@dataclasses.dataclass(frozen=True)
class _Place:
    """Where this rank's part of the ``(G, E, C, d)`` dispatch buffer lies:
    groups ``[g0, g0 + g_local)`` of ``groups`` and experts ``[e0, e0 +
    e_local)`` of ``n_experts``. ``axes()`` names the mesh axes the other
    parts lie on (the abs-max runs over them; the combine's sum over the
    experts' only)."""
    groups: int
    g0: int
    g_local: int
    n_experts: int
    e0: int
    e_local: int
    tp: Optional[Any] = None

    def axes(self, experts_only: bool = False) -> tuple:
        if self.tp is None:
            return ()
        out = ()
        if self.g_local < self.groups and not experts_only:
            out += col.axes_of(self.tp.batch)
        if self.e_local < self.n_experts:
            out += ("model",)
        return out


def moe_block(ctx: Ctx, p: Params, x: torch.Tensor,
              dropless: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) (this rank's rows on a live mesh)."""
    m = ctx.cfg.moe
    tp = ctx.tp
    b, s, d = x.shape
    t = (tp.batch_size if tp is not None else b) * s
    groups = dispatch_groups(t, m.top_k)
    tl = t // groups
    xs_all, gathered = x, False
    if tp is not None and tp.batch is not None and groups == 1:
        # one group over the whole batch: every rank takes all its tokens
        xs_all, gathered = col.all_gather(x, 0, tp.batch, tp.lm), True
    g_local = xs_all.shape[0] * s // tl
    g0 = (tp.lm.index(tp.batch) * g_local
          if tp is not None and tp.batch is not None and not gathered else 0)
    e_local, e0 = m.n_experts, 0
    if tp is not None and tp.model > 1 and m.n_experts % tp.model == 0:
        e_local = m.n_experts // tp.model
        e0 = tp.model_index() * e_local
    place = _Place(groups, g0, g_local, m.n_experts, e0, e_local, tp)
    last_dispatch.update(groups=groups, g_local=g_local, e_local=e_local,
                         gathered=gathered)
    xg = shard(xs_all.reshape(g_local, tl, d), "batch", None, "embed")

    gate_vals, expert_idx = route(ctx, p, xg.reshape(-1, d), m.top_k)
    if dropless:
        capacity = tl * m.top_k
    else:
        capacity = max(int(tl * m.top_k / m.n_experts * m.capacity_factor),
                       m.top_k)
    tok = torch.arange(tl, device=x.device).repeat_interleave(m.top_k)
    flat_e = expert_idx.reshape(g_local, tl * m.top_k)
    # scatter: (G_l, E_l, C, d), each group's own experts' rows (the
    # expert-parallel dispatch: no collective); kept assignments land on
    # distinct slots, the others add zeros at (0, 0)
    buf = torch.zeros((g_local, e_local, capacity, d), dtype=x.dtype,
                      device=x.device)
    sel = []
    for j in range(g_local):
        pos, keep = _dispatch_indices(flat_e[j], m.n_experts, capacity)
        e_rel = flat_e[j] - e0
        ok = keep & (e_rel >= 0) & (e_rel < e_local)
        e_idx, pos_idx = torch.where(ok, e_rel, 0), torch.where(ok, pos, 0)
        upd = xg[j][tok] * ok[:, None].to(x.dtype)
        buf[j].index_put_((e_idx, pos_idx), upd, accumulate=True)
        sel.append((e_idx, pos_idx, ok))
    buf = shard(buf, "batch", "experts", None, "embed")

    g = _expert_dense(ctx, buf, p, "w_gate", place)
    u = _expert_dense(ctx, buf, p, "w_up", place)
    h = shard(silu(g) * u, "batch", "experts", None, "mlp")
    out = shard(_expert_dense(ctx, h, p, "w_down", place),
                "batch", "experts", None, "embed")

    # combine: each token's k outputs added in the model dtype, in k order;
    # on a mesh each assignment's output lies on the one rank holding its
    # expert (the others hold exact zeros), so one sum over 'model' of the
    # weighted outputs, then the k-order sum: the one-device order
    gates = gate_vals.reshape(g_local, tl * m.top_k)
    y_assign = torch.stack([
        out[j][e_idx, pos_idx] * (gates[j] * ok).to(x.dtype)[:, None]
        for j, (e_idx, pos_idx, ok) in enumerate(sel)])
    if place.axes(experts_only=True):
        y_assign = col.all_reduce(y_assign, "model", tp.lm)
    y_assign = y_assign.reshape(g_local * tl, m.top_k, d)
    y = torch.zeros((g_local * tl, d), dtype=x.dtype, device=x.device)
    for k in range(m.top_k):
        y = y + y_assign[:, k]
    if gathered:
        y = col.block(y.reshape(-1, s, d), 0, tp.batch, tp.lm)
    y = y.reshape(b, s, d)
    if m.n_shared:
        y = y + swiglu(ctx, p["shared"], x)
    return y


def _bank_block(w: torch.Tensor, shape, names, place: _Place) -> torch.Tensor:
    """Experts ``[e0, e0 + e_local)`` of a (E, a, b) bank or plane, whole
    over a and b: ``w`` is the whole bank or this rank's block placed by
    ``deploy(rules=)``."""
    if place.tp is None:
        return w
    from repro_torch.models.parallel import param_block
    tp = place.tp
    pspec = tp.rules.param_spec(names, tuple(shape))
    want = ("model" if place.e_local < place.n_experts else None, None,
            None)
    return param_block(w, shape, pspec, want, tp.lm)


def _expert_dense(ctx: Ctx, x: torch.Tensor, p: Params, name: str,
                  place: _Place) -> torch.Tensor:
    """(G_l, E_l, C, a) x bank (E, a, b) -> (G_l, E_l, C, b) through the
    CIM model (see module doc); off mode is a batched product in x's
    dtype. ``place``: the part of the ``(G, E, C, a)`` buffer ``x`` is."""
    w = p[name]
    names = _BANK_AXES[name]
    spec = ctx.spec_for("moe_expert")
    if spec is None:
        wl = _bank_block(w, w.shape, names, place)
        return torch.einsum("geca,eab->gecb", x, wl.to(x.dtype))
    if ctx.mode != "sim" and place.tp is not None:
        raise NotImplementedError(f"{ctx.mode} mode expert banks are "
                                  f"{A73}")
    wq = p.get(f"{name}_q{spec.w_bits}")
    if wq is None:
        raise ValueError(
            "deployed sim-mode expert FFN has no pre-quantized weight "
            f"plane for '{name}' at w_bits={spec.w_bits} — run "
            "core.deploy.deploy() with the serving policy")
    wq = _bank_block(wq, w.shape, names, place)
    ws = p[f"{name}_s{spec.w_bits}"]
    xf = x.to(torch.float32)
    # the whole buffer's abs-max: a max over the ranks holding its parts
    amax = xf.abs().amax()
    if place.axes():
        amax = col.all_reduce(amax, place.axes(), place.tp.lm, "max")
    xs = torch.clamp_min(amax, 1e-8) / quant.qmax(spec.in_bits)
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
        cap = y.shape[2]
        per_e = cap * n
        nstep = max(1, _NOISE_SLAB // per_e)
        # this part's slice of the whole (G, E, C, n) draw
        for gi in range(y.shape[0]):
            base = (place.g0 + gi) * place.n_experts + place.e0
            for j in range(0, e, nstep):
                sl = y[gi, j:j + nstep]
                sl += amp * prng.normal(key, tuple(sl.shape), x.device,
                                        start=(base + j) * per_e)
    return y.to(x.dtype)
