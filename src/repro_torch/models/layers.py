"""Building blocks: CIM-aware dense, norms, RoPE, SwiGLU and GELU MLPs,
embeddings, sinusoidal positions.

Twin of ``src/repro/models/layers.py``. Every matmul
goes through ``dense()`` with a *role* (attn_qkv / mlp_in / ...) so the SAC
policy picks the macro operating point per layer. Parameters are plain
dicts of tensors laid out like the JAX tree.

Sim mode reads the deployed int8 planes on both of the reference's
paths: the fused CIM kernel with per-tile Threefry noise
(``cfg.cim.use_kernel=True``) or the behavioural ``core.cim.cim_dense``
with one whole-K ``jax.random.normal`` draw (``use_kernel=False``, the
config default). A weight without a plane is quantized per call, as in
the reference, unless the context says the tree is deployed
(``Ctx.deployed``) or the weight carries a plane of another width: then a
missing plane raises rather than silently bypass the kernel. QAT mode runs ``cim_dense(mode="qat")``: straight-through
fake-quant plus the macro's noise under the call's key, for training.

The robustness fields of ``Ctx`` are the reference's: ``guard`` routes a
deployed sim call whose plane carries a checksum ``wc<bits>`` through
``core.guard.guarded_dense``; ``fault`` and ``drift`` ride into each
call's ``CIMSpec`` (the drift at ``drift_state``, sim mode only);
``fault_rows`` / ``pin_rows`` are (B,) bool row masks (rows disturbed by
``fault.transient_mag`` / rows the engine pinned to the digital path);
``trip_log`` / ``hard_log`` collect the guard's (B,) counts per layer,
which ``models.transformer`` stacks into (L, B) ``guard_trips`` /
``guard_hard``.

The load ladder's fields are the reference's too: ``degrade_levels`` (the
vote count of each level, ``sac.DegradeLadder.votes``) and
``degrade_rows`` ((B,) int levels on the device); in sim mode every CIM
``dense`` outside the guard adds each row's extra noise of its reduced
vote count (``_degrade_noise``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng, quant
from repro_torch.core.cim import CIMSpec, cim_dense, \
    vote_drop_extra_std_int
from repro_torch.core.guard import guarded_dense
from repro_torch.core.sac import Policy, get_policy
from repro_torch.distributed.sharding import shard
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]

_NOT_PORTED = "not ported yet; ROADMAP.md lists it as later work"


@dataclasses.dataclass
class Ctx:
    """Per-apply execution context: CIM mode, SAC policy, key stream.

    ``key`` is a raw Threefry key ``(k0, k1)`` of host ints; ``next_key``
    replays ``jax.random.fold_in(key, counter)`` bit for bit, in the same
    call order as the reference (q, k, v, o, gate, up, down per layer).

    Table mode (``seeds`` set, a ``prng.seed_table`` of the forward's key
    on the device): ``for_layer(i)`` and ``next_key`` hand out rows of the
    table (``prng.SeedRow``) instead of computing keys on the host, so the
    CIM kernels read their seeds from device memory and a CUDA graph of
    the forward replays with the seeds staged before each replay. A layer
    draws at most ``seed_width`` rows; a draw past them raises."""

    cfg: ModelConfig
    mode: str = "off"                 # off | qat | sim
    policy: Optional[Policy] = None
    key: Optional[prng.Key] = None
    counter: int = 0
    prefill_valid: Optional[torch.Tensor] = None  # (B,) int: real tokens of
                                                  # a right-padded prefill
                                                  # chunk (state-carrying
                                                  # blocks skip the pad)
    seeds: Optional[torch.Tensor] = None  # (rows, 2) int32 seed table
    seed_width: int = 0               # table rows a layer may draw
    seed_base: int = 0                # this layer's first row
    seed_fold: Optional[Mapping[int, torch.Tensor]] = None  # data ->
                                       # table of fold_in(row key, data)
                                       # per seed-table row
    deployed: bool = False            # the tree carries its sim planes
    guard: Optional[Any] = None       # core.guard.GuardSpec
    fault: Optional[Any] = None       # core.faults.FaultSpec
    drift: Optional[Any] = None       # core.drift.DriftSpec
    drift_state: Optional[Any] = None  # (step, trim_gain, trim_off)
    fault_rows: Optional[torch.Tensor] = None   # (B,) bool
    pin_rows: Optional[torch.Tensor] = None     # (B,) bool, set per layer
    pin_layers: Optional[torch.Tensor] = None   # (B, L) bool
    trip_log: Optional[list] = None
    hard_log: Optional[list] = None
    guard_trips: Optional[torch.Tensor] = None  # (L, B) int32
    guard_hard: Optional[torch.Tensor] = None   # (L, B) int32
    degrade_levels: tuple = ()        # ladder: vote count per level (index
                                      # 0 None: full votes)
    degrade_rows: Optional[torch.Tensor] = None  # (B,) int ladder level
    degrade_draws: dict = dataclasses.field(default_factory=dict)  # the
                                      # forward's ladder normals, drawn a
                                      # call position at a time
    tp: Optional[Any] = None          # models.parallel.TP of a forward on
                                      # a live mesh

    @classmethod
    def make(cls, cfg: ModelConfig, key: Optional[prng.Key] = None,
             mode: Optional[str] = None, deployed: bool = False,
             guard: Optional[Any] = None,
             fault: Optional[Any] = None) -> "Ctx":
        mode = cfg.cim.mode if mode is None else mode
        if mode not in ("off", "qat", "sim"):
            raise NotImplementedError(f"cim mode {mode!r} is {_NOT_PORTED}")
        policy = get_policy(cfg.cim.policy) if mode != "off" else None
        return cls(cfg=cfg, mode=mode, policy=policy, key=key,
                   deployed=deployed, guard=guard, fault=fault)

    def for_layer(self, i: int) -> "Ctx":
        """The context of layer ``i``: key ``fold_in(key, i)``, as the
        reference's scan body keys it (table mode: rows from ``i *
        seed_width`` on)."""
        if self.seeds is not None:
            if (i + 1) * self.seed_width > self.seeds.shape[0]:
                raise ValueError(f"seed table of {self.seeds.shape[0]} rows "
                                 f"holds no layer {i}")
            return dataclasses.replace(self, counter=0,
                                       seed_base=i * self.seed_width)
        base = self.key if self.key is not None else prng.PRNGKey(0)
        return dataclasses.replace(self, key=prng.fold_in(base, i),
                                   counter=0)

    def next_key(self) -> Optional[prng.Seed]:
        if self.key is None:
            return None
        self.counter += 1
        if self.seeds is not None:
            if self.counter > self.seed_width:
                raise ValueError(f"a layer drew {self.counter} seeds; the "
                                 f"table holds {self.seed_width} a layer")
            return prng.SeedRow(self.seeds, self.seed_base + self.counter - 1,
                                self.seed_fold)
        return prng.fold_in(self.key, self.counter)

    def spec_for(self, role: str) -> Optional[CIMSpec]:
        if self.mode == "off" or self.policy is None:
            return None
        return self.policy.spec_for_role(role)


def dense(ctx: Ctx, p: Params, x: torch.Tensor, role: str) -> torch.Tensor:
    """y = x @ w (+ b), executed per the CIM context and SAC role.

    Sim mode reads the deployed plane ``p["wq<bits>"]``/``p["ws<bits>"]``.
    With ``cim.use_kernel`` it runs the fused activation-quant CIM kernel:
    the activation is quantized in the kernel against the batch-global
    clip scale, the readout noise is drawn in the kernel from this call's
    key. Without it, the behavioural ``cim_dense`` quantizes against the
    same scale and draws its noise from the same key. Every weight in qat
    mode, and in sim a weight of an undeployed tree, goes through
    ``cim_dense`` with the float weight. A sim weight without the plane of
    its width raises when ``ctx.deployed`` is set or when it carries a
    plane of another width (a tree deployed under another policy).

    ``ctx.fault`` rides into the spec; in sim mode ``ctx.drift`` too, with
    ``ctx.drift_state``. With ``ctx.guard`` a sim call on a plane with its
    checksum runs ``core.guard.guarded_dense``; otherwise the load
    ladder's noise (``_degrade_noise``) follows the matmul, before the
    bias. On a live mesh (``ctx.tp``) the column- or row-parallel product
    of ``models.parallel.dense``."""
    if ctx.tp is not None:
        from repro_torch.models import parallel
        return parallel.dense(ctx, p, x, role)
    spec = ctx.spec_for(role)
    if spec is None:
        y = x @ p["w"].to(x.dtype)
    else:
        if ctx.fault is not None:
            spec = dataclasses.replace(spec, fault=ctx.fault)
        dstate = None
        if ctx.drift is not None and ctx.mode == "sim":
            spec = dataclasses.replace(spec, drift=ctx.drift)
            dstate = ctx.drift_state
        k = ctx.next_key()
        xs = _act_scale(ctx, x, spec)
        if (ctx.guard is not None and ctx.mode == "sim"
                and f"wc{spec.w_bits}" in p):
            y = guarded_dense(ctx, p, x, spec, k, xs)
            if "b" in p:
                y = y + p["b"].to(x.dtype)
            return y
        wq = p.get(f"wq{spec.w_bits}") if ctx.mode == "sim" else None
        if wq is None and ctx.mode == "sim" and (
                ctx.deployed or any(n.startswith("wq") for n in p)):
            raise ValueError(
                f"deployed sim-mode dense has no pre-quantized weight plane "
                f"for role '{role}' at w_bits={spec.w_bits} — run "
                "core.deploy.deploy() with the same SAC policy the context "
                "resolves")
        if wq is not None and ctx.cfg.cim.use_kernel:
            y = kops.cim_matmul_deployed(x, wq, p[f"ws{spec.w_bits}"], spec,
                                         k, x_scale=xs,
                                         dstate=dstate).to(x.dtype)
        elif wq is not None:
            y = cim_dense(x, None, spec, k, mode="sim", x_scale=xs,
                          w_scale=p[f"ws{spec.w_bits}"], wq=wq,
                          dstate=dstate)
        else:
            y = cim_dense(x, p["w"].to(x.dtype), spec, k, mode=ctx.mode,
                          x_scale=xs, dstate=dstate)
        y = _degrade_noise(ctx, p, x, y, spec, k, xs)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


DEGRADE_FOLD = 0xD364    # the ladder's noise key: fold_in(layer key, .)


def _degrade_noise(ctx: Ctx, p: Params, x: torch.Tensor, y: torch.Tensor,
                   spec: CIMSpec, k: Optional[prng.Seed], xs):
    """Per-row noise of the load ladder's reduced vote counts (sim mode
    only): row ``b`` at level ``l`` adds ``vote_drop_extra_std_int(spec,
    K, votes[l]) * xs * ws`` times a standard normal. The normal covers
    the whole ``y.shape`` under ``fold_in(k, 0xD364)`` (a ``SeedRow``
    reads its staged fold), so the readout noise is the same with and
    without a ladder; level-0 rows are selected by ``torch.where``, not
    by adding zero, and stay bit-identical to a ladder-free run. The
    sigma table is built from fills (a CUDA graph can capture them)."""
    if (ctx.degrade_rows is None or not ctx.degrade_levels
            or ctx.mode != "sim" or k is None):
        return y
    table = [vote_drop_extra_std_int(spec, x.shape[-1], v)
             for v in ctx.degrade_levels]
    if not any(s > 0.0 for s in table):
        return y
    ws = p.get(f"ws{spec.w_bits}")
    if ws is None:
        ws = quant.abs_max_scale(p["w"].to(torch.float32), spec.w_bits)
    if xs is None:
        xs = quant.abs_max_scale(x.to(torch.float32), spec.in_bits)
    rows = ctx.degrade_rows
    sig = torch.full(rows.shape, table[0], dtype=torch.float32,
                     device=rows.device)
    for level, s in enumerate(table[1:], 1):
        sig = torch.where(rows == level, torch.full(
            (), s, dtype=torch.float32, device=rows.device), sig)
    sig = sig.reshape(sig.shape + (1,) * (y.ndim - 1))
    noise = _ladder_normal(ctx, k, tuple(y.shape), y.device)
    return torch.where(sig > 0.0,
                       (y.to(torch.float32) + sig * xs * ws * noise)
                       .to(y.dtype), y)


def _ladder_normal(ctx: Ctx, k: prng.Seed, shape, device) -> torch.Tensor:
    """``normal(fold_in(k, 0xD364), shape)``. On the seed-table path the
    draws of this call's position in every layer of the forward are made
    at once, one Threefry over the staged folded keys of the column
    (``prng.fold_column``), and kept in ``ctx.degrade_draws`` for the
    forward's other layers: the same values, some 250 eager launches a
    position instead of 250 a call."""
    if not isinstance(k, prng.SeedRow) or not ctx.seed_width:
        return prng.normal(prng.fold_seed(k, DEGRADE_FOLD), shape,
                           device=device)
    pos = (k.row % ctx.seed_width, shape)
    if pos not in ctx.degrade_draws:
        ctx.degrade_draws[pos] = prng.normal(
            prng.fold_column(k, DEGRADE_FOLD, ctx.seed_width), shape,
            device=device)
    return ctx.degrade_draws[pos][k.row // ctx.seed_width]


def _act_scale(ctx: Ctx, x: torch.Tensor, spec: CIMSpec):
    """Per-layer Vref fit: clip activations at k*rms instead of abs-max.

    One scale for the whole batch (pad tokens and idle rows included), as
    in the reference; it stays on the device."""
    k = ctx.cfg.cim.act_clip_sigmas
    if k <= 0:
        return None
    rms = torch.sqrt(torch.mean(torch.square(x.to(torch.float32)))) + 1e-8
    return k * rms / quant.qmax(spec.in_bits)


# ----------------------------------------------------------------- norms

def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                         + eps)
    return (y * p["g"].to(torch.float32)).to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` as the reference's compiled model
    gives it: XLA folds the constant to ``theta ** -(2i / head_dim)``, the
    power rounded once to f32 (taken here in f64). Theta and the exponent
    in f32, as in JAX."""
    neg_ex = torch.arange(0, -head_dim, -2, dtype=torch.float32,
                          device=device) / head_dim
    base = torch.tensor(theta, dtype=torch.float32).item()
    return torch.pow(base, neg_ex.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S); ``freqs`` (D/2,) replaces
    ``rope_freqs(D, theta)``."""
    if freqs is None:
        freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs      # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP

def swiglu(ctx: Ctx, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = dense(ctx, p["gate"], x, "mlp_in")
    u = dense(ctx, p["up"], x, "mlp_in")
    h = shard(torch.nn.functional.silu(g) * u, "batch", "seq", "mlp")
    return dense(ctx, p["down"], h, "mlp_out")


# XLA's f32 tanh on the CPU: Eigen's rational approximation, clamped to
# +-7.99881172 (where it gives exactly +-1), x itself below 4e-4, every
# Horner step an FMA. torch.tanh differs from it in the last ulp on about
# half of all inputs, and a last-ulp difference in a GELU output flips a
# fake-quantized activation across a rounding boundary now and then.
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)
_TANH_CLAMP = 7.99881172180175781


def _horner_fma(x2: torch.Tensor, coeffs) -> torch.Tensor:
    """f32 Horner evaluation with each step fused (in f64, where the
    product of two f32 values is exact, then rounded to f32)."""
    p = torch.full_like(x2, coeffs[0])
    x2d = x2.to(torch.float64)
    for c in coeffs[1:]:
        p = (x2d * p.to(torch.float64)
             + float(np.float32(c))).to(torch.float32)
    return p


class _XlaTanh(torch.autograd.Function):
    """tanh with XLA's CPU values and JAX's derivative (1 + y)(1 - y)."""

    @staticmethod
    def forward(ctx, x):
        xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
        x2 = xc * xc
        y = torch.where(x.abs() < 0.0004, x,
                        xc * _horner_fma(x2, _TANH_NUM)
                        / _horner_fma(x2, _TANH_DEN))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (g + g * y) * (1.0 - y)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 ``jax.nn.gelu`` (the tanh form) with the reference's values:
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))``."""
    c = float(np.float32(np.sqrt(2 / np.pi)))
    inner = c * (x + 0.044715 * (x * (x * x)))
    return x * (0.5 * (1.0 + _XlaTanh.apply(inner)))


def gelu_mlp(ctx: Ctx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """up -> GELU (the tanh form, as ``jax.nn.gelu``; a bf16 activation is
    evaluated in f32 and rounded back) -> down."""
    h = dense(ctx, p["up"], x, "mlp_in")
    h = gelu_tanh(h.to(torch.float32)).to(h.dtype)
    h = shard(h, "batch", "seq", "mlp")
    return dense(ctx, p["down"], h, "mlp_out")


# ------------------------------------------------------------- embeddings

def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["e"].to(dtype)[tokens]


def unembed(ctx: Ctx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits head: digital per SAC (role 'head' maps to None), a plain
    matmul as in the reference."""
    return x @ p["e"].to(x.dtype).T


def sinusoidal_positions(pos, d: int, device=None) -> torch.Tensor:
    """pos: an int n (positions 0..n-1) or a tensor of positions of any
    shape (...) -> (..., d) f32 embeddings: the sines of the d/2
    frequencies ``pos / 10000^(2i/d)``, then their cosines. The power is
    rounded from float64, as XLA's f32 ``pow`` rounds it (torch's f32
    ``pow`` is an ulp off on some exponents, which moves the sine of a
    large angle by 1e-5)."""
    if isinstance(pos, int):
        pos = torch.arange(pos, device=device)
    pos = pos.to(torch.float32)[..., None]
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    den = torch.pow(10000.0, (2 * i / d).to(torch.float64))
    ang = pos / den.to(torch.float32)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
