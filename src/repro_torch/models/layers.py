"""Building blocks: CIM-aware dense, norms, RoPE, SwiGLU, embeddings.

Twin of ``src/repro/models/layers.py`` for the ported families. Every matmul
goes through ``dense()`` with a *role* (attn_qkv / mlp_in / ...) so the SAC
policy picks the macro operating point per layer. Parameters are plain
dicts of tensors laid out like the JAX tree.

Sim mode reads the deployed int8 planes on both of the reference's
paths: the fused CIM kernel with per-tile Threefry noise
(``cfg.cim.use_kernel=True``) or the behavioural ``core.cim.cim_dense``
with one whole-K ``jax.random.normal`` draw (``use_kernel=False``, the
config default). QAT (a straight-through estimator) raises here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng, quant
from repro_torch.core.cim import CIMSpec, cim_dense
from repro_torch.core.sac import Policy, get_policy
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]

_NOT_PORTED = "not ported yet; ROADMAP.md lists it as later work"


@dataclasses.dataclass
class Ctx:
    """Per-apply execution context: CIM mode, SAC policy, key stream.

    ``key`` is a raw Threefry key ``(k0, k1)`` of host ints; ``next_key``
    replays ``jax.random.fold_in(key, counter)`` bit for bit, in the same
    call order as the reference (q, k, v, o, gate, up, down per layer)."""

    cfg: ModelConfig
    mode: str = "off"                 # off | sim
    policy: Optional[Policy] = None
    key: Optional[prng.Key] = None
    counter: int = 0
    prefill_valid: Optional[torch.Tensor] = None  # (B,) int: real tokens of
                                                  # a right-padded prefill
                                                  # chunk (state-carrying
                                                  # blocks skip the pad)

    @classmethod
    def make(cls, cfg: ModelConfig, key: Optional[prng.Key] = None,
             mode: Optional[str] = None) -> "Ctx":
        mode = cfg.cim.mode if mode is None else mode
        if mode not in ("off", "sim"):
            raise NotImplementedError(f"cim mode {mode!r} is {_NOT_PORTED}")
        policy = get_policy(cfg.cim.policy) if mode != "off" else None
        return cls(cfg=cfg, mode=mode, policy=policy, key=key)

    def next_key(self) -> Optional[prng.Key]:
        if self.key is None:
            return None
        self.counter += 1
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
    same scale and draws its noise from the same key."""
    spec = ctx.spec_for(role)
    if spec is None:
        y = x @ p["w"].to(x.dtype)
    else:
        k = ctx.next_key()
        xs = _act_scale(ctx, x, spec)
        wq = p.get(f"wq{spec.w_bits}")
        if wq is None:
            raise ValueError(
                f"sim-mode dense has no pre-quantized weight plane for role "
                f"'{role}' at w_bits={spec.w_bits} — run core.deploy.deploy() "
                "with the same SAC policy the serving context resolves (sim "
                f"mode on an undeployed weight is {_NOT_PORTED})")
        if ctx.cfg.cim.use_kernel:
            y = kops.cim_matmul_deployed(x, wq, p[f"ws{spec.w_bits}"], spec,
                                         k, x_scale=xs).to(x.dtype)
        else:
            y = cim_dense(x, None, spec, k, mode="sim", x_scale=xs,
                          w_scale=p[f"ws{spec.w_bits}"], wq=wq)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


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


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / torch.pow(theta, ex)       # theta rounds to f32, as in JAX


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs      # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP

def swiglu(ctx: Ctx, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = dense(ctx, p["gate"], x, "mlp_in")
    u = dense(ctx, p["up"], x, "mlp_in")
    return dense(ctx, p["down"], torch.nn.functional.silu(g) * u, "mlp_out")


# ------------------------------------------------------------- embeddings

def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["e"].to(dtype)[tokens]


def unembed(ctx: Ctx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits head: digital per SAC (role 'head' maps to None), a plain
    matmul as in the reference."""
    return x @ p["e"].to(x.dtype).T
