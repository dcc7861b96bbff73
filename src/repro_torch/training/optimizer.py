"""AdamW with f32 master weights, global-norm clipping, cosine schedule.

Twin of ``src/repro/training/optimizer.py``: the state mirrors the
parameter tree (first and second moments and a master copy, all f32, plus
the step count), every update is f32 arithmetic in the reference's order,
and the parameters come back in their own dtype. The global norm sums the
leaves in the order ``jax.tree.leaves`` visits them (sorted dict keys).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and of matching trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (f32)."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_opt_state(params: Any) -> Dict[str, Any]:
    dev = tree_leaves(params)[0].device
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32,  # noqa: E731
                                  device=t.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "master": tree_map(lambda t: t.detach().to(torch.float32,
                                                       copy=True), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    total = None
    for t in tree_leaves(tree):
        s = torch.sum(torch.square(t.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict[str, Any],
                  cfg: OptConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new params, new state, {grad_norm, lr})``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    def upd(g, m, v, master):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / bc1
        vhat = v2 / bc2
        new_master = master - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                    + cfg.weight_decay * master)
        return m2, v2, new_master

    out = tree_map(upd, grads, state["m"], state["v"], state["master"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    master = pick(2)
    new_params = tree_map(lambda mp, p: mp.to(p.dtype), master, params)
    return (new_params,
            {"m": pick(0), "v": pick(1), "master": master, "step": step},
            {"grad_norm": gnorm, "lr": lr})
