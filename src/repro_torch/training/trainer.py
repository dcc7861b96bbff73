"""Training loop: the microbatched step and the fault-tolerant driver.

Twin of ``src/repro/training/trainer.py`` for one device.
``make_train_step`` builds ``train_step(params, opt_state, batch, key)``:
the loss of ``models.model.build(cfg)`` under ``key`` and its gradients by
autograd, accumulated in f32 over ``microbatches`` slices of the batch
(microbatch ``i`` keyed ``fold_in(key, i)``), then one AdamW step.
``Trainer`` drives it: checkpoint and auto-resume from the latest step,
a checkpoint on SIGTERM (preemption), and a step-deadline watchdog that
logs stragglers. ``compress_grads`` applies the int8 transfer function of
``distributed.compression.simulate_compression`` to the step's gradients
under ``fold_in(key, 0x5EED)``, as the reference's one-device step does.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.distributed.compression import simulate_compression
from repro_torch.models.model import build
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.checkpoint import CheckpointManager


def _leaves_with_grad(params: Any) -> Any:
    return opt_mod.tree_map(lambda t: t.detach().requires_grad_(True), params)


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.OptConfig,
                    microbatches: int = 1, compress_grads: bool = False):
    """Returns ``train_step(params, opt_state, batch, key) -> (params,
    opt_state, metrics)``; ``batch`` is a dict of tensors with the batch on
    the leading axis, ``key`` a Threefry key."""
    api = build(cfg)

    def grads_of(params, batch, key):
        leaves = _leaves_with_grad(params)
        loss = api.loss(leaves, batch, key)
        flat = opt_mod.tree_leaves(leaves)
        gs = iter(torch.autograd.grad(loss, flat))
        by_id = {id(t): next(gs) for t in flat}
        return loss.detach(), opt_mod.tree_map(lambda t: by_id[id(t)],
                                               leaves)

    def train_step(params, opt_state, batch, key):
        if microbatches <= 1:
            loss, grads = grads_of(params, batch, key)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            loss = None
            grads = opt_mod.tree_map(
                lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device), params)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                li, gi = grads_of(params, mb, prng.fold_in(key, i))
                loss = li if loss is None else loss + li
                grads = opt_mod.tree_map(torch.add, grads, gi)
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = opt_mod.tree_map(lambda g: g * inv, grads)
        if compress_grads:
            grads = simulate_compression(grads, prng.fold_in(key, 0x5EED))
        params, opt_state, info = opt_mod.apply_updates(params, grads,
                                                        opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **info}

    return train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join("build", "ckpt")
    keep: int = 3
    step_deadline_s: float = 0.0   # > 0: steps slower than this are logged


class Trainer:
    """Fault-tolerant single-device driver: parameters from a seeded
    ``torch.Generator`` (the key's words), resume from the latest
    checkpoint, a checkpoint every ``checkpoint_every`` steps and on
    SIGTERM, slow steps logged in ``slow_steps``."""

    def __init__(self, cfg: ModelConfig, opt_cfg: opt_mod.OptConfig,
                 tcfg: TrainerConfig, data_iter_fn: Callable[[int], Any],
                 microbatches: int = 1, compress_grads: bool = False,
                 device="cuda"):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.device = resolve_device(device)
        self.data_iter_fn = data_iter_fn
        self.api = build(cfg)
        self.train_step = make_train_step(cfg, opt_cfg, microbatches,
                                          compress_grads)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
        self._preempted = False
        self.slow_steps = []

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread

    def init_params(self, key: prng.Key) -> Any:
        seed = (key[0] << 32) | key[1]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.api.init(gen, self.device)

    def run(self, key: prng.Key, resume: bool = True) -> Dict[str, Any]:
        self._install_preemption_handler()
        params = self.init_params(key)
        opt_state = opt_mod.init_opt_state(params)
        start = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                (params, opt_state), meta = self.ckpt.restore(
                    latest, (params, opt_state))
                start = meta["step"]
        metrics, step = {}, start - 1
        for step in range(start, self.tcfg.total_steps):
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self.data_iter_fn(step).items()}
            t0 = time.monotonic()
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch, prng.fold_in(key, step))
            metrics["loss"].item()              # wait for the step
            dt = time.monotonic() - t0
            if self.tcfg.step_deadline_s and dt > self.tcfg.step_deadline_s:
                self.slow_steps.append((step, dt))
            if (step + 1) % self.tcfg.checkpoint_every == 0 or self._preempted:
                self.ckpt.save(step + 1, (params, opt_state),
                               extra={"data_step": step + 1})
            if self._preempted:
                break
        return {"params": params, "opt_state": opt_state, "metrics": metrics,
                "last_step": step + 1, "slow_steps": self.slow_steps}
