"""Training CLI of the port: one device, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 50 --batch 8 --seq 128 [--cim qat] \\
      [--microbatches 4] [--device cpu]

Trains a decoder LM of the registry on the procedural token stream
(``data.pipeline.lm_batch``) with AdamW (warmup over a tenth of the steps,
then cosine decay), checkpointing every ``--ckpt-every`` steps into
``--ckpt-dir`` and resuming from its latest checkpoint. ``--cim qat`` runs
every CIM-routed linear as noise-aware straight-through fake-quant.
Parameters are random, drawn from the key ``PRNGKey(0)``'s words. The
entry point runs on the card; ``--device cpu`` runs on the CPU.
``--compress-grads`` passes the gradients through the int8 stochastic-
rounding transfer function of the data-parallel all-reduce
(``distributed.compression.simulate_compression``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.base import CIMModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="CR-CIM training on PyTorch: one device")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cim", default=None, choices=[None, "off", "qat", "sim"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.cim:
        cfg = dataclasses.replace(cfg, cim=CIMModelConfig(
            mode=args.cim, policy=cfg.cim.policy))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    opt_cfg = opt_mod.OptConfig(lr=args.lr,
                                warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt_dir)
    trainer = Trainer(cfg, opt_cfg, tcfg, lambda step: lm_batch(dcfg, step),
                      microbatches=args.microbatches,
                      compress_grads=args.compress_grads,
                      device=args.device)
    t0 = time.time()
    out = trainer.run(prng.PRNGKey(0))
    dt = time.time() - t0
    m = out["metrics"]
    print(f"done: steps={out['last_step']} loss={float(m['loss']):.4f} "
          f"grad_norm={float(m['grad_norm']):.3f} wall={dt:.1f}s "
          f"({dt / max(out['last_step'], 1) * 1e3:.0f} ms/step)")
    return out


if __name__ == "__main__":
    main()
