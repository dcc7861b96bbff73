"""End-to-end LM training driver on the PyTorch port: a ~100M-parameter
internlm2-family model with QAT CIM linears, few hundred steps,
checkpoint/resume.

The twin of ``examples/train_lm_100m.py``, step for step, on
``repro_torch`` (one device; the reference's ``--mesh`` sharding is not
ported yet). The default size finishes on a CPU (--dim 256 ~ 25M); pass
--dim 512 --layers 12 for the full ~100M run.

  PYTHONPATH=src python examples/torch_train_lm_100m.py --steps 200 \\
      [--device cpu]
"""

import argparse
import dataclasses
import os
import time

from repro_torch.configs.base import CIMModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--qat", action="store_true", help="CIM QAT linears")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join("build", "repro_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers, d_model=args.dim,
        n_heads=max(args.dim // 64, 1),
        n_kv_heads=max(args.dim // 128, 1), head_dim=64, d_ff=4 * args.dim,
        vocab_size=args.vocab, dtype="float32",
        cim=CIMModelConfig(mode="qat" if args.qat else "off"))
    n_params = cfg.param_count()
    print(f"model: {args.layers}L d={args.dim} vocab={args.vocab} "
          f"-> {n_params/1e6:.1f}M params, cim={cfg.cim.mode}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    opt_cfg = opt_mod.OptConfig(lr=6e-4, warmup_steps=args.steps // 10,
                                total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                         checkpoint_dir=args.ckpt_dir)
    trainer = Trainer(cfg, opt_cfg, tcfg, lambda s: lm_batch(dcfg, s),
                      device=args.device)
    t0 = time.time()
    out = trainer.run(prng.PRNGKey(0))
    dt = time.time() - t0
    tok_s = out["last_step"] * args.batch * args.seq / dt
    print(f"loss {float(out['metrics']['loss']):.4f} after "
          f"{out['last_step']} steps; {dt:.0f}s wall, {tok_s:,.0f} tok/s")
    return out


if __name__ == "__main__":
    main()
