"""End-to-end driver on the PyTorch port: noise-aware QAT training of a ViT
with the paper's SAC policy, then CIM-simulated inference — the paper's
CIFAR-10 experiment on the procedural stand-in task.

  PYTHONPATH=src python examples/torch_train_vit_cim.py [--steps 200] \\
      [--full] [--device cpu]

The twin of ``examples/train_vit_cim.py``, step for step, on
``repro_torch``: --full uses the paper's exact ViT-small (12L, d=384); the
default is a reduced config. Parameters are random, from a seeded
``torch.Generator``; each step is the loss under ``Ctx.make(cfg, key)``,
its gradients by autograd and one AdamW update. ``main`` returns the
accuracies.
"""

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CIMModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataConfig, image_batch
from repro_torch.models.layers import Ctx
from repro_torch.models.model import build
from repro_torch.models.vit import vit_accuracy, vit_loss
from repro_torch.training import optimizer as opt_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--eval-batches", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("vit-small-cifar")
    if not args.full:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=192, d_ff=384,
                                  n_heads=4, n_kv_heads=4, head_dim=48)
    cfg = dataclasses.replace(cfg, cim=CIMModelConfig(mode="qat",
                                                      policy="paper_sac"))
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt_cfg = opt_mod.OptConfig(lr=1.5e-3, warmup_steps=args.steps // 10,
                                total_steps=args.steps, weight_decay=0.01)
    opt = opt_mod.init_opt_state(params)
    dcfg = DataConfig(seed=5, global_batch=args.batch)

    def step(params, opt, images, labels, key):
        leaves = opt_mod.tree_map(lambda t: t.detach().requires_grad_(True),
                                  params)
        loss = vit_loss(leaves, images, labels, cfg, Ctx.make(cfg, key))
        flat = opt_mod.tree_leaves(leaves)
        gs = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        g = opt_mod.tree_map(lambda t: gs[id(t)], leaves)
        params, opt, _ = opt_mod.apply_updates(params, g, opt, opt_cfg)
        return params, opt, loss.detach()

    t0 = time.time()
    loss = None
    for s in range(args.steps):
        x, y = image_batch(dcfg, s)
        params, opt, loss = step(params, opt, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev),
                                 prng.fold_in(prng.PRNGKey(1), s))
        if s % 25 == 0:
            print(f"step {s:4d}  loss {float(loss):.4f}  "
                  f"({(time.time()-t0)/(s+1)*1e3:.0f} ms/step)")

    # evaluate: ideal digital vs CIM-simulated (SAC policy)
    def eval_acc(mode):
        accs = []
        with torch.no_grad():
            for s in range(args.eval_batches):
                x, y = image_batch(dcfg, 5000 + s, split="eval")
                ctx = Ctx.make(cfg, prng.fold_in(prng.PRNGKey(9), s),
                               mode=mode)
                accs.append(float(vit_accuracy(
                    params, torch.from_numpy(x).to(dev),
                    torch.from_numpy(y).to(dev), cfg, ctx)))
        return sum(accs) / len(accs)

    ideal = eval_acc("off")
    cim = eval_acc("sim")
    print(f"\nideal (digital) accuracy : {ideal:.3%}   (paper: 96.8%)")
    print(f"CIM-sim (SAC)  accuracy  : {cim:.3%}   (paper: 95.8%)")
    print(f"accuracy cost of analog  : {(ideal - cim) * 100:.1f} pt "
          f"(paper: 1.0 pt)")
    return {"loss": float(loss) if loss is not None else None,
            "ideal": ideal, "cim": cim}


if __name__ == "__main__":
    main()
