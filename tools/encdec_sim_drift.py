"""Where the reduced whisper-medium's sim-mode run parts between the card
and the CPU, and why.

    python tools/encdec_sim_drift.py

The reduced whisper (``chip_smoke.py`` ``arch_config(..., reduced=True)``:
2 encoder and 2 decoder layers, d 256, 32 stub frames) encodes the seeded
frames of ``arch_parity`` once on the card (the CIM kernel) and once on
the CPU (its plain version), in off and in sim mode, and the memories are
compared per row (max |card - CPU| over the CPU row's largest |value|).
Then the CPU encodes again with every CIM call's activation scale moved
one float32 ulp up (``torch.nextafter``) and one down, and each is held
against the card's memory the same way. The activation scale is a mean
over the whole batch, which the card and the CPU sum in different
orders: if one of the moved CPU runs gives the card's memory to float
rounding while the unmoved one does not, an ulp of that scale is the
cause, not a kernel. Prints the card's name and power limit, then one
JSON line. Runs on the H100 only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("encdec_sim_drift: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy, init_params
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    real = layers._act_scale

    def encode(cfg, params, frames, dev, step=None):
        if step is not None:
            layers._act_scale = lambda *a: torch.nextafter(
                real(*a), torch.tensor(step, device=frames.device))
        try:
            ctx = Ctx.make(cfg, prng.PRNGKey(21), mode=cfg.cim.mode,
                           deployed=cfg.cim.mode == "sim")
            return tf.encode(cs._tree_to(params, dev), frames.to(dev), cfg,
                             ctx).float().cpu()
        finally:
            layers._act_scale = real

    out = {}
    for mode in ("off", "sim"):
        cfg = cs.arch_config("whisper-medium", mode, reduced=True,
                             head_dim=64)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if mode == "sim":
            params = deploy(cfg, params)
        g = torch.Generator().manual_seed(4)
        torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
        frames = torch.randn((2, cfg.n_frames, cfg.d_model), generator=g)
        card = encode(cfg, params, frames, "cuda")
        cpu = encode(cfg, params, frames, "cpu")
        res = {"card_vs_cpu": cs.logits_rel(card, cpu).max().item()}
        if mode == "sim":
            for name, step in (("scale_ulp_up", float("inf")),
                               ("scale_ulp_down", float("-inf"))):
                moved = encode(cfg, params, frames, "cpu", step)
                res[f"card_vs_cpu_{name}"] = cs.logits_rel(
                    card, moved).max().item()
                res[f"cpu_{name}_vs_cpu"] = cs.logits_rel(
                    moved, cpu).max().item()
        out[mode] = res
    print(json.dumps({"encoder_memory_err_over_row_max": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
