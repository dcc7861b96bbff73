"""Fig. 4 — software-analog co-design: each block's CSNR requirement and
the 2.1x efficiency ablation (none -> w/CB -> w/CB + bit-width opt.).

The noise of the attention-class and of the MLP-class linears is swept
separately on the trained tiny ViT (the other class held at 0.05x); each
block's accuracy knee gives its noise tolerance. The paper finds that
attention tolerates about 10 dB lower compute SNR than the MLP.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import energy, prng
from repro_torch.core.sac import Policy, get_policy
from repro_torch.figures.common import images, trained_tiny_vit, vit_eval_acc
from repro_torch.models.layers import Ctx
from repro_torch.models.vit import vit_accuracy


def _acc_with_block_noise(cfg, params, block: str, scale: float,
                          dev) -> float:
    base = get_policy("uniform_6b")
    pol = Policy(
        name=f"sweep_{block}_{scale}",
        attn=dataclasses.replace(base.attn, noise_scale=(
            scale if block == "attn" else 0.05)),
        mlp=dataclasses.replace(base.mlp, noise_scale=(
            scale if block == "mlp" else 0.05)))
    accs = []
    for s in range(3):
        x, y = images(2000 + s, "eval", dev)
        ctx = Ctx(cfg=cfg, mode="sim", policy=pol,
                  key=prng.fold_in(prng.PRNGKey(11), s))
        accs.append(float(vit_accuracy(params, x, y, cfg, ctx)))
    return float(np.mean(accs))


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    cfg, params = trained_tiny_vit(device=dev)
    ideal = vit_eval_acc(cfg, params, "off", device=dev)
    # noise multiplier in sqrt(2) steps: CSNR moves by -20 log10(scale)
    scales = [2 ** (i / 2) for i in range(-2, 11)]     # 0.5 .. 32

    def cliff(accs, thresh):
        """Log-interpolated scale where the accuracy crosses ``thresh``."""
        prev_s, prev_a = scales[0], accs[0]
        for s, a in zip(scales, accs):
            if a < thresh:
                if a != prev_a:
                    frac = (thresh - prev_a) / (a - prev_a)
                    return prev_s * (s / prev_s) ** max(min(frac, 1.0), 0.0)
                return s
            prev_s, prev_a = s, a
        return scales[-1]

    knees, curves = {}, {}
    mid = (ideal + 0.1) / 2.0            # the 50 % cliff
    for block in ("attn", "mlp"):
        accs = [_acc_with_block_noise(cfg, params, block, s, dev)
                for s in scales]
        curves[block] = dict(zip((f"{s:.2f}" for s in scales), accs))
        knees[block] = cliff(accs, mid)
    tol_db = 20 * math.log10(max(knees["attn"], 1e-9)
                             / max(knees["mlp"], 1e-9))

    em = energy.calibrated_model()
    trace = energy.vit_small_linear_trace()
    e_none = energy.trace_energy(trace, get_policy("uniform_8b"), em)
    e_cb = energy.trace_energy(trace, get_policy("cb_only"), em)
    e_sac = energy.trace_energy(trace, get_policy("paper_sac"), em)
    return {
        "ideal_acc": ideal,
        "attn_noise_knee_scale": knees["attn"],
        "mlp_noise_knee_scale": knees["mlp"],
        "attn_extra_tolerance_db": tol_db,
        "paper_attn_extra_tolerance_db": 10.0,
        "curves": curves,
        "ablation_efficiency_none": 1.0,
        "ablation_efficiency_cb": e_none / e_cb,
        "ablation_efficiency_sac_bw": e_none / e_sac,
        "paper_efficiency_x": 2.1,
    }
