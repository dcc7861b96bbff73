"""Fig. 6 — ViT inference on the macro against ideal: the paper's 95.8 %
against 96.8 % on CIFAR-10, here the relative accuracy on the procedural
CIFAR-shaped task after noise-aware QAT."""

from __future__ import annotations

from repro_torch.figures.common import trained_tiny_vit, vit_eval_acc


def run(device="cuda") -> dict:
    cfg, params = trained_tiny_vit(device=device)
    ideal = vit_eval_acc(cfg, params, "off", batches=6, device=device)
    cim_sac = vit_eval_acc(cfg, params, "sim", batches=6, device=device)
    cim_all4 = vit_eval_acc(cfg, params, "sim", batches=6, noise_scale=4.0,
                            device=device)
    return {
        "ideal_acc": ideal,
        "cim_sac_acc": cim_sac,
        "acc_drop_pt": (ideal - cim_sac) * 100,
        "paper_ideal_acc": 0.968,
        "paper_cim_acc": 0.958,
        "paper_drop_pt": 1.0,
        "cim_4x_noise_acc": cim_all4,
    }
