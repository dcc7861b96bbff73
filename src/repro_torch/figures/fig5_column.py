"""Fig. 5 — column characteristics: INL < 2 LSB at 10 bits, read noise
0.58 LSB with CSNR-Boost and twice that without."""

from __future__ import annotations

import numpy as np

from repro_torch.core.adc import ADCSpec, conversion_noise_lsb, inl_curve
from repro_torch.core.cim import CIMSpec
from repro_torch.core.metrics import column_characteristics


def run(device="cuda") -> dict:
    adc = ADCSpec()
    inl = inl_curve(adc)
    noise_wo = conversion_noise_lsb(adc, cb=False, device=device)
    noise_w = conversion_noise_lsb(adc, cb=True, device=device)
    ch = column_characteristics(CIMSpec(cb=True), device=device)
    return {
        "max_inl_lsb": float(np.max(np.abs(inl))),
        "paper_max_inl_lsb": 2.0,
        "noise_wo_cb_lsb": noise_wo,
        "paper_noise_wo_cb_lsb": 1.16,
        "noise_w_cb_lsb": noise_w,
        "paper_noise_w_cb_lsb": 0.58,
        "cb_noise_improvement_x": noise_wo / noise_w,
        "transfer_max_dev_lsb": float(np.max(np.abs(ch["mean_code"]
                                                    - ch["v"]))),
    }
