"""Fig. 6 — the summary table: 818 TOPS/W, SQNR 45.3 dB, CSNR 31.3 dB and
both figures of merit against the best prior CIMs, plus a behavioural
conventional charge-sharing CIM (attenuating readout, 8-bit ADC)."""

from __future__ import annotations

from repro_torch.core import energy, metrics
from repro_torch.core.cim import CIMSpec

# prior work's published numbers (the paper's Fig. 6 table)
PRIOR = {
    "jia_jsscc20": {"tops_w": 400e12, "sqnr": 22.0, "csnr": 17.0},
    "lee_vlsi21": {"tops_w": 5796e12, "sqnr": 17.5, "csnr": 10.5},
    "dong_isscc20": {"tops_w": 5616e12, "sqnr": 21.0, "csnr": None},
}


def run(device="cuda") -> dict:
    em = energy.calibrated_model()
    peak = CIMSpec(in_bits=6, w_bits=6, cb=False)
    this_tops_w = em.tops_per_watt(peak)
    sqnr = metrics.measure_sqnr_db(CIMSpec(cb=True), device=device)
    csnr = metrics.measure_csnr_db(CIMSpec(cb=True), m=32, n=8, reps=6,
                                   device=device)
    sqnr_fom = energy.snr_fom(this_tops_w, sqnr)
    csnr_fom = energy.snr_fom(this_tops_w, csnr)
    best_sqnr = max(energy.snr_fom(p["tops_w"], p["sqnr"])
                    for p in PRIOR.values())
    best_csnr = max(energy.snr_fom(p["tops_w"], p["csnr"])
                    for p in PRIOR.values() if p["csnr"] is not None)
    conv = CIMSpec(cb=False, scheme="conventional", in_bits=8, w_bits=8,
                   clip_sigmas=8.0)
    return {
        "tops_w_1b": this_tops_w / 1e12,
        "paper_tops_w_1b": 818.0,
        "tops_1b": em.tops(peak) / 1e12,
        "paper_tops_1b": 1.2,
        "sqnr_db": sqnr,
        "paper_sqnr_db": 45.3,
        "csnr_db": csnr,
        "paper_csnr_db": 31.3,
        "sqnr_fom": sqnr_fom,
        "paper_sqnr_fom": 118841.0,
        "sqnr_fom_vs_best_prior_x": sqnr_fom / best_sqnr,
        "paper_sqnr_fom_ratio_x": 2.3,
        "csnr_fom": csnr_fom,
        "paper_csnr_fom": 24541.0,
        "csnr_fom_vs_best_prior_x": csnr_fom / best_csnr,
        "paper_csnr_fom_ratio_x": 1.5,
        "conventional_sim_sqnr_db": metrics.measure_sqnr_db(conv,
                                                            device=device),
        "prior_jia_sqnr_db": 22.0,
    }
