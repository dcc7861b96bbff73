"""Quickstart on the PyTorch port: run a linear layer on the CR-CIM macro
model and measure the paper's headline metrics.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py``, step for step, on ``repro_torch``;
runs on the card unless ``--device cpu``. ``main`` returns the measured
numbers.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.cim import CIMSpec, cim_dense, cim_matmul_bit_exact
from repro_torch.core.energy import calibrated_model, sac_efficiency
from repro_torch.core.metrics import measure_csnr_db, measure_sqnr_db
from repro_torch.core.sac import paper_sac


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # --- 1. a linear layer, three execution modes ----------------------------
    key = prng.PRNGKey(0)
    x = prng.normal(key, (8, 1024), device=dev)
    w = prng.normal(prng.fold_in(key, 1), (1024, 64), device=dev)

    spec = CIMSpec()                   # 6b/6b, CB on (MLP operating point)
    y_ideal = cim_dense(x, w, None, None, mode="digital")
    # training: straight-through fake-quant
    y_qat = cim_dense(x, w, spec, None, mode="qat")
    y_cim = cim_dense(x, w, spec, prng.fold_in(key, 2), mode="sim")

    out["rel_gaussian"] = _rel(y_cim, y_ideal)
    out["rel_qat"] = _rel(y_qat, y_ideal)
    print(f"CIM vs ideal rel. error, gaussian drive, total (incl. static "
          f"DNL/INL): {out['rel_gaussian']:.1%}")
    print("  (static errors are fixed-pattern and partly absorbed by QAT; the")
    print("   network-level cost is ~1 accuracy point — see vit_accuracy "
          "bench)")

    # at the *peak* drive the paper's CSNR characterises (full-range operands)
    xq = prng.randint(key, (8, 1024), -31, 32, device=dev)
    wq = prng.randint(prng.fold_in(key, 1), (1024, 64), -31, 32, device=dev)
    y_bit = cim_matmul_bit_exact(xq, wq, prng.fold_in(key, 3), spec)
    exact = (xq.to(torch.float32) @ wq.to(torch.float32))
    out["rel_peak"] = _rel(y_bit, exact)
    print(f"CIM vs ideal rel. error, peak drive (bit-exact SAR chain): "
          f"{out['rel_peak']:.1%}")

    # --- 2. the macro's accuracy metrics -------------------------------------
    out["sqnr_db"] = measure_sqnr_db(spec, device=dev)
    out["csnr_db"] = measure_csnr_db(spec, m=24, n=8, reps=6, device=dev)
    print(f"SQNR  (paper 45.3 dB): {out['sqnr_db']:5.1f} dB")
    print(f"CSNR  (paper 31.3 dB): {out['csnr_db']:5.1f} dB")

    # --- 3. the SAC policy + energy model ------------------------------------
    pol = paper_sac()
    print(f"attention linears -> {pol.attn.in_bits}b wo/CB, "
          f"MLP linears -> {pol.mlp.in_bits}b w/CB")
    em = calibrated_model()
    out["peak_tops_w"] = em.tops_per_watt(CIMSpec(cb=False)) / 1e12
    out["sac_gain"] = sac_efficiency(em)
    print(f"peak efficiency (paper 818): {out['peak_tops_w']:.0f} TOPS/W "
          f"(1b-norm)")
    print(f"SAC transformer efficiency gain (paper 2.1x): "
          f"{out['sac_gain']:.2f}x")
    return out


if __name__ == "__main__":
    main()
