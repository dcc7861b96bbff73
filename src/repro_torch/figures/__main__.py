"""Run the paper's figures on the port and print one JSON object each.

  PYTHONPATH=src python -m repro_torch.figures [--only fig5_column,...] \\
      [--device cpu]

Figures: fig2_swing, fig4_sac, fig5_column, fig6_summary, vit_accuracy
(fig4 and vit_accuracy train the tiny ViT first, cached under
``build/figures/``). Each line is ``{"figure": name, "seconds": wall,
...numbers}``; all of them are also written to ``build/figures.json``.
Runs on the card unless ``--device cpu``; exits non-zero if a figure
failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch import resolve_device
from repro_torch.figures import (fig2_swing, fig4_sac, fig5_column,
                                 fig6_summary, vit_accuracy)

FIGURES = {
    "fig2_swing": fig2_swing.run,
    "fig5_column": fig5_column.run,
    "fig6_summary": fig6_summary.run,
    "vit_accuracy": vit_accuracy.run,
    "fig4_sac": fig4_sac.run,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the paper's figures on the "
                                             "PyTorch port")
    ap.add_argument("--only", default=None,
                    help="comma-separated figures: " + ",".join(FIGURES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    only = args.only.split(",") if args.only else list(FIGURES)
    unknown = [n for n in only if n not in FIGURES]
    if unknown:
        raise SystemExit(f"unknown figures: {unknown}")
    results, failed = {}, []
    for name in only:
        t0 = time.perf_counter()
        try:
            out = FIGURES[name](device=dev)
        except Exception as e:          # report it, run the other figures
            print(json.dumps({"figure": name,
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
            failed.append(name)
            continue
        out = {"figure": name, "seconds": time.perf_counter() - t0, **out}
        print(json.dumps(out), flush=True)
        results[name] = out
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "figures.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
