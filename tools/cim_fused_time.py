"""Device time of the fused CIM kernel at qwen2-0.5b's decode and prefill
shapes, for this checkout or another tree of the port.

    python tools/cim_fused_time.py                    # this checkout
    python tools/cim_fused_time.py --tree DIR         # the port under DIR/src

One decode step is the 168 launches of 24 layers' seven projections (q, k,
v, o 896 x {896, 128, 128, 896}, gate and up 896 x 4864, down 4864 x 896;
paper_sac bits, random int8 planes, 358 MB, so every launch streams its
plane cold from HBM) at M = 4 rows; one prefill chunk the same launches at
M = 32 (the serving engine's chunk). Both with the readout noise on, timed
by torch.profiler's device time as ``chip_smoke.py`` times them
(``device_ms``), and each projection's 24 launches alone. Beside the
chunk: ``torch._int_mm`` on the same shapes
with int8 activations, the same products without the quantization and the
noise. Prints the card's name and power limit, then one JSON line. Runs on
the H100 only; compare two trees within one call, in turns.

    python tools/cim_fused_time.py --clock            # this checkout only

builds the kernels with ``-DCIM_GEMV_CLOCK`` (into ``build/cim_gemv_clock``;
the main build never sets it), whose decode GEMV stamps ``%globaltimer``
on thread 0 of every block, and prints per projection at M = 4 the mean
over its 24 launches of: the launch's span (first block's start to last
block's end), the spread of the blocks' starts, and a block's mean time
staging its activation (the plane's first loads issued), waiting for the
plane and reducing its partial, writing it and arriving, and the last
block's merge.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

PROJ = (("q", 896, 896, "attn"), ("k", 896, 128, "attn"),
        ("v", 896, 128, "attn"), ("o", 896, 896, "attn"),
        ("gate", 896, 4864, "mlp"), ("up", 896, 4864, "mlp"),
        ("down", 4864, 896, "mlp"))
LAYERS = 24


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose src/repro_torch to time")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--clock", action="store_true",
                    help="stage probe of the decode GEMV instead of times")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cim_fused_time: runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs          # helpers only; it imports no port module
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.core import prng, quant
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels import cim_matmul as cm
    if args.clock:
        import ctypes
        from repro_torch.kernels import _build
        _build.FLAGS = _build.FLAGS + ["-DCIM_GEMV_CLOCK"]
        _build.BUILD_DIR = _build.BUILD_DIR.parent / "cim_gemv_clock"
        _build._SIGNATURES["cim_gemv_clock_set"] = [ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(2)
    pol = paper_sac()
    planes = [(cs.random_plane(g, k, n, getattr(pol, role)),
               getattr(pol, role)) for _ in range(LAYERS)
              for _, k, n, role in PROJ]
    seed = prng.seed_from_key(prng.PRNGKey(9))
    res = {"tree": str(Path(args.tree).resolve()),
           "source_hash": None, "launches": len(planes)}
    if args.clock:
        lib = _build.library()
        for i, (name, k, n, _) in enumerate(PROJ):
            plan = cm.cim_fused_plan(4, k, n)
            blocks = plan["grid"][0] * plan["grid"][1]
            rows = []
            for wq, spec in planes[i::len(PROJ)]:
                x = torch.randn((4, k), generator=g, device="cuda").bfloat16()
                qp = torch.stack([x.float().abs().max() / 31, torch.ones(
                    (), device="cuda")])
                sigma = output_noise_std_int_per_tile(spec, k)
                cm.cim_matmul_fused(x, wq, qp, seed, sigma, spec.in_bits)
                buf = torch.zeros(blocks * 5, dtype=torch.int64, device="cuda")
                torch.cuda.synchronize()
                lib.cim_gemv_clock_set(buf.data_ptr())
                cm.cim_matmul_fused(x, wq, qp, seed, sigma, spec.in_bits)
                torch.cuda.synchronize()
                lib.cim_gemv_clock_set(None)
                c = buf.view(blocks, 5).double().cpu() / 1e3     # us
                last = int(c[:, 4].argmax())
                rows.append([float(c[:, 4].max() - c[:, 0].min()),
                             float(c[:, 0].max() - c[:, 0].min()),
                             float((c[:, 1] - c[:, 0]).mean()),
                             float((c[:, 2] - c[:, 1]).mean()),
                             float((c[:, 3] - c[:, 2]).mean()),
                             float(c[last, 4] - c[last, 3])])
            keys = ("span_us", "start_spread_us", "stage_us",
                    "plane_and_reduce_us", "store_and_arrive_us",
                    "merge_us")
            print(json.dumps({"projection": name, "k": k, "n": n,
                              "grid": plan["grid"], **{
                                  key: sum(r[j] for r in rows) / len(rows)
                                  for j, key in enumerate(keys)}}))
        return 0
    for m in (4, 32):
        calls = []
        for wq, spec in planes:
            k = wq.shape[0]
            x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
            xs = (4.0 * torch.sqrt(torch.mean(x.float() ** 2))
                  / quant.qmax(spec.in_bits))
            qp = torch.stack([xs, xs * 1e-2])
            calls.append((x, wq, qp, output_noise_std_int_per_tile(spec, k),
                          spec.in_bits))

        def run():
            for x, wq, qp, s, b in calls:
                cm.cim_matmul_fused(x, wq, qp, seed, s, b)

        res[f"m{m}_ms"] = cs.device_ms(run, args.reps)
        # each projection's 24 launches alone
        for i, (name, *_) in enumerate(PROJ):
            sub = calls[i::len(PROJ)]
            res[f"m{m}_{name}_ms"] = cs.device_ms(
                lambda: [cm.cim_matmul_fused(x, wq, qp, seed, s, b)
                         for x, wq, qp, s, b in sub], args.reps)
    # the yardstick: int8 products of the chunk shapes, no quantization
    # and no noise (torch._int_mm takes M > 16)
    lib = []
    for wq, _ in planes:
        xq = torch.randint(-31, 32, (32, wq.shape[0]), generator=g,
                           device="cuda", dtype=torch.int8)
        lib.append((xq, wq.t().contiguous().t()))
    res["m32_int_mm_ms"] = cs.device_ms(
        lambda: [torch._int_mm(xq, w) for xq, w in lib], args.reps)
    from repro_torch.kernels import _build
    res["source_hash"] = _build.source_hash()
    if hasattr(cm, "cim_fused_plan"):
        res["plans"] = {f"{name} m{m}": cm.cim_fused_plan(m, k, n)
                        for m in (4, 32) for name, k, n, _ in PROJ}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
