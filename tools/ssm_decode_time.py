"""Device time of the selective-scan decode kernel at mamba2-130m's decode
step, under its launch plan and under other rows-per-thread plans, for this
checkout or another tree of the port.

    python tools/ssm_decode_time.py                   # this checkout
    python tools/ssm_decode_time.py --tree DIR        # the port under DIR/src
    python tools/ssm_decode_time.py --sass            # also the SASS order

One decode step is the 24 launches of mamba2-130m's layers at B = 4 (H 24,
P 64, N 128, conv_dim 1792, a bf16 window, f32 conv weights), each layer
its own state updated in place, as ``chip_smoke.py`` phase ``time`` times
it (torch.profiler's device time, ``device_ms``). Each variant is first
held against the plain version on every layer (the window bit for bit,
state and y rows within ``SSM_TOL`` of their max), then timed. The
variants: the tree's own plan (``ssm_decode_plan``), one and two state
rows a thread (8 and 16 rows a block: 768 and 384 blocks), and the plan
with the model's bf16 conv weights. A tree without
``ssm_decode_plan`` (the first design, one block per head and slot row)
gives its one variant. Prints the card's name and power limit, then one
JSON line per variant. Runs on the H100 only; compare two trees within one
call, in turns (parent, change, change, parent).

Beside the variants: PyTorch's in-place ``mul_`` of every layer's state
by a scalar (24 launches reading and writing the same 3.15 MB a layer): the
time the card's own streaming kernel takes for the state's bytes.

``--clock`` (this checkout only) builds with ``-DSSM_CLOCK`` (into
``build/ssm_clock``; the main build never sets it), whose thread 0 of
every block reads ``%globaltimer`` at its start, after the prologue's
barrier, once its state stores are issued and at its end, and prints per
variant the mean over the 24 launches of: the launch's span (first
block's start to last block's end), the spread of the blocks' starts, and
a block's mean time to the barrier (the prologue, under the state's
loads), from the barrier to its stores issued (waiting for the state,
the update) and from there to its end (the y reduction).

``--sass`` prints, per instantiation of the kernel in the built library,
the global loads issued before its first store (global or shared) and in
all (``cuobjdump -sass``): the state's loads must come first.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

B, LAYERS, SEED = 4, 24, 60


def sass_order(lib_path: Path) -> list:
    """[(kernel, global loads before the first store, global loads)] of
    every ssm_decode_kernel instantiation in the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True).stdout
    res = []
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0].strip()
        if "ssm_decode_kernel" not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)",
                         body)
        first = next((i for i, o in enumerate(ops)
                      if o.startswith(("STG", "STS"))), len(ops))
        res.append((name, sum(o.startswith("LDG") for o in ops[:first]),
                    sum(o.startswith("LDG") for o in ops)))
    return res


def clock_stages(ss, build, lay, states) -> dict:
    """Mean µs over the launches of one step: span, start spread, and a
    block's mean time per stage (see the module doc)."""
    import torch
    lib = build.library()
    plan = ss.ssm_decode_plan(B, *states[0].shape[1:])
    blocks = plan["grid"][0] * plan["grid"][1]
    rows = []
    for (a, dims), st in zip(lay, states):
        buf = torch.zeros(blocks * 4, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        lib.ssm_clock_set(buf.data_ptr())
        ss.ssm_decode_step(*a[:7], st, *dims, state_out=st)
        torch.cuda.synchronize()
        lib.ssm_clock_set(None)
        c = buf.view(blocks, 4).double().cpu() / 1e3     # µs
        rows.append([float(c[:, 3].max() - c[:, 0].min()),
                     float(c[:, 0].max() - c[:, 0].min()),
                     float((c[:, 1] - c[:, 0]).mean()),
                     float((c[:, 2] - c[:, 1]).mean()),
                     float((c[:, 3] - c[:, 2]).mean())])
    keys = ("span_us", "start_spread_us", "prologue_us", "state_us",
            "y_us")
    return {k: sum(r[i] for r in rows) / len(rows)
            for i, k in enumerate(keys)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose src/repro_torch to time")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass", action="store_true",
                    help="print the kernel's load/store order")
    ap.add_argument("--clock", action="store_true",
                    help="stage probe of every block instead of times")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssm_decode_time: runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs          # helpers only; it imports no port module
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as ss
    if args.clock:
        import ctypes
        _build.FLAGS = _build.FLAGS + ["-DSSM_CLOCK"]
        _build.BUILD_DIR = _build.BUILD_DIR.parent / "ssm_clock"
        _build._SIGNATURES["ssm_clock_set"] = [ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    h, p, n, win = 24, 64, 128, 3
    layers = [cs.ssm_operands(B, h, p, n, win, torch.bfloat16, SEED + i)
              for i in range(LAYERS)]
    nbytes, ops = cs.ssm_step_work(layers)
    bound = 1e3 * max(nbytes / cs.HBM_BPS, ops / cs.FP32_OPS)
    own = getattr(ss, "ssm_decode_plan", None)
    variants = {"own": (own, torch.float32)}
    if own is not None:
        base = own(B, h, p, n)
        for rpt in range(1, ss.MAX_ROWS_PER_THREAD + 1):
            rows = rpt * (base["threads"] // base["lanes"])
            groups = -(-p // rows)
            plan = dict(base, rows=rows, rows_per_thread=rpt, groups=groups,
                        grid=(h * groups, B))
            variants[f"rows_per_thread_{rpt}"] = (
                lambda *_, plan=plan: plan, torch.float32)
        variants["own_bf16_conv_weights"] = (own, torch.bfloat16)
    tree = str(Path(args.tree).resolve())
    for name, (plan_fn, cdt) in variants.items():
        if plan_fn is not None:
            ss.ssm_decode_plan = plan_fn
        lay = [(a[:2] + [a[2].to(cdt), a[3].to(cdt)] + a[4:], dims)
               for a, dims in layers]
        worst = 0.0
        for a, dims in lay:
            wide = a[:2] + [a[2].float(), a[3].float()] + a[4:]
            out = ss.ssm_decode_step(*a, *dims)
            ref = ss.ssm_decode_step_plain(*wide, *dims)
            rows_off = cs.ssm_rows(out, ref)
            if (bool(rows_off["state"].any()) or bool(rows_off["y"].any())
                    or not torch.equal(out[1], ref[1])):
                cs.fail(f"ssm_decode_step variant {name}: disagrees with "
                        f"the plain version")
            worst = max(worst, rows_off["state_err"], rows_off["y_err"])
        states = [a[7].clone() for a, _ in lay]
        if args.clock:
            print(json.dumps({"variant": name,
                              "plan": ss.ssm_decode_plan(B, h, p, n),
                              **clock_stages(ss, _build, lay, states)}))
            continue

        def run():
            for (a, dims), st in zip(lay, states):
                ss.ssm_decode_step(*a[:7], st, *dims, state_out=st)

        ms = cs.device_ms(run, args.reps)
        print(json.dumps({
            "tree": tree, "source_hash": _build.source_hash(),
            "variant": name, "conv_weight_dtype": str(cdt)[6:],
            "plan": None if plan_fn is None else plan_fn(B, h, p, n),
            "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
            "max_abs_err": worst,
            "unit": f"one decode step: {LAYERS} layers, B={B}, H={h}, P={p}, "
                    f"N={n}, bf16 window"}))
    if not args.clock:
        states = [a[7].clone() for a, _ in layers]
        mul_ms = cs.device_ms(lambda: [st.mul_(0.999) for st in states],
                              args.reps)
        print(json.dumps({"tree": tree, "variant": "torch_inplace_mul",
                          "ms": mul_ms, "bound_ms": 1e3 * sum(
                              2 * st.numel() * 4 for st in states)
                          / cs.HBM_BPS,
                          "unit": f"{LAYERS} launches of state.mul_(0.999) "
                                  f"on (B={B}, {h}, {p}, {n}) f32"}))
    if args.sass:
        for name, before, total in sass_order(_build.build()):
            print(json.dumps({"sass": name, "global_loads_before_first_store":
                              before, "global_loads": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
