"""Where the fused decode layer's time goes, stage by stage, on the card.

Builds the port's kernels with ``-DFUSED_LAYER_CLOCK`` (into
``build/fused_layer_clock/``; the main build never sets the flag), which
makes thread 0 of every block of ``csrc/fused_layer.cu`` stamp
``%globaltimer`` at the kernel's start, at the end of each of the five
stages' work and after each of the four grid-wide barriers. It then runs
one decode step of ``chip_smoke.py``'s fused timing (float32 qwen2-0.5b at
full width, sim mode, B = 4, lens 300/137/95/211 after the write, 24
layers) with the f32 and the int8 cache, and prints per cache the mean
over the 24 launches of

- ``work_us[s]``: from the release of the barrier before stage s (the
  kernel's first stamp for stage 1) to the last block's end of stage s,
- ``barrier_us[s]``: from that last end to the last block's release,
- ``block_busy_us[s]``: the mean block's own time in stage s,
- ``launch_us``: first stamp to last stamp.

The stamps add a block barrier before each stamp, so the probed launch is
a little slower than the real one; its ``launch_us`` is printed beside the
profiler's device time of the unprobed kernel. Runs on the H100 only:

    python tools/fused_layer_clock.py       # from the root of the checkout
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

STAMPS = 10          # FL_STAMPS in csrc/fused_layer.cu
STAGES = ("qkv", "attention", "o", "gate_up", "down")


def probed_library():
    """Point the port's build at a probed build of the same sources."""
    import ctypes
    from repro_torch.kernels import _build
    _build.FLAGS = _build.FLAGS + ["-DFUSED_LAYER_CLOCK"]
    _build.BUILD_DIR = _build.BUILD_DIR.parent / "fused_layer_clock"
    _build._SIGNATURES["fused_layer_clock_set"] = [ctypes.c_void_p]
    return _build.library()


def stage_times(c):
    """(blocks, STAMPS) ns stamps of one launch -> per-stage figures, us."""
    work, barrier, busy = [], [], []
    for s in range(5):
        start = c[:, 2 * s] if s else c[:, 0]
        end = c[:, 2 * s + 1]
        release = float(start.min()) if s == 0 else float(start.max())
        work.append((float(end.max()) - release) / 1e3)
        busy.append(float((end - start).mean()) / 1e3)
        if s < 4:
            barrier.append((float(c[:, 2 * s + 2].max())
                            - float(end.max())) / 1e3)
    return work, barrier, busy, (float(c.max()) - float(c.min())) / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fused_layer_clock: runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy, init_params
    from repro_torch.kernels.fused_step import fused_dense_layer
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx
    lib = probed_library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    params32 = init_params(cs.full_config32(False),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    for int8 in (False, True):
        cfg = cs.full_config32(int8)
        blocks = deploy(cfg, params32)["blocks"]
        layers = [tf._index(blocks, i) for i in range(cfg.n_layers)]
        key = prng.PRNGKey(9)
        ins = [cs.fused_inputs(cfg, 320, 40 + i) for i in range(len(layers))]

        def step(bufs=None):
            for i, (lay, (x, c)) in enumerate(zip(layers, ins)):
                if bufs is not None:
                    lib.fused_layer_clock_set(bufs[i].data_ptr())
                fused_dense_layer(Ctx.make(cfg, key, mode="sim"), lay, x, c)
            lib.fused_layer_clock_set(None)

        step()                               # build, warm
        torch.cuda.synchronize()
        ins = [cs.fused_inputs(cfg, 320, 40 + i) for i in range(len(layers))]
        grid = fused_dense_layer.grid
        bufs = [torch.zeros(grid * STAMPS, dtype=torch.int64, device="cuda")
                for _ in layers]
        step(bufs)
        torch.cuda.synchronize()
        rows = [stage_times(b.view(grid, STAMPS).double().cpu())
                for b in bufs]
        n = len(rows)
        mean = lambda i, s: sum(r[i][s] for r in rows) / n  # noqa: E731
        print(json.dumps({
            "kernel": "fused_dense_layer" + ("[int8]" if int8 else ""),
            "grid": grid, "layers": n, "stages": list(STAGES),
            "work_us": [mean(0, s) for s in range(5)],
            "barrier_us": [mean(1, s) for s in range(4)],
            "block_busy_us": [mean(2, s) for s in range(5)],
            "launch_us": sum(r[3] for r in rows) / n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
