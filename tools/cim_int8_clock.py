"""Where the int8 CIM kernel's time goes, stage by stage, on the card.

Builds a copy of ``src/repro_torch/csrc`` (into ``build/``) whose
``cim_int8_mma`` carries ``clock64()`` probes on thread 0 of every block:
before a stage's wait, after its barrier, after the next stage's loads are
issued, after its MMAs are issued, and at
the loop's start and end (with ``%globaltimer`` beside them, to turn cycles
into time). The probed kernel then runs the seven qwen2-0.5b projections of
``chip_smoke.py``'s B2 timing (M = 1024) with and without the readout
noise. Per projection it prints the block height, grid and steps, and per
step the mean cycles of

- ``wait``: the stage's ``cp.async`` wait and the barrier (data not there
  yet, or other warps still in the previous step),
- ``load``: issuing the ``cp.async`` copies of the stage NST - 1 ahead,
- ``mma``: the ``ldmatrix`` and the MMAs of this stage,
- ``rest``: the noise draws and the macro-tile epilogue,

the first step's wait apart (the ring's fill), each block's loop in µs,
and the SM clock the probes imply. One probe set on one thread: the other
warps are not seen. Runs on the H100 only:

    python tools/cim_int8_clock.py       # from the root of the checkout
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

MAXS = 64            # steps probed per block (K up to 8192)

PATCHES = (          # (anchor, text, before): each anchor occurs once
    ("template <int TM, bool ALIGNED>\n__global__",
     "__device__ long long* cim_clock_p = nullptr;\n"
     f"constexpr int CK_MAXS = {MAXS};\n"
     "__device__ __forceinline__ long long ck_global() {\n"
     "  long long g;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
     "  return g;\n}\n", True),
    ("  const int n_steps = (K + KS - 1) / KS;\n",
     "  const long long ck_s = clock64(), gt_s = ck_global();\n"
     "  long long* ck_b = cim_clock_p == nullptr ? nullptr\n"
     "      : cim_clock_p + (size_t)(blockIdx.y * gridDim.x + blockIdx.x)\n"
     "                      * (CK_MAXS + 1) * 4;\n"
     "  long long ck0 = 0, ck1 = 0, ck2 = 0;\n", False),
    ("    rt::cp_async_wait<NST - 2>();              // stage step\n",
     "    ck0 = clock64();\n", True),
    ("    if (step + NST - 1 < n_steps) load(step + NST - 1);\n",
     "    ck1 = clock64();\n", True),
    ("    rt::cp_async_commit();\n"
     "    const unsigned char* a_s = as + step % NST * L::A;\n",
     "    ck2 = clock64();\n", True),
    ("    const uint32_t tile = (uint32_t)(step / (TILE / KS));\n",
     "    if (t == 0 && ck_b != nullptr && step < CK_MAXS) {\n"
     "      ck_b[step * 4] = ck0;\n      ck_b[step * 4 + 1] = ck1;\n"
     "      ck_b[step * 4 + 2] = ck2;\n"
     "      ck_b[step * 4 + 3] = clock64();\n    }\n", True),
    ("  const float out_scale = scale_p != nullptr ? *scale_p : scale_v;\n",
     "  if (t == 0 && ck_b != nullptr) {\n"
     "    ck_b[CK_MAXS * 4] = ck_s;\n    ck_b[CK_MAXS * 4 + 1] = clock64();\n"
     "    ck_b[CK_MAXS * 4 + 2] = gt_s;\n"
     "    ck_b[CK_MAXS * 4 + 3] = ck_global();\n  }\n", True),
)
SETTER = """
extern "C" int cim_clock_set(void* p) {
  return (int)cudaMemcpyToSymbol(cim_clock_p, &p, sizeof(p));
}
"""


def probed_library():
    """Point the port's build at a probed copy of the sources."""
    import ctypes
    from repro_torch.kernels import _build
    dst = _build.BUILD_DIR.parent / "cim_int8_clock_csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    path = dst / "cim_matmul.cu"
    text = path.read_text()
    for anchor, add, before in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"cim_int8_clock: anchor not found once: "
                             f"{anchor!r}")
        text = text.replace(anchor, add + anchor if before else anchor + add)
    path.write_text(text + SETTER)
    _build.CSRC = dst
    _build.BUILD_DIR = _build.BUILD_DIR.parent / "cim_int8_clock"
    _build._SIGNATURES["cim_clock_set"] = [ctypes.c_void_p]
    return _build.library()


def main() -> int:
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("cim_int8_clock: runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels.cim_matmul import cim_int8_plan, cim_matmul_int8
    lib = probed_library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(54)
    pol = paper_sac()
    for i, (name, k, n, role) in enumerate(cs.B2_PROJ):
        spec = getattr(pol, role)
        xq, wq, scale = cs.b2_operands(g, cs.B2_M, k, n, spec)
        sigma = output_noise_std_int_per_tile(spec, k)
        for noise in (False, True):
            plan = cim_int8_plan(cs.B2_M, k, n, xq.data_ptr(),
                                 wq.data_ptr(), noise)
            blocks = plan["grid"][0] * plan["grid"][1]
            steps = min(plan["stages"], MAXS)
            buf = torch.zeros(blocks * (MAXS + 1) * 4, dtype=torch.int64,
                              device="cuda")

            def run():
                cim_matmul_int8(xq, wq, (9, i) if noise else None, sigma,
                                scale)
            ms = cs.queued_ms(run, 10)
            lib.cim_clock_set(buf.data_ptr())
            run()                                # warm, then the probed one
            buf.zero_()
            run()
            torch.cuda.synchronize()
            lib.cim_clock_set(None)
            c = buf.view(blocks, MAXS + 1, 4).double().cpu()
            st = c[:, :steps]                    # the four probes a step
            wait = st[:, :, 1] - st[:, :, 0]
            load = st[:, :, 2] - st[:, :, 1]
            mma = st[:, :, 3] - st[:, :, 2]
            rest = st[:, 1:, 0] - st[:, :-1, 3]
            span_ck = c[:, MAXS, 1] - c[:, MAXS, 0]
            span_ns = c[:, MAXS, 3] - c[:, MAXS, 2]
            ghz = float(span_ck.sum() / span_ns.sum())
            line = dict(
                projection=name, k=k, n=n, noise=noise, ms=ms,
                block_m=plan["block_m"], grid=list(plan["grid"]),
                steps=plan["stages"], sm_ghz=ghz,
                first_wait_cycles=float(wait[:, 0].mean()),
                wait_cycles=float(wait[:, 1:].mean()) if steps > 1 else None,
                load_cycles=float(load.mean()),
                mma_cycles=float(mma.mean()),
                rest_cycles=float(rest.mean()) if steps > 1 else None,
                block_loop_us_mean=float(span_ns.mean()) / 1e3,
                block_loop_us_max=float(span_ns.max()) / 1e3)
            print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
