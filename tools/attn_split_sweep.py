"""How the split of the key axis moves the two split-key kernels of the
float32 prefill and the MLA decode, on the card.

Times (CUDA events, ``chip_smoke.queued_ms``) the f32-query GQA prefill at
cells C and D's chunk (24 layers, B 1, S 32, start 128, T 320, qwen2-0.5b
heads) and the bf16 MLA latent-cache decode at cell F's step (4 layers,
B 4, H 128, L 512, R 64, T 320, lens 301/138/96/212), each under its
launch plan (``flash_gqa_plan``, ``mla_decode_plan``) and under the same
plan with other numbers of key blocks a split (kbps): a few between 1
(every key block its own block) and all of them (one block a work item,
no merge). Every variant's output is held against the plain version
first (2e-5 + 2e-5 |ref| for f32, 2^-7 of the row max for MLA). One JSON
line a variant, with the card's name and power limit. Runs on the H100 only:

    python tools/attn_split_sweep.py       # from the root of the checkout
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def with_kbps(plan_fn, kbps, n_kb):
    """``plan_fn`` with its split replaced by groups of ``kbps`` of the
    ``n_kb`` key blocks (None: the plan's own); the scratch shapes follow."""
    def plan(*args, **kw):
        p = plan_fn(*args, **kw)
        if kbps is None:
            return p
        n = -(-n_kb // kbps)
        old = p["n_split"]
        p.update(kbps=kbps, n_split=n, grid=(n,) + tuple(p["grid"][1:]),
                 part_o=(p["part_o"][0] // old * n,) + p["part_o"][1:],
                 part_ml=(p["part_ml"][0] // old * n,) + p["part_ml"][1:])
        return p
    return plan


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md
    if not torch.cuda.is_available():
        print("attn_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(56)
    st = torch.tensor([128], dtype=torch.int32, device=dev)
    real_gqa, real_mla = fa.flash_gqa_plan, md.mla_decode_plan
    for int8 in (False, True):
        caches = [cs.attn_cache(g, 1, 320, 2, 64, "int8" if int8 else "f32")
                  for _ in range(24)]
        qf = torch.randn((1, 32, 14, 64), generator=g, device=dev)
        for kbps in (None, 2, 5):                  # 5 64-key blocks in T
            fa.flash_gqa_plan = with_kbps(real_gqa, kbps, 5)
            out = fa.flash_gqa_attention(qf, *caches[0][:2], st,
                                         *caches[0][2:])
            ref = fa.flash_gqa_plain(qf, *caches[0][:2], st, *caches[0][2:])
            if ((out - ref).abs() > 2e-5 + 2e-5 * ref.abs()).any():
                raise SystemExit(f"flash_gqa f32 kbps {kbps}: out of "
                                 f"tolerance")
            ms = cs.queued_ms(lambda: [fa.flash_gqa_attention(
                qf, *c[:2], st, *c[2:]) for c in caches], 10)
            plan = fa.flash_gqa_plan(1, 32, 320, 14, 2, 64, False)
            print(json.dumps({"kernel": "flash_gqa[f32" + (",int8]" if int8
                                                           else "]"),
                              "kbps": plan["kbps"],
                              "n_split": plan["n_split"],
                              "plan_default": kbps is None,
                              "ms_per_chunk": ms, "card": smi}), flush=True)
        fa.flash_gqa_plan = real_gqa
    layers = [cs.mla_inputs(torch.bfloat16, cs.MLA_LENS, 320, 70 + i)
              for i in range(cs.MLA_LAYERS)]
    for kbps in (None, 1, 3, 5, 10):               # 10 32-key tiles in T
        md.mla_decode_plan = with_kbps(real_mla, kbps, 10)
        out = md.mla_decode_attention(*layers[0])
        ref = md.mla_decode_attention_plain(*layers[0])
        if cs.mla_rows(out, ref, cs.MLA_TOL["bfloat16"])[0].any():
            raise SystemExit(f"mla kbps {kbps}: out of tolerance")
        ms = cs.queued_ms(lambda: [md.mla_decode_attention(*a)
                                   for a in layers], 20)
        plan = md.mla_decode_plan(4, 128, 320, 512, torch.bfloat16)
        print(json.dumps({"kernel": "mla_decode_attention",
                          "kbps": plan["kbps"], "n_split": plan["n_split"],
                          "plan_default": kbps is None, "ms_per_step": ms,
                          "card": smi}), flush=True)
    md.mla_decode_plan = real_mla
    return 0


if __name__ == "__main__":
    sys.exit(main())
