"""Serve a small LM on the PyTorch port with batched requests, linears
executing on the CIM model (the macro's deployment scenario), and report
the energy the macro would burn per token under the SAC policy vs the
uniform baseline.

  PYTHONPATH=src python examples/torch_serve_lm_cim.py [--requests 6] \\
      [--device cpu]

The twin of ``examples/serve_lm_cim.py``, step for step, on
``repro_torch``: the reduced arch's random parameters (a seeded
``torch.Generator``), deployed once into int8 planes, served by the
slot-batched ``Engine`` in sim mode on those planes. On the card the
engine replays CUDA graphs of its steps when the CIM linears go through
the CIM kernel (``--use-kernel``; the configs' default is the behavioural
path, which serves per call); ``--attn-impl kernel`` runs attention on
the decode and prefill kernels. ``main`` returns the generated tokens,
the engine and the energy figures.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.core import energy
from repro_torch.core.deploy import deploy, init_params, plane_summary
from repro_torch.core.sac import get_policy
from repro_torch.serving.engine import Engine, Request


def lm_linear_trace(cfg, context_len: int):
    """Per-token linear-op trace of the serving forward (for the energy
    model)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv_heads
    trace = []
    for _ in range(cfg.n_layers):
        trace.append(("attn_qkv", 1, d, (h + 2 * kv) * hd))
        trace.append(("attn_out", 1, h * hd, d))
        trace.append(("mlp_in", 1, d, 2 * f))
        trace.append(("mlp_out", 1, f, d))
    return trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--use-kernel", action="store_true",
                    help="route the CIM linears through the CIM kernel")
    ap.add_argument("--attn-impl", default="config",
                    choices=["config", "einsum", "kernel"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    if args.use_kernel:
        cfg = dataclasses.replace(
            cfg, cim=dataclasses.replace(cfg.cim, use_kernel=True))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    # deploy: pre-quantize every CIM-routed weight once per SAC policy —
    # the macro's weight-stationary contract (weights are programmed into
    # the array once; only activations quantize per token). Bit-identical
    # to on-the-fly quantization, and the sim-mode serving fast path.
    # (Engine(cim_mode="sim") does this automatically; shown explicitly.)
    params = deploy(cfg, params)
    ps = plane_summary(params)
    print(f"deployed {ps['planes']} weight planes "
          f"({ps['int8_bytes'] / 2**20:.2f} MiB int8)")

    # slot-batched engine: one decode step advances both slots, and prompts
    # stream through chunked prefill interleaved with decode
    engine = Engine(cfg, params, max_slots=2, max_len=64, cim_mode="sim",
                    deploy=False,  # params already deployed above
                    record_ttft=True, device=dev,
                    attn_impl=None if args.attn_impl == "config"
                    else args.attn_impl)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 12,
                                        dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    t0 = time.time()
    outs = engine.generate(reqs)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    ttfts = [t for t in engine.ttft_s if t is not None]
    print(f"served {len(reqs)} requests / {n_tok} tokens on the CIM model "
          f"in {dt:.1f}s ({n_tok / dt:.1f} tok/s, "
          f"{engine.launch_count} forwards, "
          f"{engine.replay_count} graph replays, "
          f"chunk={engine.chunk_size})")
    print(f"TTFT mean {np.mean(ttfts) * 1e3:.0f} ms / "
          f"max {np.max(ttfts) * 1e3:.0f} ms")

    # what would the macro burn per generated token?
    em = energy.calibrated_model()
    trace = lm_linear_trace(cfg, 64)
    e_sac = energy.trace_energy(trace, get_policy("paper_sac"), em)
    e_base = energy.trace_energy(trace, get_policy("uniform_8b"), em)
    print(f"macro energy per token (SAC policy)   : {e_sac * 1e9:.2f} nJ")
    print(f"macro energy per token (no co-design) : {e_base * 1e9:.2f} nJ")
    print(f"SAC saving: {e_base / e_sac:.2f}x  (paper: up to 2.1x)")
    return {"outs": outs, "tok_s": n_tok / dt, "e_sac": e_sac,
            "e_base": e_base, "engine": engine}


if __name__ == "__main__":
    main()
