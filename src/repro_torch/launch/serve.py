"""Serving CLI of the port: batched generation on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --cim sim --attn-impl kernel [--kv-int8] [--requests 6] \\
      [--new-tokens 16] [--prompt-len 128] [--slots 4] [--reduced]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --cim sim --attn-impl kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --reduced --cim sim --attn-impl kernel --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --engine loop --reduced

``--cim sim`` serves the CIM macro model: the weights are deployed once as
int8 planes and every linear runs the config's sim path, as in the
reference. The configs leave ``cim.use_kernel`` False, so that is the
behavioural ``core.cim.cim_dense`` (exact integer dot plus one whole-K
``jax.random.normal`` draw, replayed by ``core.prng.normal``); a config
with ``use_kernel=True`` runs the fused CIM kernel with in-kernel
per-tile readout noise instead.
``--attn-impl kernel`` runs cached attention through the decode and flash
kernels, a deepseek-v2 decode step through the latent-cache MLA kernel,
and a mamba2 decode step through the selective-scan kernel;
``--kv-int8`` changes nothing for an attention-free model or for MLA's
latent cache, as in the reference. ``--engine fused`` (the default) is the
slot-batched ``Engine``: chunked prefill, and on the card the decode step
and each slot's chunk replayed as CUDA graphs where the family and path
allow (``fused_step``); ``--chunk-size 0`` prefills each prompt whole at
admission, per call. ``--engine loop`` is the reference's ``LoopEngine``
baseline (batch-1 caches, one forward per slot per token). Parameters are
random, drawn from ``--seed``. The entry point runs on the card; ``--device cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import init_params, plane_summary
from repro_torch.serving.engine import Engine, LoopEngine, Request, \
    RequestError


def _build_argparser():
    ap = argparse.ArgumentParser(
        description="CR-CIM serving on PyTorch: slot-batched engine with "
                    "chunked prefill")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="qwen2-0.5b (dense), mamba2-130m (ssm) or "
                         "deepseek-v2-236b (moe with MLA; 472 GB at full "
                         "width: --reduced)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--cim", default="off", choices=["off", "sim"])
    ap.add_argument("--attn-impl", default="config",
                    choices=["config", "einsum", "kernel"])
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="prefill chunk; 0 prefills each prompt whole at "
                         "admission")
    ap.add_argument("--engine", default="fused", choices=["fused", "loop"],
                    help="fused: the slot-batched Engine; loop: the "
                         "reference's LoopEngine baseline")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache with per-(token, head) scales "
                         "(no effect on mamba2, which has no KV cache, or "
                         "on deepseek-v2's latent cache)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def main(argv=None):
    args = _build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(
        cfg, kv_cache_int8=args.kv_int8,
        cim=dataclasses.replace(cfg.cim, mode=args.cim))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    kw = dict(max_slots=args.slots,
              max_len=args.prompt_len + args.new_tokens + 8,
              attn_impl=None if args.attn_impl == "config"
              else args.attn_impl, device=device)
    if args.engine == "loop":
        engine = LoopEngine(cfg, params, **kw)
    else:
        engine = Engine(cfg, params, chunk_size=args.chunk_size,
                        record_ttft=True, **kw)
    if engine.mode == "sim":
        ps = plane_summary(engine.params)
        print(f"deployed {ps['planes']} pre-quantized weight planes "
              f"({ps['int8_bytes'] / 2**20:.1f} MiB int8)")
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new_tokens=args.new_tokens, rid=f"req-{i}")
            for i in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    failed = [isinstance(o, RequestError) for o in outs]
    total = sum(len(o) for o, f in zip(outs, failed) if not f)
    print(f"[{device.type}] {args.engine} engine served {len(reqs)} "
          f"requests ({sum(failed)} failed), {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    ttfts = [t for t in getattr(engine, "ttft_s", []) if t is not None]
    if ttfts:
        print(f"  TTFT mean {np.mean(ttfts) * 1e3:.0f} ms / max "
              f"{np.max(ttfts) * 1e3:.0f} ms (chunk={engine.chunk_size})")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: " + (f"FAILED ({o})" if isinstance(o, RequestError)
                               else f"{o[:10]}..."))
    return outs


if __name__ == "__main__":
    main()
