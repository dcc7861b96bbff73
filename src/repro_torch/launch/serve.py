"""Serving CLI of the port: batched generation on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --cim sim --attn-impl kernel [--kv-int8] [--requests 6] \\
      [--new-tokens 16] [--prompt-len 128] [--slots 4] [--reduced]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --cim sim --attn-impl kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --reduced --cim sim --attn-impl kernel --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --cim sim --attn-impl kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --cim sim --attn-impl kernel
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
and a mamba2 (or zamba2 mamba layer's) decode step through the
selective-scan kernel;
``--kv-int8`` changes nothing for an attention-free model or for MLA's
latent cache, as in the reference. ``--engine fused`` (the default) is the
slot-batched ``Engine``: chunked prefill, and on the card the decode step
and each slot's chunk replayed as CUDA graphs where the family and path
allow (``fused_step``); ``--chunk-size 0`` prefills each prompt whole at
admission, per call. ``--engine loop`` is the reference's ``LoopEngine``
baseline (batch-1 caches, one forward per slot per token). Parameters are
random, drawn from ``--seed``. The entry point runs on the card; ``--device cpu`` runs the
kernels' plain versions. ``--arch whisper-medium`` (encdec) raises the
engine's ``ValueError``: its requests would need encoder frames, which the
token-only engines do not carry, as in the reference.

Robustness, with the reference's flags and meanings (``--engine fused``,
``--cim sim``): ``--guard`` runs every CIM linear under the ABFT checksum
guard and its ladder (``--guard-segments G`` per-segment checksums,
``--fail-after N`` fails a request after N hard-tripping steps) and
prints the per-layer trip and hard counts; ``--fault-stuck`` (stuck-at
bitcell rate of the deployed planes), ``--fault-transient`` (disturbance
in output sigmas on the slots of ``--fault-slot``) and ``--fault-seed``
inject faults; ``--drift-walk``, ``--drift-walk-offset``, ``--drift-temp``,
``--drift-supply`` / ``--drift-supply-every`` and ``--drift-seed`` drift
the readout, and ``--calibrate`` (``--calib-every``, ``--canary-every``)
runs the background calibration and canary watchdog against it:

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --cim sim \
      --device cpu --guard --fault-transient 64 --fault-slot 1
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --cim sim \
      --device cpu --drift-walk 0.02 --drift-supply 8 \
      --drift-supply-every 16 --calibrate --calib-every 32

``--frontend`` serves through the asyncio front-end
(``serving/frontend.py``) instead of one ``generate()`` call: bounded
admission (``--queue-limit``; overflow is shed with its reason),
per-request deadlines (``--deadline-s``) and TTFT budgets
(``--ttft-budget-s``), retries with backoff (``--retries``), arrivals
spaced by ``--stagger-s`` and a graceful drain on SIGINT/SIGTERM bounded
by ``--drain-deadline-s``. ``--ladder`` (``--ladder-votes``, the vote
counts of rungs 1..) lets the backlog's watermarks (``--high-watermark``,
``--low-watermark``) admit requests at reduced CB votes: in sim mode each
degraded row's CIM linears add the extra noise of its vote count (not with
``--guard``). The run prints every ticket's record and the metrics
summary. ``--temperature`` samples (0: greedy), ``--deploy off`` serves
sim mode on the float weights, quantized per call:

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --cim sim --frontend --ladder --requests 6

``--replicas N`` serves through ``N`` engine replicas of one seed behind
the health-aware ``ReplicaRouter`` (``serving/router.py``), each with
``--slots`` slots, on one card (fused engine only); the front-end's
records then name each request's replica (``rep=``) and its migrations:

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --replicas 2 --frontend
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.core.calibrate import CalibPolicy
from repro_torch.core.deploy import init_params, plane_summary
from repro_torch.core.drift import DriftSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.guard import GuardSpec
from repro_torch.core.sac import DegradeLadder
from repro_torch.serving.engine import DegradePolicy, Engine, LoopEngine, \
    Request, RequestError


def _build_argparser():
    ap = argparse.ArgumentParser(
        description="CR-CIM serving on PyTorch: slot-batched engine with "
                    "chunked prefill")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="qwen2-0.5b, internlm2-1.8b, phi3-mini-3.8b, "
                         "deepseek-67b (dense; 126 GB at full depth), "
                         "pixtral-12b (vlm backbone, served token-only), "
                         "mamba2-130m (ssm), olmoe-1b-7b (moe with GQA) or "
                         "deepseek-v2-236b (moe with MLA; 472 GB at full "
                         "width: --reduced), zamba2-7b (hybrid); "
                         "whisper-medium (encdec) is not served; an arch "
                         "that does not fit the card needs --reduced")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument(
        "--replicas", type=int, default=1,
        help="data-parallel Engine replicas behind the health-aware "
             "ReplicaRouter (serving/router.py); each replica owns --slots "
             "slots and the same seed, so failover migration replays "
             "streams bit-for-bit in off mode")
    ap.add_argument("--cim", default="off", choices=["off", "qat", "sim"],
                    help="qat: the training forward (fake-quant plus "
                         "readout noise), served per call on the float "
                         "weights")
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
    ap.add_argument("--guard", action="store_true",
                    help="ABFT checksum guard and its ladder on every CIM "
                         "matmul (fused engine, --cim sim only)")
    ap.add_argument("--guard-segments", type=int, default=1,
                    help="checksum segments per plane (needs --guard)")
    ap.add_argument("--fault-stuck", type=float, default=0.0,
                    help="stuck-at bitcell rate of the deployed planes")
    ap.add_argument("--fault-transient", type=float, default=0.0,
                    help="transient disturbance (layer output sigmas) on "
                         "the slots named by --fault-slot")
    ap.add_argument("--fault-slot", type=int, action="append", default=None,
                    help="slot hit by the transient fault (repeatable)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault scenario seed")
    ap.add_argument("--fail-after", type=int, default=0,
                    help="fail a request after this many hard-tripping "
                         "steps (0: never; serve on the digital recompute)")
    ap.add_argument("--drift-walk", type=float, default=0.0,
                    help="per-column gain random-walk std at the horizon "
                         "(fused engine, --cim sim only)")
    ap.add_argument("--drift-walk-offset", type=float, default=0.0,
                    help="per-column offset random-walk std, in readout "
                         "sigmas")
    ap.add_argument("--drift-temp", type=float, default=0.0,
                    help="temperature-excursion gain amplitude")
    ap.add_argument("--drift-supply", type=float, default=0.0,
                    help="supply-step offset magnitude (readout sigmas); "
                         "pairs with --drift-supply-every")
    ap.add_argument("--drift-supply-every", type=int, default=0,
                    help="steps between supply steps (0: none)")
    ap.add_argument("--drift-seed", type=int, default=0,
                    help="drift trajectory seed")
    ap.add_argument("--calibrate", action="store_true",
                    help="background calibration and canary watchdog "
                         "against the drift (needs a --drift-* model)")
    ap.add_argument("--calib-every", type=int, default=256,
                    help="full-calibration cadence in engine steps")
    ap.add_argument("--canary-every", type=int, default=8,
                    help="canary cadence in engine steps (0 disables)")
    ap.add_argument("--deploy", default="auto", choices=["auto", "on", "off"],
                    help="pre-quantize the CIM weights once at engine "
                         "construction; 'auto' deploys with --cim sim")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy)")
    ap.add_argument("--frontend", action="store_true",
                    help="serve through the asyncio front-end: bounded "
                         "admission, deadlines and TTFT budgets, retries, "
                         "streaming, graceful drain on SIGINT/SIGTERM "
                         "(fused engine only)")
    ap.add_argument("--queue-limit", type=int, default=16,
                    help="front-end admission backlog bound; overflow is "
                         "shed with a structured reason")
    ap.add_argument("--high-watermark", type=int, default=None,
                    help="backlog depth at which the ladder climbs one "
                         "rung a tick (default queue-limit // 2)")
    ap.add_argument("--low-watermark", type=int, default=None,
                    help="backlog depth below which the ladder descends "
                         "(default high-watermark // 2)")
    ap.add_argument("--ladder", action="store_true",
                    help="load-adaptive CB vote degradation: admissions "
                         "above the high watermark run reduced majority "
                         "votes (extra readout noise in sim mode); not "
                         "with --guard")
    ap.add_argument("--ladder-votes", default="3,1",
                    help="vote counts of ladder rungs 1.. (rung 0 is full "
                         "votes), strictly decreasing, e.g. '3,1'")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline, seconds from submission")
    ap.add_argument("--ttft-budget-s", type=float, default=None,
                    help="per-request time-to-first-token budget")
    ap.add_argument("--retries", type=int, default=1,
                    help="retries of a retryable failure (the same token "
                         "stream, keyed by the request id)")
    ap.add_argument("--drain-deadline-s", type=float, default=10.0,
                    help="graceful-drain bound after stop or SIGINT")
    ap.add_argument("--stagger-s", type=float, default=0.0,
                    help="spacing of arrivals in --frontend mode (0: all "
                         "at once)")
    return ap


def _drift_from_args(args):
    if not (args.drift_walk or args.drift_walk_offset or args.drift_temp
            or (args.drift_supply and args.drift_supply_every)):
        return None
    return DriftSpec(seed=args.drift_seed, walk_gain_std=args.drift_walk,
                     walk_offset_std=args.drift_walk_offset,
                     temp_gain_amp=args.drift_temp,
                     supply_offset_mag=args.drift_supply,
                     supply_every=args.drift_supply_every)


def _robust_kw(args) -> dict:
    """The Engine's robustness options from the CLI flags, as the
    reference's ``_build_engine`` builds them."""
    kw = {}
    drift = _drift_from_args(args)
    faulted = args.fault_stuck > 0.0 or args.fault_transient > 0.0
    if args.engine != "fused":
        if args.guard or args.ladder or faulted:
            raise SystemExit("--guard/--ladder/--fault-* need the fused "
                             "engine (--engine fused): the loop reference "
                             "engine has no guard or ladder path")
        if drift is not None or args.calibrate:
            raise SystemExit("--drift-*/--calibrate need the fused engine "
                             "(--engine fused): the loop reference engine "
                             "has no drift or calibration path")
        return kw
    if args.guard:
        kw["guard"] = (GuardSpec(segments=args.guard_segments)
                       if args.guard_segments > 1 else True)
        if args.fail_after > 0:
            kw["degrade"] = DegradePolicy(pin_after=1,
                                          fail_after=args.fail_after)
    if args.ladder:
        votes = tuple(int(v) for v in args.ladder_votes.split(",") if v)
        kw["ladder"] = DegradeLadder(votes=(None,) + votes)
    if faulted:
        kw["fault"] = FaultSpec(seed=args.fault_seed,
                                stuck_rate=args.fault_stuck,
                                transient_mag=args.fault_transient)
        kw["fault_slots"] = args.fault_slot or ()
    if drift is not None:
        kw["drift"] = drift
    if args.calibrate:
        if drift is None:
            raise SystemExit("--calibrate needs a drift model "
                             "(--drift-walk/--drift-temp/--drift-supply)")
        kw["calib"] = CalibPolicy(every_steps=args.calib_every,
                                  canary_every=args.canary_every)
    return kw


def _report(engine, reqs) -> None:
    """The guard's counts and the drift controller's events, as the
    reference's CLI prints them."""
    if getattr(engine, "guard", None) is not None:
        trips, hard = engine.guard_trip_counts, engine.guard_hard_counts
        print(f"  guard: per-layer trips {trips.tolist()} / "
              f"hard {hard.tolist()} "
              f"(total {int(trips.sum())}/{int(hard.sum())})")
        for i, r in enumerate(reqs):
            rep = engine.guard_report_of(r)
            if rep is not None and (rep["trips"] or rep["hard"]):
                print(f"  req{i}: guard trips={rep['trips']} "
                      f"hard={rep['hard']} layers={rep['hard_layers']}")
    if getattr(engine, "drift", None) is not None:
        evs = engine.take_drift_events()
        cals = [e for e in evs if e["kind"] == "calibrate"]
        trips_w = [e for e in evs if e["kind"] == "watchdog_trip"]
        print(f"  drift: {engine.drift_step} steps, "
              f"{len(cals)} calibrations, {len(trips_w)} watchdog trips"
              + (", ESCALATED to digital" if engine.drift_degraded
                 or getattr(engine, "_drift_pin_all", False) else ""))
        for e in evs[:8]:
            q = e.get("quality")
            print(f"    step {e['step']}: {e['kind']}"
                  + (f" quality={q:.2f}" if q is not None else "")
                  + (f" [{e['action']}]" if "action" in e else ""))


async def _run_frontend(args, engine, cfg):
    """Serve ``args.requests`` requests through the front-end; print each
    ticket's record and the metrics summary. Returns the tickets."""
    from repro_torch.serving.frontend import Frontend
    fe = Frontend(engine, queue_limit=args.queue_limit,
                  high_watermark=args.high_watermark,
                  low_watermark=args.low_watermark,
                  default_ttft_budget_s=args.ttft_budget_s,
                  max_retries=args.retries,
                  drain_deadline_s=args.drain_deadline_s)
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, fe.stop)
        except (NotImplementedError, RuntimeError):
            pass    # no unix signals: ctrl-C raises KeyboardInterrupt
    runner = asyncio.create_task(fe.run())
    rng = np.random.default_rng(args.seed)
    tickets = []
    t0 = time.perf_counter()
    for i in range(args.requests):
        tickets.append(fe.submit(
            list(rng.integers(0, cfg.vocab_size, args.prompt_len)),
            args.new_tokens, temperature=args.temperature, rid=f"req-{i}",
            timeout_s=args.deadline_s))
        if args.stagger_s > 0:
            await asyncio.sleep(args.stagger_s)
    await asyncio.gather(*(t.wait() for t in tickets))
    fe.stop()
    await runner
    dt = time.perf_counter() - t0
    total = sum(len(t.tokens) for t in tickets)
    print(f"[frontend] {len(tickets)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    for t in tickets:
        r = t.record
        print(f"  {t.rid}: {r.outcome:<16} wait={r.queue_wait_s or 0:.3f}s "
              f"ttft={'-' if r.ttft_s is None else f'{r.ttft_s:.3f}s'} "
              f"toks={r.tokens_out} votes={r.votes_used} "
              f"retries={r.retries}"
              + (f" rep={r.replica}" if r.replica is not None else "")
              + (f" migrations={r.migrations}" if r.migrations else "")
              + (f" guard={r.guard_trips}/{r.guard_hard}"
                 if r.guard_trips is not None else "")
              + (f"  [{r.reason}]" if r.reason else ""))
    s = fe.metrics.summary()
    print(f"  summary: outcomes={s['outcomes']} "
          f"queue_wait_p99={s['queue_wait_p99_s']} "
          f"ttft_p99={s['ttft_p99_s']} "
          f"degraded={s['degraded_admissions']} "
          f"transitions={s['ladder_transitions']}")
    if getattr(engine, "drift", None) is not None:
        print(f"  drift: {engine.drift_step} steps, "
              f"calibrations={s['calibrations']} "
              f"watchdog_trips={s['watchdog_trips']} "
              f"escalations={s['drift_escalations']}")
        for c in fe.metrics.calibrations[:8]:
            q = c.quality
            print(f"    step {c.step}: {c.kind}"
                  + (f" quality={q:.2f}" if q is not None else ""))
    return tickets


def main(argv=None):
    args = _build_argparser().parse_args(argv)
    if args.frontend and args.engine != "fused":
        raise SystemExit("--frontend needs the fused engine (--engine "
                         "fused): the front-end drives the incremental "
                         "session API")
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
              else args.attn_impl,
              deploy={"auto": None, "on": True, "off": False}[args.deploy],
              device=device)
    robust = _robust_kw(args)
    if args.replicas > 1:
        if args.engine != "fused":
            raise SystemExit("--replicas needs the fused engine "
                             "(--engine fused): the router speaks the "
                             "incremental session API")
        from repro_torch.serving.router import ReplicaRouter, build_pool
        engine = ReplicaRouter(build_pool(
            cfg, params, args.replicas, chunk_size=args.chunk_size,
            record_ttft=True, **robust, **kw))
    elif args.engine == "loop":
        engine = LoopEngine(cfg, params, **kw)
    else:
        engine = Engine(cfg, params, chunk_size=args.chunk_size,
                        record_ttft=True, **robust, **kw)
    if engine.deployed:
        ps = plane_summary(engine.params)
        print(f"deployed {ps['planes']} pre-quantized weight planes "
              f"({ps['int8_bytes'] / 2**20:.1f} MiB int8)")
    if args.frontend:
        return asyncio.run(_run_frontend(args, engine, cfg))
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature, rid=f"req-{i}")
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
    # a router's TTFTs are its replicas' (a migrated request's twice)
    engines = getattr(engine, "engines", [engine])
    ttfts = [t for e in engines for t in getattr(e, "ttft_s", [])
             if t is not None]
    if ttfts:
        print(f"  TTFT mean {np.mean(ttfts) * 1e3:.0f} ms / max "
              f"{np.max(ttfts) * 1e3:.0f} ms "
              f"(chunk={engines[0].chunk_size})")
    _report(engine, reqs)
    rep_of = getattr(engine, "replica_of", lambda r: None)
    for i, o in enumerate(outs[:4]):
        rep = rep_of(reqs[i])
        print(f"  req{i}: " + (f"FAILED ({o})" if isinstance(o, RequestError)
                               else f"{o[:10]}...")
              + (f" rep={rep}" if rep is not None else ""))
    return outs


if __name__ == "__main__":
    main()
