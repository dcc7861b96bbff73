"""Slot-batched continuous-batching serving engine on PyTorch.

Twin of the fused ``Engine`` and the ``LoopEngine`` of
``src/repro/serving/engine.py`` for the dense, vlm, ssm, moe and hybrid
families (the vlm family served token-only, as the reference serves it;
encdec, whose requests would need encoder frames, raises ``ValueError`` as
in the reference). One stacked cache of batch ``max_slots`` is allocated
once (a KV or latent cache over-allocated to a chunk multiple, so a final
padded chunk never clamps back onto live keys; for mamba2 the conv window
and the f32 state; for zamba2 both).
Each scheduler iteration advances every still-prefilling slot by one
fixed-shape chunk of ``chunk_size`` tokens, in ascending slot order, then
runs ONE batch decode step over every slot: idle and prefilling rows ride
along, as in the reference, because sim-mode CIM noise depends on the
batch-global activation scale, and their lengths (and ssm window and
state) are restored afterwards. A prefill chunk tells the model how many
of its tokens are real (``Ctx.prefill_valid``), so the ssm state skips the
chunk's right-pad. ``chunk_size=0`` is the reference's whole-prompt path:
a request is prefilled at admission in one forward, right-padded to a
power-of-two bucket for the dense and vlm families and at its true length
for ssm, moe and hybrid.

The PRNG contract replays the reference bit for bit:

  * the engine key starts at ``PRNGKey(seed)``; each chunk, whole-prompt
    prefill and decode step draws ``key, k = split(key)`` in that order and
    keys its CIM noise context with ``split(k)[0]``;
  * a request's sampling key is ``fold_in(fold_in(PRNGKey(seed), 0x5A17),
    uid)`` with ``uid = crc32(rid)`` (or its submission index); token ``i``
    samples under ``fold_in(request key, i)``. Greedy rows (temperature 0)
    take the arg-max, ties to the first index.

Sim mode deploys the weights once into int8 planes at construction and
serves them on the CIM kernel (``cim.use_kernel=True``) or on the
behavioural ``core.cim.cim_dense`` (``use_kernel=False``), as the
reference does. On the kernel path of the dense, vlm, ssm and hybrid
families every
forward's noise seeds are one ``prng.seed_table`` (one vectorized host
call), staged with the forward's other host inputs (active mask, chunk
tokens, valid count) into one device buffer by one copy from pinned
memory; the kernels read their seeds there. ``fuse_layer=True`` runs
every decode step as one megakernel launch per layer
(``kernels/fused_step.py``) where the fused route applies: a dense float32
model with rope (``_use_fused_layer``) at a shape the kernel takes.

``fused_step`` is the reference's one-program step: on the card the
engine captures the batch decode step as one CUDA graph and each slot's
chunk forward as one graph (all in one memory pool; at most one replays at
a time), and replays them, chunks first in slot order, then the decode,
with the draw order of the per-call path. ``None`` (auto) takes it when
prefill is chunked and the family and path can be captured (dense, vlm,
ssm and hybrid, in off mode or on the CIM kernel path); ``True`` raises where it
cannot. The moe family and the behavioural path draw their noise through eager
ops keyed by host integers, which a replay would freeze, and serve
per-call. On the CPU the option runs the per-call path. A capture that
fails raises; a replay that raises turns the graphs off for the engine's
lifetime (``fused_ok = False``, ``fallbacks`` counts it) and the forward
runs per call. ``launch_count`` and ``iter_count`` count as the
reference's per-call path does (one per chunk, whole-prompt prefill,
decode and probe); ``replay_count`` counts graph replays, and
``step_log`` (``record_steps``) says per iteration whether every forward
was a replay (``"graph"``).

Every decode step freezes the rows it does not advance by the staged
active mask: the ``_FROZEN`` leaves (length, ssm window and state) are
copied into ``_frozen`` before the step and the inactive rows take them
back after it, on the replayed, per-call and probe paths alike. A batch
decode that raises is re-run once per active slot, under a solo active
mask and the same step key (``_isolate_decode``); a slot whose probe
still raises fails with ``RequestError(phase="decode")`` and the others
advance, as in the reference. The forward changes the caches in place as
it goes, so before each probe, and after a probe that raises, the
``_FROZEN`` leaves go back to ``_frozen``: a failure at any layer leaves
the surviving slots as the reference's functional step would. A failed
prefill fails its request only. Emitted tokens stay on the device until
drained (every ``drain_every`` pending entries and at the end of
``generate``).

Robustness, as in the reference: ``guard=`` runs every CIM linear under
the ABFT checksum guard (``core/guard.py``; sim mode, deployed planes;
dense, vlm, moe and ssm), and ``degrade=`` (``DegradePolicy``) escalates
per (slot, layer) on its hard trips: a (slot, layer) is pinned to the
digital path after ``pin_after`` of them, a request fails with a
``RequestError`` after ``fail_after`` steps with one.
``guard_trip_counts`` / ``guard_hard_counts`` sum the trips per layer,
``guard_report_of`` gives a finished request's. The guard needs per-slot
blame, so a guarded engine serves per call (``fused_step=True`` raises
``ValueError``). ``fault=`` (``core.faults.FaultSpec``) deploys stuck-at
planes and applies the runtime faults in every CIM call;
``fault_slots`` names the slots its ``transient_mag`` disturbs, and
``pin_slots`` serves slots on the digital path from the start.
``drift=`` (``core.drift.DriftSpec``) drifts the readout at the engine's
step counter ``drift_step`` (monotonic over the engine's life) and
``calib=`` (``core.calibrate.CalibPolicy``) runs the background
calibration and canary watchdog, at most one probe a step, outside the
step's graphs; ``take_drift_events``, ``calibrations``,
``watchdog_trips`` and ``drift_degraded`` report it. Under ``fused_step``
the drift step and the trims are device tensors the graphs read (the step
staged with the seeds, the trims written in place by a calibration), and
a brownout draws under a table of ``fold_in(key, 0x0FA1)`` staged beside
the seed table, so faults and drift replay as they run per call.

``deploy`` is the reference's: None deploys the planes in sim mode,
False serves sim mode on the float weights, quantized per call (the
behavioural path: no CIM kernel, no CUDA graphs), or on the planes of a
tree the caller deployed, which serves as the engine's own deploy would.

The front-end's surface (``serving/frontend.py``), as in the reference:
``Request.deadline`` (the caller's clock) and ``step(now)``, which expires
deadlines before it admits (``expire_deadlines``); ``cancel(r,
outcome=)`` with an outcome from ``OUTCOMES``; ``free_slots``,
``result_of``, ``status_of`` and ``error_of``. ``ladder=``
(``core.sac.DegradeLadder``) admits each request at its
``Request.degrade_level``, clamped to the ladder: in sim mode every CIM
linear adds the level's extra noise per row (``layers._degrade_noise``;
not with a guard or the fused layer). Under ``fused_step`` the per-slot
levels are staged with the seeds (``_Inputs.levels``), and on the
seed-table path the ladder's draw reads a staged table of the seeds
folded by ``0xD364``, so a level that changes between admissions
replays as it runs per call.

The replica surface the router drives (``serving/router.py``), as in the
reference: ``replica=`` labels the engine and is stamped on every
``RequestError`` it produces; ``kill(reason)`` simulates device loss
(every later ``step``/``drain_pending`` raises and the undrained tokens
are dropped), ``wedge()`` a hung launch queue (``step`` returns True and
advances nothing) until ``unwedge()``; ``replica_of`` names the label.
``cim_mode="qat"`` serves the forward the trainer runs: every CIM linear
through ``core.cim.cim_dense(mode="qat")`` (straight-through fake-quant
plus readout noise drawn under the layer's host key), on the float
weights (``deploy=None`` resolves to False; ``deploy=True`` raises the
reference's ``ValueError``). Its noise is eager ops keyed by host
integers, so it serves per call and ``fused_step=True`` raises.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.calibrate import (CalibPolicy, DriftController,
                                        max_plane_width)
from repro_torch.core.deploy import deploy as deploy_params
from repro_torch.core.deploy import plane_summary
from repro_torch.core.drift import DriftState
from repro_torch.core.faults import BROWNOUT_FOLD
from repro_torch.core.guard import GuardSpec
from repro_torch.core.sac import get_policy
from repro_torch.kernels.cim_matmul import cim_matmul_fused, cim_matmul_int8
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_gqa_attention)
from repro_torch.kernels.fused_step import fused_dense_layer
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.kernels.ssm_scan import ssm_decode_step
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DEGRADE_FOLD, Ctx

DEFAULT_CHUNK_SIZE = 32
DRAIN_EVERY = 64
# a request's terminal outcomes; "shed" is the front-end's alone
OUTCOMES = ("completed", "failed", "cancelled", "deadline_expired", "shed")
# prompt padding of the whole-prompt path: attention masks a right-pad,
# a recurrent state would absorb it (the reference's _BUCKETED_FAMILIES)
BUCKETED_FAMILIES = ("dense", "vlm")
# families whose forward a CUDA graph captures, and the CIM noise seeds a
# layer draws (q, k, v, o, gate, up, down; in_proj, out_proj; a hybrid
# super-block: in_proj, out_proj twice, then the shared block's seven)
SEEDS_PER_LAYER = {"dense": 7, "vlm": 7, "ssm": 2, "hybrid": 11}
# kernel wrappers whose launch counts a replay adds
COUNTED = (cim_matmul_fused, cim_matmul_int8, decode_attention,
           flash_gqa_attention, flash_attention, fused_dense_layer,
           mla_decode_attention, ssm_decode_step)
_UNGRAPHED = ("fused_step=True needs a forward that a CUDA graph can "
              "capture: the moe family, the behavioural sim path "
              "(cim.use_kernel=False), sim mode with deploy=False on float "
              "weights and cim_mode='qat' draw their noise through eager "
              "ops keyed by host integers, which a replay would freeze; "
              "ROADMAP.md queues them behind a device-keyed Threefry-normal "
              "kernel")


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request; compared by identity (the queue holds
    the caller's objects)."""

    prompt: np.ndarray           # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: Optional[List[int]] = None
    rid: Optional[str] = None    # stable id behind the sampling key
    degrade_level: int = 0       # ladder level (with ``Engine(ladder=)``)
    deadline: Optional[float] = None   # absolute, on ``step(now)``'s clock


@dataclasses.dataclass
class RequestError:
    """Structured per-request failure record: the phase it died in
    (submit | prefill | decode), its slot (None: still queued), the first
    hard-tripping layer when the guard failed it, whether a retry is worth
    it (a guard hard-fail, a persistent analog fault, is not) and the
    replica that produced it (None on a single engine)."""

    reason: str
    phase: str = "decode"
    slot: Optional[int] = None
    layer: Optional[int] = None
    retryable: bool = True
    replica: Optional[str] = None

    def __str__(self) -> str:
        where = f"slot={self.slot}" if self.slot is not None else "queued"
        lay = f", layer={self.layer}" if self.layer is not None else ""
        rep = f"{self.replica}:" if self.replica is not None else ""
        return f"[{rep}{self.phase}/{where}{lay}] {self.reason}"


@dataclasses.dataclass
class DegradePolicy:
    """Guard escalation per (slot, layer): after ``pin_after`` hard trips
    of a layer for a slot, that (slot, layer) serves on the digital path
    for the rest of the request (None: never pin); after ``fail_after``
    steps with any hard trip, the request fails (None: never)."""

    pin_after: Optional[int] = 1
    fail_after: Optional[int] = None


def _validate_requests(requests: List[Request], max_len: int) -> None:
    for i, r in enumerate(requests):
        prompt = np.asarray(r.prompt)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(
                f"request {i}: prompt must be a non-empty 1-D token "
                f"array, got shape {prompt.shape}")
        if r.max_new_tokens < 1:
            raise ValueError(
                f"request {i}: max_new_tokens must be >= 1, got "
                f"{r.max_new_tokens}")
        total = prompt.shape[0] + r.max_new_tokens
        if total > max_len:
            raise ValueError(
                f"request {i}: prompt length {prompt.shape[0]} + "
                f"max_new_tokens {r.max_new_tokens} = {total} overflows "
                f"the engine's max_len={max_len}")


def _request_uid(r: Request, fallback: int) -> int:
    if r.rid:
        return zlib.crc32(str(r.rid).encode()) & 0x7FFFFFFF
    return fallback & 0x7FFFFFFF


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _sample_tokens(logits: torch.Tensor, temps: List[float],
                   keys: List[Optional[prng.Key]]) -> torch.Tensor:
    """(B, V) logits + per-row temperatures and keys -> (B,) int64.

    Greedy rows take the arg-max (their keys are not read); sampled rows
    draw ``jax.random.categorical`` under their key (arg-max of the scaled
    logits plus Gumbel noise from the Threefry twin)."""
    toks = torch.argmax(logits, dim=-1)
    for row, (t, key) in enumerate(zip(temps, keys)):
        if t > 0:
            scaled = logits[row].to(torch.float32) / t
            g = prng.gumbel(key, tuple(scaled.shape), device=logits.device)
            toks[row] = torch.argmax(g + scaled)
    return toks


def _row_sample_keys(rkeys: List[prng.Key], tok_idx,
                     temps: Optional[List[float]] = None
                     ) -> List[Optional[prng.Key]]:
    """``fold_in(request key, token index)`` per row (None for the greedy
    rows of ``temps``, whose keys are never read)."""
    return [prng.fold_in(k, int(i)) if temps is None or temps[row] > 0
            else None for row, (k, i) in enumerate(zip(rkeys, tok_idx))]


def _launch_counts() -> Dict[Any, int]:
    return {fn: fn.launches for fn in COUNTED}


def _seed_units(cfg: ModelConfig) -> int:
    """Keyed units of a forward, each ``fold_in(key, i)``: the layers, or a
    hybrid's super-blocks."""
    if cfg.family == "hybrid":
        return tf.hybrid_dims(cfg)[0]
    return cfg.n_layers


def _seed_width(cfg: ModelConfig, mode: str, deployed: bool = True,
                guard=None) -> int:
    """Seed-table rows a layer draws on the CIM kernel path (deployed
    planes) of a family whose noise is all kernel-drawn (0: the forward
    keeps host keys; so does a guarded forward, whose re-reads fold their
    keys on the host)."""
    if (mode != "sim" or not cfg.cim.use_kernel or not deployed
            or guard is not None):
        return 0
    return SEEDS_PER_LAYER.get(cfg.family, 0)


def _ladder_draws(cfg: ModelConfig, mode: str, ladder) -> bool:
    """Whether a ladder's rungs add noise: sim mode, and a rung below the
    full votes of a CB operating point of the policy."""
    pol = get_policy(cfg.cim.policy) if mode == "sim" else None
    if ladder is None or pol is None:
        return False
    return any(spec is not None and spec.cb and v is not None
               and v < spec.adc.mv_votes
               for spec in (pol.attn, pol.mlp) for v in ladder.votes)


def _serves_planes(deployed: bool, mode: str, params: Any) -> bool:
    """Whether sim mode serves deployed planes: the engine deploys them,
    or the caller deployed the tree (``deploy=False`` over its planes),
    which serves as the engine's own deploy would."""
    return deployed or (mode == "sim" and isinstance(params, dict)
                        and plane_summary(params)["planes"] > 0)


def _resolve_deploy(deploy: Optional[bool], mode: str) -> bool:
    """None: deploy the planes for sim-mode serving; True requires sim."""
    if deploy is None:
        return mode == "sim"
    if deploy and mode != "sim":
        raise ValueError(
            f"deploy=True only affects cim_mode='sim' (got mode '{mode}'): "
            "pre-quantized weight planes are the sim-mode inference fast "
            "path; off/qat would silently ignore them")
    return bool(deploy)


class _Inputs:
    """The host inputs of one forward in one device buffer: the seed table
    (rows x 2 int32 words), the active mask (slots), the chunk's tokens,
    its valid count, the drift step, the ladder level of each slot and
    (``folds``: data -> view) the tables of the seeds folded by each
    constant in ``folds``, each a fixed view. ``put`` fills a pinned host
    copy (a ring of them, each reused only after its copy has run) and
    copies the whole buffer in one asynchronous copy on the current
    stream; on the CPU it writes the buffer itself."""

    RING = 8

    def __init__(self, device: torch.device, rows: int, slots: int,
                 chunk: int, folds: Tuple[int, ...] = ()):
        sizes = (2 * rows, slots, chunk, 1, 1, slots) + (2 * rows,) * len(
            folds)
        self.buf = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
        parts = torch.split(self.buf, sizes)
        seeds, self.act, self.tokens, self.valid, step, self.levels = \
            parts[:6]
        self.seeds = seeds.view(rows, 2)
        self.step = step[0]
        self.folds = {d: t.view(rows, 2) for d, t in zip(folds, parts[6:])}
        self._offsets = np.cumsum((0,) + sizes[:-1])
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._host = [torch.zeros(self.buf.numel(), dtype=torch.int32,
                                      pin_memory=True)
                          for _ in range(self.RING)]
            self._copied = [torch.cuda.Event() for _ in range(self.RING)]
            self._next = 0

    def put(self, seeds: Optional[np.ndarray] = None, act=None, tokens=None,
            valid: int = 0, step: int = 0, levels=None,
            folds: Optional[Dict[int, np.ndarray]] = None) -> None:
        if self._cuda:
            i = self._next
            self._next = (i + 1) % self.RING
            self._copied[i].synchronize()
            host = self._host[i]
        else:
            host = self.buf
        h = host.numpy()
        h[:] = 0
        s0, a0, t0, v0, st0, l0 = self._offsets[:6]
        if seeds is not None:
            h[s0:s0 + seeds.size] = seeds.reshape(-1)
        if act is not None:
            h[a0:a0 + len(act)] = act
        if tokens is not None:
            h[t0:t0 + tokens.size] = tokens.reshape(-1)
        h[v0] = valid
        h[st0] = step
        if levels is not None:
            h[l0:l0 + len(levels)] = levels
        for f0, d in zip(self._offsets[6:], self.folds):
            if folds is not None and d in folds:
                h[f0:f0 + folds[d].size] = folds[d].reshape(-1)
        if self._cuda:
            self.buf.copy_(host, non_blocking=True)
            self._copied[i].record()


class _Graph:
    """One captured forward: ``replay()`` replays it, adds the kernel
    launches it captured to the wrappers' counts and returns its static
    output (overwritten by the next replay)."""

    def __init__(self, fn, pool):
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fn()
        self.launches = {f: f.launches - n for f, n in before.items()
                         if f.launches != n}
        for f, n in before.items():      # a capture launches nothing
            f.launches = n

    def replay(self):
        self.graph.replay()
        for f, n in self.launches.items():
            f.launches += n
        return self.out


class Engine:
    """Fused slot-batched engine: per iteration, one chunk per prefilling
    slot, then one batch decode step for all slots (CUDA graphs of both
    with ``fused_step``)."""

    def __init__(self, cfg: ModelConfig, params: Any, max_slots: int = 4,
                 max_len: int = 512, cim_mode: Optional[str] = None,
                 seed: int = 0, attn_impl: Optional[str] = None,
                 chunk_size: Optional[int] = None,
                 record_ttft: bool = False, record_steps: bool = False,
                 fuse_layer: bool = False, fused_step: Optional[bool] = None,
                 guard: Any = None, degrade: Optional[DegradePolicy] = None,
                 fault: Any = None, fault_slots: Any = None,
                 pin_slots: Any = None, drift: Any = None, calib: Any = None,
                 ladder: Any = None, deploy: Optional[bool] = None,
                 drain_every: int = DRAIN_EVERY, device="cuda",
                 replica: Optional[str] = None, **unported):
        if unported:
            raise NotImplementedError(
                f"Engine options {sorted(unported)} are not ported yet; "
                "ROADMAP.md lists them as later work")
        # the label stamped on every RequestError this engine produces;
        # a killed engine has lost its device (step and drain raise), a
        # wedged one takes steps and advances nothing (the router's
        # watchdog tells)
        self.replica = replica
        self.dead: Optional[str] = None
        self.wedged = False
        self.device = resolve_device(device)
        cfg, mode = _resolve(cfg, cim_mode, attn_impl)
        self.deployed = _resolve_deploy(deploy, mode)
        self.drain_every = drain_every
        if fuse_layer:
            cfg = dataclasses.replace(cfg, fuse_layer=True)
        if chunk_size is None:
            chunk_size = DEFAULT_CHUNK_SIZE
        if chunk_size < 0:
            raise ValueError(f"chunk_size must be >= 0, got {chunk_size}")
        self.max_slots = max_slots
        self._robustness(cfg, mode, guard, degrade, fault, fault_slots,
                         pin_slots, drift, calib)
        self.ladder = ladder
        if ladder is not None:
            if self.guard is not None:
                raise ValueError(
                    "ladder and guard are mutually exclusive: guarded dense "
                    "bypasses the per-row degraded-vote noise path")
            if cfg.fuse_layer:
                raise ValueError(
                    "ladder requires fuse_layer=False: the per-layer "
                    "megakernel bypasses layers.dense, where the per-row "
                    "degraded-vote noise is applied")
        planes = _serves_planes(self.deployed, mode, params)
        graphable = cfg.family in SEEDS_PER_LAYER and (
            mode == "off" or cfg.cim.use_kernel and planes)
        if fused_step is None:
            fused_step = (chunk_size > 0 and graphable
                          and self.guard is None)
        elif fused_step and (chunk_size == 0 or self.guard is not None):
            raise ValueError(
                "fused_step=True requires chunked prefill (chunk_size > 0) "
                "and no guard: the step programs have no whole-prompt "
                "admission path and no per-slot failure isolation")
        elif fused_step and not graphable:
            raise NotImplementedError(_UNGRAPHED)
        self.cfg = cfg
        self.mode = mode
        self.max_slots = max_slots
        self.max_len = max_len
        self.chunk_size = int(chunk_size)
        self.record_ttft = record_ttft
        self.record_steps = record_steps
        self.fused_step = bool(fused_step)
        self.fused_ok = True
        self.fallbacks = 0
        self._alloc_len = (-(-max_len // self.chunk_size) * self.chunk_size
                           if self.chunk_size else max_len)
        self.key = prng.PRNGKey(seed)
        self._sample_base = prng.fold_in(prng.PRNGKey(seed), 0x5A17)
        self._width = _seed_width(cfg, mode, planes, self.guard)
        # a brownout draws under fold_in(key, 0x0FA1), the ladder under
        # fold_in(key, 0xD364): on the seed-table path each a staged table
        folds = ()
        if self._width and fault is not None and fault.brownout_rate > 0.0:
            folds += (BROWNOUT_FOLD,)
        if self._width and _ladder_draws(cfg, mode, ladder):
            folds += (DEGRADE_FOLD,)
        self._folds = folds
        self._inputs = _Inputs(self.device, _seed_units(cfg) * self._width,
                               max_slots, self.chunk_size, folds=folds)

        params = _to_device(params, self.device)
        self.params = (deploy_params(cfg, params, fault=fault,
                                     guard=self.guard or False)
                       if self.deployed else params)
        self._drift_ctl = None
        if self.calib is not None:
            pol = get_policy(cfg.cim.policy)
            probe_spec = pol.mlp if pol.mlp is not None else pol.attn
            if probe_spec is None:
                raise ValueError(
                    "calib needs at least one CIM-routed class in the SAC "
                    "policy to define the probe operating point")
            self._drift_ctl = DriftController(
                probe_spec, self.drift, self.calib,
                max_plane_width(self.params),
                use_kernel=cfg.cim.use_kernel, device=self.device)
        self.caches = tf.init_caches(cfg, max_slots, self._alloc_len,
                                     self.device)
        self.last_tok = torch.zeros((max_slots,), dtype=torch.int64,
                                    device=self.device)
        # the _FROZEN leaves as they were before the current decode step
        self._frozen = tf.freeze_all(self.caches)
        self._lvl_slot = np.zeros(max_slots, np.int32)   # staged by capture
        self._graphs: Optional[Dict[str, Any]] = None
        if self.fused_step and self.device.type == "cuda":
            self._capture()
        self.begin()

    def _robustness(self, cfg: ModelConfig, mode: str, guard, degrade,
                    fault, fault_slots, pin_slots, drift, calib) -> None:
        """Check and set the guard, fault and drift options, with the
        reference's rules and messages."""
        if guard is True:
            guard = GuardSpec()
        self.guard = guard or None
        if self.guard is not None:
            if mode != "sim" or not self.deployed:
                raise ValueError(
                    "guard requires cim_mode='sim' with deployed weight "
                    "planes — the ABFT checksum column is attached at "
                    "deploy time (core.deploy) and compares the *analog* "
                    "column sum")
            if cfg.family not in ("dense", "vlm", "moe", "ssm"):
                raise ValueError(
                    f"guard trip export rides the stacked layer stack; "
                    f"family '{cfg.family}' is not wired for it")
        if calib is True:
            calib = CalibPolicy()
        self.drift = drift or None
        self.calib = calib or None
        if self.drift is not None:
            if mode != "sim":
                raise ValueError(
                    "drift requires cim_mode='sim': temporal drift acts on "
                    "the analog readout chain — there is nothing to drift "
                    "on the digital path")
            if cfg.fuse_layer:
                raise ValueError(
                    "drift requires fuse_layer=False: the per-layer "
                    "megakernel bypasses the layers.dense dequant epilogue "
                    "where drift (and its trim correction) is applied")
        if self.calib is not None and self.drift is None:
            raise ValueError(
                "calib requires drift=: background calibration estimates "
                "trims against the temporal drift model")
        if self.calib is not None and not self.deployed:
            raise ValueError(
                "calib requires deployed weight planes: the trim width is "
                "the widest deployed macro plane (core.calibrate)")
        self.fault = fault
        self.fault_slots = frozenset(int(s) for s in (fault_slots or ()))
        self.pin_slots = frozenset(int(s) for s in (pin_slots or ()))
        if self.pin_slots and self.guard is None:
            raise ValueError("pin_slots requires guard: the digital bypass "
                             "is routed by the guarded dense")
        self.degrade = degrade if degrade is not None else (
            DegradePolicy() if self.guard is not None else None)
        self.guard_trip_counts = np.zeros(cfg.n_layers, np.int64)
        self.guard_hard_counts = np.zeros(cfg.n_layers, np.int64)
        self._frow_host = np.array([s in self.fault_slots
                                    for s in range(self.max_slots)])
        self.drift_step = 0
        self.drift_events: List[Dict[str, Any]] = []
        self.drift_degraded = False
        self._drift_pin_all = False

    # -------------------------------------------- incremental session API
    def begin(self) -> None:
        """Reset scheduler state for a fresh session. The device cache is
        not touched: a recycled slot is wiped by its first chunk (or its
        whole-prompt prefill). The drift clock runs on."""
        S = self.max_slots
        self._reqs: List[Request] = []
        self._req_index: Dict[int, int] = {}
        self._queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * S
        self._counts = [0] * S
        self._offsets = [0] * S
        self._decoding = [False] * S
        self._pend: List[Tuple[torch.Tensor, List[Optional[int]]]] = []
        self._rk_slot: List[prng.Key] = [(0, 0)] * S
        self._rkeys: List[prng.Key] = []
        self._lvl_slot = np.zeros(S, np.int32)    # ladder level per slot
        self._levels: List[int] = []               # and per request
        self.status: List[str] = []
        self.request_errors: List[Optional[RequestError]] = []
        self.ttft_s: List[Optional[float]] = []
        self.step_log: List[Dict[str, Any]] = []
        self.launch_count = 0
        self.iter_count = 0
        self.replay_count = 0
        self._t0 = time.perf_counter()
        self._turnover = False
        # guard state per (slot, layer), reset on recycle; the report of
        # each retired request
        L = self.cfg.n_layers
        self._pinned = np.zeros((S, L), bool)
        for s in self.pin_slots:
            self._pinned[s] = True
        self._hard_counts = np.zeros((S, L), np.int64)
        self._trip_counts = np.zeros((S, L), np.int64)
        self._fail_steps = np.zeros(S, np.int64)
        self.guard_report: Dict[int, Dict[str, Any]] = {}

    def submit(self, r: Request) -> int:
        _validate_requests([r], self.max_len)
        ri = len(self._reqs)
        self._reqs.append(r)
        self._req_index[id(r)] = ri
        r.out_tokens = []
        self._queue.append(r)
        self.status.append("queued")
        self.request_errors.append(None)
        self.ttft_s.append(None)
        self._rkeys.append(prng.fold_in(self._sample_base,
                                        _request_uid(r, ri)))
        lvl = 0
        if self.ladder is not None:
            lvl = min(max(int(r.degrade_level), 0), self.ladder.n_levels - 1)
        self._levels.append(lvl)
        return ri

    def cancel(self, r: Request, outcome: str = "cancelled") -> bool:
        """Withdraw a queued or running request between steps with a
        terminal ``outcome`` of ``OUTCOMES[1:]``; its slot is freed
        host-side (the next occupant's first chunk wipes it). Tokens
        already emitted stay in ``r.out_tokens``. Returns False if the
        request is unknown or already terminal."""
        if outcome not in OUTCOMES[1:]:
            raise ValueError(f"cancel outcome must be one of {OUTCOMES[1:]}")
        ri = self._req_index.get(id(r))
        if ri is None or self.status[ri] not in ("queued", "running"):
            return False
        if self.status[ri] == "queued":
            self._queue.remove(r)
        else:
            s = next(i for i, o in enumerate(self._slots) if o is r)
            self._capture_guard(s)
            self._free_slot(s)
            self._turnover = True
        self.status[ri] = outcome
        return True

    def expire_deadlines(self, now: float) -> int:
        """Cancel every request (queued, mid-prefill or mid-decode) whose
        ``deadline`` has passed at ``now``; returns the count."""
        n = 0
        live = list(self._queue) + [r for r in self._slots if r is not None]
        for r in live:
            if r.deadline is not None and now >= r.deadline:
                if self.cancel(r, outcome="deadline_expired"):
                    n += 1
        return n

    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)

    @property
    def free_slots(self) -> int:
        """Slots with no occupant and no queued request waiting for one:
        the front-end's admission headroom."""
        return sum(r is None for r in self._slots) - len(self._queue)

    def result_of(self, r: Request):
        """Terminal result: the token list, the ``RequestError``, or None
        while the request is live (or unknown)."""
        ri = self._req_index.get(id(r))
        if ri is None:
            return None
        st = self.status[ri]
        if st == "failed":
            return self.request_errors[ri]
        if st in ("queued", "running"):
            return None
        return r.out_tokens

    def status_of(self, r: Request) -> Optional[str]:
        """queued | running | completed | failed | cancelled |
        deadline_expired, or None for an unknown request."""
        ri = self._req_index.get(id(r))
        return None if ri is None else self.status[ri]

    def error_of(self, r: Request) -> Optional[RequestError]:
        ri = self._req_index.get(id(r))
        return None if ri is None else self.request_errors[ri]

    def step(self, now: Optional[float] = None) -> bool:
        """One scheduler iteration: expire deadlines (when ``now`` is
        given), admit from the queue (whole-prompt: prefill at admission),
        advance every prefilling slot by one chunk, run the batch decode.
        Returns True if any slot did work."""
        if self.dead is not None:
            raise RuntimeError(
                f"replica {self.replica or '?'} dead: {self.dead}")
        if self.wedged:
            return True
        if now is not None:
            self.expire_deadlines(now)
        self._fill_slots()
        if not any(r is not None for r in self._slots):
            return False
        self.iter_count += 1
        self._turnover = False
        t0 = time.perf_counter()
        launches, replays = self.launch_count, self.replay_count
        n_chunks, decoded = self._iteration()
        if self.drift is not None:
            # at most one calibration probe, then the macro's clock ticks
            self._drift_tick()
        if self.record_steps:
            self._sync()
            n = self.launch_count - launches
            self.step_log.append({
                "chunks": n_chunks, "decode": decoded,
                "s": time.perf_counter() - t0, "launches": n,
                "replays": self.replay_count - replays,
                "graph": n > 0 and self.replay_count - replays == n})
        if len(self._pend) >= self.drain_every:
            self.drain_pending()
        return True

    def kill(self, reason: str = "device lost") -> None:
        """Simulate whole-replica device loss: every later ``step`` and
        ``drain_pending`` raises, and the tokens still on the device are
        gone. In-flight requests are not failed here: the router migrates
        them, and their per-rid sampling keys replay the streams."""
        self.dead = reason
        self._pend.clear()

    def wedge(self) -> None:
        """Simulate a wedged launch queue: steps return without work."""
        self.wedged = True

    def unwedge(self) -> None:
        self.wedged = False

    def drain_pending(self) -> None:
        """Move emitted tokens device -> host into ``out_tokens`` lists
        (one transfer for all pending entries)."""
        if self.dead is not None:
            raise RuntimeError(
                f"replica {self.replica or '?'} dead: {self.dead}")
        if not self._pend:
            return
        flat = torch.cat([t.reshape(-1) for t, _ in self._pend]).tolist()
        i = 0
        for t, meta in self._pend:
            for ri in meta:
                if ri is not None:
                    self._reqs[ri].out_tokens.append(int(flat[i]))
                i += 1
        self._pend.clear()

    def generate(self, requests: List[Request]) -> List[Any]:
        """Run all requests to completion; returns generated token lists
        (a ``RequestError`` in place of a failed request)."""
        _validate_requests(requests, self.max_len)
        self.begin()
        for r in requests:
            self.submit(r)
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > 100_000:
                raise RuntimeError("serving engine ran away")
        self.drain_pending()
        return [self.request_errors[self._req_index[id(r)]]
                if self.status[self._req_index[id(r)]] == "failed"
                else r.out_tokens for r in requests]

    # ----------------------------------------------- drift + calibration
    def _dstate(self):
        """The drift state of a forward: the staged step and the
        controller's trims (None without a controller), one per forward
        (its fields are computed once a width), or None."""
        if self.drift is None:
            return None
        if self._drift_ctl is None:
            return DriftState(self._inputs.step)
        return DriftState(self._inputs.step, self._drift_ctl.trim_gain,
                          self._drift_ctl.trim_off)

    def _drift_tick(self) -> None:
        """Run the calibration and watchdog schedule for this step and
        advance the drift clock. An "escalate" event pins every (slot,
        layer) to the digital path when the guard is armed, or flags the
        engine degraded otherwise."""
        ctl = self._drift_ctl
        if ctl is not None:
            for e in ctl.tick(self.drift_step):
                e = dict(e)
                if e["kind"] == "escalate":
                    if self.guard is not None:
                        self._drift_pin_all = True
                        self._pinned[:, :] = True
                        e["action"] = "pin_digital"
                    else:
                        self.drift_degraded = True
                        e["action"] = "flag_degraded"
                self.drift_events.append(e)
        self.drift_step += 1

    def take_drift_events(self) -> List[Dict[str, Any]]:
        """Drain the calibration and watchdog events."""
        evs, self.drift_events = self.drift_events, []
        return evs

    @property
    def calibrations(self) -> int:
        return 0 if self._drift_ctl is None else self._drift_ctl.calibrations

    @property
    def watchdog_trips(self) -> int:
        return (0 if self._drift_ctl is None
                else self._drift_ctl.watchdog_trips)

    # ------------------------------------------------------------ guard
    def _reset_slot_guard(self, s: int) -> None:
        # a drift escalation pins the whole engine: a recycled slot stays
        # pinned
        self._pinned[s] = (s in self.pin_slots) or self._drift_pin_all
        self._hard_counts[s] = 0
        self._trip_counts[s] = 0
        self._fail_steps[s] = 0

    def _capture_guard(self, s: int) -> None:
        """Snapshot the retiring slot's guard counters for its request."""
        r = self._slots[s]
        if self.guard is None or r is None:
            return
        self.guard_report[self._req_index[id(r)]] = {
            "trips": int(self._trip_counts[s].sum()),
            "hard": int(self._hard_counts[s].sum()),
            "hard_layers": np.nonzero(self._hard_counts[s])[0].tolist()}

    def guard_report_of(self, r: Request) -> Optional[Dict[str, Any]]:
        """A retired request's guard outcome ({"trips", "hard",
        "hard_layers"}), or None."""
        ri = self._req_index.get(id(r))
        return None if ri is None else self.guard_report.get(ri)

    def replica_of(self, r: Request) -> Optional[str]:
        """The engine's own label (the router names the replica it
        dispatched to)."""
        return self.replica

    def _note_guard(self, ctx: Ctx, slot_cols) -> List[int]:
        """Fold one forward's (L, B) guard counts into the host state;
        ``slot_cols``: (slot, batch column) pairs. Returns the slots whose
        request just reached ``fail_after``."""
        t = ctx.guard_trips.cpu().numpy()
        h = ctx.guard_hard.cpu().numpy()
        self.guard_trip_counts += t.sum(axis=1).astype(np.int64)
        self.guard_hard_counts += h.sum(axis=1).astype(np.int64)
        dead = []
        pol = self.degrade
        for s, col in slot_cols:
            self._trip_counts[s] += t[:, col].astype(np.int64)
            hcol = h[:, col]
            if not hcol.any():
                continue
            self._hard_counts[s, hcol > 0] += 1
            if pol is not None and pol.pin_after is not None:
                self._pinned[s] |= self._hard_counts[s] >= pol.pin_after
            if pol is not None and pol.fail_after is not None:
                self._fail_steps[s] += 1
                if self._fail_steps[s] >= pol.fail_after:
                    dead.append(s)
        return dead

    def _guard_err(self, s: int, phase: str) -> RequestError:
        layers_hit = np.nonzero(self._hard_counts[s])[0]
        return RequestError(
            reason=f"guard hard-fail during {phase}", phase=phase, slot=s,
            layer=int(layers_hit[0]) if layers_hit.size else None,
            retryable=False)

    # ------------------------------------------------- scheduler internals
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_key(self) -> prng.Key:
        self.key, k = prng.split(self.key)
        return k

    def _ctx(self, key: prng.Key, rows: Optional[slice] = None) -> Ctx:
        """The CIM context of a forward keyed by ``key`` (split(key)[0]);
        on the seed-table path its draws read the staged table. ``rows``
        (slot rows of the forward's batch; None: every slot) selects the
        staged ladder levels and, under a guard, the pinned and disturbed
        rows."""
        ctx = Ctx.make(self.cfg, prng.split(key)[0], mode=self.mode,
                       deployed=self.deployed, guard=self.guard,
                       fault=self.fault)
        rows = slice(None) if rows is None else rows
        if self._width:
            ctx.seeds, ctx.seed_width = self._inputs.seeds, self._width
            ctx.seed_fold = self._inputs.folds or None
        if self.drift is not None:
            ctx.drift, ctx.drift_state = self.drift, self._dstate()
        if self.ladder is not None:
            ctx.degrade_levels = tuple(self.ladder.votes)
            ctx.degrade_rows = self._inputs.levels[rows]
        if self.guard is not None:
            ctx.pin_layers = torch.from_numpy(self._pinned[rows]).to(
                self.device)
            ctx.fault_rows = torch.from_numpy(self._frow_host[rows]).to(
                self.device)
        return ctx

    def _stage(self, key: Optional[prng.Key], **kw) -> None:
        """Stage a forward's host inputs: the seed table of ``key`` (and
        its folds) on the seed-table path, the drift step, every slot's
        ladder level, and ``kw`` (active mask, tokens, valid count)."""
        seeds = folds = None
        if self._width and key is not None:
            seeds = prng.seed_table(prng.split(key)[0],
                                    _seed_units(self.cfg), self._width)
            folds = {d: prng.fold_table(seeds, d) for d in self._folds}
        self._inputs.put(seeds=seeds, folds=folds, step=self.drift_step,
                         levels=self._lvl_slot, **kw)

    def _free_slot(self, s: int) -> None:
        self._slots[s] = None
        self._decoding[s] = False
        self._counts[s] = 0
        self._offsets[s] = 0
        self._rk_slot[s] = (0, 0)
        self._lvl_slot[s] = 0
        self._reset_slot_guard(s)

    def _finish_request(self, s: int) -> None:
        self.status[self._req_index[id(self._slots[s])]] = "completed"
        self._capture_guard(s)
        self._free_slot(s)
        self._turnover = True

    def _fail_request(self, s: int, err: RequestError) -> None:
        if err.replica is None:
            err.replica = self.replica
        ri = self._req_index[id(self._slots[s])]
        self.status[ri] = "failed"
        self.request_errors[ri] = err
        self._capture_guard(s)
        self._free_slot(s)

    def _fill_slots(self) -> None:
        for s in range(self.max_slots):
            while self._slots[s] is None and self._queue:
                r = self._queue.pop(0)
                ri = self._req_index[id(r)]
                self.status[ri] = "running"
                self._rk_slot[s] = self._rkeys[ri]
                self._lvl_slot[s] = self._levels[ri]
                self._reset_slot_guard(s)
                self._slots[s] = r
                if self.chunk_size > 0:
                    # the prompt streams through the main loop, one chunk
                    # an iteration
                    continue
                # whole-prompt admission; a failure fails this request
                # only, and the next occupant's prefill wipes the slot
                self.launch_count += 1
                try:
                    tok = self._prefill(s, r)
                except Exception as e:     # noqa: BLE001
                    self._fail_request(s, RequestError(
                        reason=f"prefill failed: {e!r}", phase="prefill",
                        slot=s))
                    continue
                if self._guard_failed(s, "prefill"):
                    continue
                self._pend.append((tok, [ri]))
                self._note_first_token(r)
                if r.max_new_tokens > 1:
                    self._counts[s] = 1
                    self._decoding[s] = True
                else:
                    self._finish_request(s)

    def _note_first_token(self, r: Request) -> None:
        if self.record_ttft:
            self._sync()
            self.ttft_s[self._req_index[id(r)]] = (
                time.perf_counter() - self._t0)

    def _iteration(self) -> Tuple[int, bool]:
        n_chunks, finished = self._prefill_chunks()
        if finished:
            self._fill_slots()
        act = [r is not None and self._decoding[s]
               for s, r in enumerate(self._slots)]
        if not any(act):
            if self._turnover:
                self._fill_slots()
            return n_chunks, False
        self._decode(act)
        if self._turnover:
            self._fill_slots()
        return n_chunks, True

    def _prefill_chunks(self) -> Tuple[int, bool]:
        """One chunk of progress for every still-prefilling slot, in slot
        order; returns (chunks run, whether any slot finished its prompt)."""
        n, finished = 0, False
        for s, r in enumerate(self._slots):
            if r is None or self._decoding[s]:
                continue
            prompt = np.asarray(r.prompt, np.int64)
            off = self._offsets[s]
            valid = min(self.chunk_size, prompt.shape[0] - off)
            chunk = np.zeros((self.chunk_size,), np.int64)
            chunk[:valid] = prompt[off:off + valid]
            is_final = off + valid >= prompt.shape[0]
            n += 1
            key = self._next_key()
            self.launch_count += 1
            try:
                tok = self._chunk(s, chunk, off == 0, valid, is_final,
                                  float(r.temperature), key)
            except Exception as e:         # noqa: BLE001
                # per-slot isolation, as in the reference: a failed chunk
                # fails this request only; the next occupant's first chunk
                # wipes the slot
                self._fail_request(s, RequestError(
                    reason=f"prefill chunk failed: {e!r}", phase="prefill",
                    slot=s))
                finished = True
                continue
            if self._guard_failed(s, "prefill"):
                finished = True
                continue
            self._offsets[s] = off + valid
            if is_final:
                self._pend.append((tok, [self._req_index[id(r)]]))
                self._note_first_token(r)
                if r.max_new_tokens > 1:
                    self._decoding[s] = True
                    self._counts[s] = 1
                else:
                    self._finish_request(s)
                finished = True
        return n, finished

    def _guard_failed(self, s: int, phase: str) -> bool:
        """Under a guard, fold slot ``s``'s batch-1 forward's counts in and
        fail its request if it reached ``fail_after``."""
        if self.guard is None or not self._note_guard(self._guard_ctx,
                                                      [(s, 0)]):
            return False
        self._fail_request(s, self._guard_err(s, phase))
        return True

    def _graphed(self) -> bool:
        return self._graphs is not None and self.fused_ok

    def _replay(self, graph: "_Graph"):
        """A graph's output, or None if the replay raised: the engine then
        serves per call for its lifetime, as the reference falls back when
        its step program raises."""
        try:
            out = graph.replay()
        except Exception:                  # noqa: BLE001
            self.fused_ok = False
            self.fallbacks += 1
            return None
        self.replay_count += 1
        return out

    def _commit_first(self, s: int, tok: torch.Tensor) -> None:
        # a new tensor: the pending token log may still hold the old one
        self.last_tok = self.last_tok.clone()
        self.last_tok[s] = tok

    def _chunk(self, s: int, chunk: np.ndarray, reset: bool, valid: int,
               is_final: bool, temp: float, key: prng.Key) -> torch.Tensor:
        """Advance slot ``s``'s prefill by one fixed-shape chunk, on views
        of its cache row. Returns the token sampled at the last valid
        position (committed to ``last_tok`` on the final chunk)."""
        self._stage(key, tokens=chunk, valid=valid)
        if reset:
            for t in tf.take_slot(self.caches, s).values():
                t.zero_()
        logits = None
        if self._graphed():
            logits = self._replay(self._graphs["chunk"][s])
        if logits is None:
            self._guard_ctx = self._ctx(key, slice(s, s + 1))
            logits = self._chunk_forward(s, self._guard_ctx)
        tok = _sample_tokens(logits[:, valid - 1], [temp],
                             _row_sample_keys([self._rk_slot[s]], [0],
                                              [temp]))[0]
        if is_final:
            self._commit_first(s, tok)
        return tok

    def _chunk_forward(self, s: int, ctx: Ctx) -> torch.Tensor:
        """Slot ``s``'s chunk forward from the staged tokens and valid
        count; the forward a chunk graph captures. Returns (1, C, V)."""
        ctx.prefill_valid = self._inputs.valid
        sl = tf.take_slot(self.caches, s)
        start = tf.cache_len(sl).clone()
        tokens = self._inputs.tokens.to(torch.int64)[None]
        logits, _ = tf.forward(self.params, {"tokens": tokens}, self.cfg,
                               ctx, sl)
        tf.set_cache_lens(sl, start + self._inputs.valid)
        return logits

    def _prefill(self, s: int, r: Request) -> torch.Tensor:
        """The whole-prompt path: slot ``s`` zeroed in full (a 1-token ssm
        prompt takes the decode branch, which reads the window and state),
        the prompt right-padded to its bucket, the token sampled at the
        last real position."""
        prompt = np.asarray(r.prompt, np.int64)
        true_len = prompt.shape[0]
        bucket = (min(_pow2_bucket(true_len), self.max_len)
                  if self.cfg.family in BUCKETED_FAMILIES else true_len)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :true_len] = prompt
        key = self._next_key()
        self._stage(key, valid=true_len)
        ctx = self._guard_ctx = self._ctx(key, slice(s, s + 1))
        ctx.prefill_valid = self._inputs.valid
        sl = tf.take_slot(self.caches, s)
        for t in sl.values():
            t.zero_()
        logits, _ = tf.forward(self.params,
                               {"tokens": torch.from_numpy(padded).to(
                                   self.device)}, self.cfg, ctx, sl)
        tf.set_cache_lens(sl, true_len)
        temp = float(r.temperature)
        tok = _sample_tokens(logits[:, true_len - 1], [temp],
                             _row_sample_keys([self._rk_slot[s]], [0],
                                              [temp]))[0]
        self._commit_first(s, tok)
        return tok

    def _decode(self, act: List[bool]) -> None:
        """One batch decode step over every slot; inactive rows keep their
        token, cache length and ssm window and state. A step that raises
        is re-run per active slot (``_isolate_decode``)."""
        tok_idx = list(self._counts)
        temps = [float(r.temperature) if r is not None else 0.0
                 for r in self._slots]
        key = self._next_key()
        self._stage(key, act=act)
        self.launch_count += 1
        self._snapshot()
        dead: Dict[int, RequestError] = {}
        gdead: List[int] = []
        try:
            logits = None
            if self._graphed():
                self._tok_in.copy_(self.last_tok)
                logits = self._replay(self._graphs["decode"])
                if logits is None:
                    self._restore()    # the failed replay may have run
            if logits is None:
                ctx = self._ctx(key)
                logits = self._decode_forward(ctx, self.last_tok)
                if self.guard is not None:
                    gdead = self._note_guard(
                        ctx, [(s, s) for s in range(self.max_slots)
                              if act[s]])
            toks = self._pick(logits, self.last_tok, temps, tok_idx)
        except Exception:                  # noqa: BLE001
            toks, dead = self._isolate_decode(act, key, temps, tok_idx)
        self.last_tok = toks
        self._pend.append((toks, [self._req_index[id(r)]
                                  if act[s] and s not in dead else None
                                  for s, r in enumerate(self._slots)]))
        for s, r in enumerate(self._slots):
            if r is None or not act[s]:
                continue
            if s in dead:
                self._fail_request(s, dead[s])
                self._turnover = True
                continue
            if s in gdead:
                self._fail_request(s, self._guard_err(s, "decode"))
                self._turnover = True
                continue
            self._counts[s] += 1
            if self._counts[s] >= r.max_new_tokens:
                self._finish_request(s)

    def _pick(self, logits: torch.Tensor, prev: torch.Tensor,
              temps: List[float], tok_idx: List[int]) -> torch.Tensor:
        """Sampled tokens of the staged active rows; the others keep
        ``prev``."""
        toks = _sample_tokens(logits, temps,
                              _row_sample_keys(self._rk_slot, tok_idx, temps))
        return torch.where(self._inputs.act != 0, toks, prev)

    def _snapshot(self) -> None:
        """``_frozen`` <- the caches' ``_FROZEN`` leaves."""
        for k, v in self._frozen.items():
            v.copy_(self.caches[k])

    def _restore(self) -> None:
        """The caches' ``_FROZEN`` leaves <- ``_frozen``: undoes what a
        decode forward that raised part way had advanced."""
        for k, v in self._frozen.items():
            self.caches[k].copy_(v)

    def _decode_forward(self, ctx: Ctx, tokens: torch.Tensor) -> torch.Tensor:
        """The batch decode forward from ``tokens`` (B,), the rows that
        the staged active mask leaves out frozen back to ``_frozen``; the
        forward the decode graph captures. Returns the (B, V) logits."""
        logits, _ = tf.forward(self.params, {"tokens": tokens[:, None]},
                               self.cfg, ctx, self.caches)
        tf.mask_cache_advance_by(self.caches, self._frozen,
                                 self._inputs.act != 0)
        return logits[:, -1]

    def _isolate_decode(self, act: List[bool], key: prng.Key,
                        temps: List[float], tok_idx: List[int]
                        ) -> Tuple[torch.Tensor, Dict[int, RequestError]]:
        """Per-slot blame for a failed batch decode, as the reference's
        ``_isolate_decode``: the step re-runs once per active slot under a
        solo active mask and the same step key, per call (each surviving
        row advances one token); a slot whose probe still raises is
        returned with its error. Each probe starts from ``_frozen``: the
        caches before the failed step, then after each surviving probe."""
        toks = self.last_tok
        dead: Dict[int, RequestError] = {}
        self._restore()
        for s in range(self.max_slots):
            if not act[s]:
                continue
            solo = [i == s for i in range(self.max_slots)]
            self.launch_count += 1
            try:
                self._stage(key, act=solo)
                ctx = self._ctx(key)
                logits = self._decode_forward(ctx, toks)
                toks = self._pick(logits, toks, temps, tok_idx)
                if self.guard is not None:
                    self._note_guard(ctx, [(s, s)])
            except Exception as e:         # noqa: BLE001
                dead[s] = RequestError(reason=f"decode step failed: {e!r}",
                                       phase="decode", slot=s)
                self._restore()
                continue
            self._snapshot()
        return toks, dead

    # ------------------------------------------------------ CUDA graphs
    def _capture(self) -> None:
        """Capture the decode step and every slot's chunk forward. One
        eager forward of each kind on a side stream first, so that the
        kernel library, the arrival counters, the rope table, the fused
        layer's occupancy query and cuBLAS's workspace exist before any
        capture (a fill inside a capture would only be recorded); then the
        captures, in one memory pool. The caches are zero again after it,
        as at construction. A capture that fails raises."""
        S = self.max_slots
        self._tok_in = torch.zeros((S,), dtype=torch.int64,
                                   device=self.device)
        ctx = self._ctx(prng.PRNGKey(0))
        self._stage(prng.PRNGKey(0), act=[True] * S,
                    tokens=np.zeros((self.chunk_size,), np.int64),
                    valid=self.chunk_size)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_forward(ctx, self._tok_in)
            self._chunk_forward(0, self._ctx(prng.PRNGKey(0), slice(0, 1)))
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        pool = torch.cuda.graph_pool_handle()
        try:
            graphs = {"decode": _Graph(
                lambda: self._decode_forward(self._ctx(prng.PRNGKey(0)),
                                             self._tok_in), pool)}
            graphs["chunk"] = [_Graph(
                lambda s=s: self._chunk_forward(s, self._ctx(
                    prng.PRNGKey(0), slice(s, s + 1))), pool)
                for s in range(S)]
        except Exception as e:
            raise RuntimeError(
                f"fused_step: capturing the step's CUDA graphs failed "
                f"({e!r}); Engine(fused_step=False) serves per call") from e
        for t in self.caches.values():
            t.zero_()
        torch.cuda.synchronize(self.device)
        self._graphs = graphs


class LoopEngine:
    """The reference's frozen seed engine: per-slot batch-1 caches, one
    decode forward per slot per token and a host sync per sampled token
    (a baseline beside ``Engine``). Its forwards key their CIM context
    with the step key itself (no split); sampling draws ``key, k =
    split(key)`` per sampled token. Known quirk, kept as the reference
    keeps it: a request with ``max_new_tokens == 1`` emits 2 tokens (the
    limit is checked only after the first decode). Failure contract: a
    prefill or decode that raises fails that request with a
    ``RequestError`` and frees its slot; the other slots go on."""

    def __init__(self, cfg: ModelConfig, params: Any, max_slots: int = 4,
                 max_len: int = 512, cim_mode: Optional[str] = None,
                 seed: int = 0, attn_impl: Optional[str] = None,
                 deploy: Optional[bool] = None, drift: Any = None,
                 calib: Any = None, device="cuda", **unported):
        if drift is not None or calib:
            raise ValueError(
                "LoopEngine has no drift/calibration path — temporal drift "
                "injection and background calibration are fused-Engine "
                "features (use Engine)")
        if unported:
            raise NotImplementedError(
                f"LoopEngine options {sorted(unported)} are not ported yet; "
                "ROADMAP.md lists them as later work")
        self.device = resolve_device(device)
        self.cfg, self.mode = _resolve(cfg, cim_mode, attn_impl)
        self.max_slots = max_slots
        self.max_len = max_len
        self.key = prng.PRNGKey(seed)
        self.deployed = _resolve_deploy(deploy, self.mode)
        self._width = _seed_width(self.cfg, self.mode, _serves_planes(
            self.deployed, self.mode, params))
        self._inputs = _Inputs(self.device,
                               _seed_units(self.cfg) * self._width, 0, 0)
        params = _to_device(params, self.device)
        self.params = (deploy_params(self.cfg, params) if self.deployed
                       else params)
        self.request_errors: List[Optional[RequestError]] = []

    def generate(self, requests: List[Request]) -> List[Any]:
        """Run all requests to completion; returns generated token lists
        (a ``RequestError`` in place of a failed request)."""
        _validate_requests(requests, self.max_len)
        queue = list(requests)
        for r in queue:
            r.out_tokens = []
        results: List[Any] = [None] * len(requests)
        req_index = {id(r): i for i, r in enumerate(requests)}
        self.request_errors = [None] * len(requests)
        slots: List[Optional[Request]] = [None] * self.max_slots
        caches: List[Any] = [None] * self.max_slots
        last_tok = [0] * self.max_slots

        def fail(s: int, r: Request, phase: str, e: Exception) -> None:
            ri = req_index[id(r)]
            err = RequestError(reason=f"{phase} failed: {e!r}", phase=phase,
                               slot=s)
            self.request_errors[ri] = err
            results[ri] = err
            slots[s] = None

        def fill():
            for s in range(self.max_slots):
                if slots[s] is None and queue:
                    r = queue.pop(0)
                    slots[s] = r
                    prompt = torch.as_tensor(np.asarray(r.prompt, np.int64),
                                             device=self.device)
                    try:
                        caches[s] = tf.init_caches(self.cfg, 1, self.max_len,
                                                   self.device)
                        logits = self._forward(prompt[None], caches[s])
                    except Exception as e:     # noqa: BLE001
                        fail(s, r, "prefill", e)
                        continue
                    last_tok[s] = self._sample(logits[0], r.temperature)
                    r.out_tokens.append(last_tok[s])

        fill()
        steps = 0
        while any(r is not None for r in slots):
            for s in range(self.max_slots):
                r = slots[s]
                if r is None:
                    continue
                try:
                    logits = self._forward(
                        torch.tensor([[last_tok[s]]], device=self.device),
                        caches[s])
                except Exception as e:         # noqa: BLE001
                    fail(s, r, "decode", e)
                    continue
                tok = self._sample(logits[0], r.temperature)
                r.out_tokens.append(tok)
                last_tok[s] = tok
                if len(r.out_tokens) >= r.max_new_tokens:
                    results[req_index[id(r)]] = r.out_tokens
                    slots[s] = None
            fill()
            steps += 1
            if steps > 10_000:
                raise RuntimeError("serving engine ran away")
        return results

    def _next_key(self) -> prng.Key:
        self.key, k = prng.split(self.key)
        return k

    def _forward(self, tokens: torch.Tensor, cache) -> torch.Tensor:
        """One forward of a batch-1 slot cache; the last position's
        logits (1, V)."""
        key = self._next_key()
        ctx = Ctx.make(self.cfg, key, mode=self.mode,
                       deployed=self.deployed)
        if self._width:
            self._inputs.put(seeds=prng.seed_table(
                key, _seed_units(self.cfg), self._width))
            ctx.seeds, ctx.seed_width = self._inputs.seeds, self._width
        logits, _ = tf.forward(self.params, {"tokens": tokens}, self.cfg,
                               ctx, cache)
        return logits[:, -1]

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        """``categorical(k, logits / temperature)`` in the logits' dtype, as
        the reference's ``LoopEngine`` draws (the temperature rounded to
        that dtype first, as JAX takes a Python float)."""
        if temperature <= 0:
            return int(torch.argmax(logits))
        k = self._next_key()
        scaled = logits / torch.tensor(float(temperature), dtype=logits.dtype,
                                       device=logits.device)
        g = prng.gumbel(k, tuple(scaled.shape), device=logits.device,
                        dtype=logits.dtype)
        return int(torch.argmax(g + scaled))


def _resolve(cfg: ModelConfig, cim_mode: Optional[str],
             attn_impl: Optional[str]) -> Tuple[ModelConfig, str]:
    """The config with an ``attn_impl`` override applied, and the CIM
    mode; raises on what the engines do not serve."""
    tf.check_family(cfg)
    if cfg.family == "encdec":
        raise ValueError("encdec serving needs per-request encoder frames; "
                         "the token-only engines don't carry them")
    if attn_impl is not None:
        if attn_impl not in ("einsum", "kernel"):
            raise ValueError(f"attn_impl must be 'einsum' or 'kernel', "
                             f"got {attn_impl!r}")
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    mode = cim_mode if cim_mode is not None else cfg.cim.mode
    if mode not in ("off", "qat", "sim"):
        raise ValueError(f"cim_mode must be 'off', 'qat' or 'sim', "
                         f"got {mode!r}")
    return cfg, mode


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
