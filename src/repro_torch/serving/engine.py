"""Slot-batched continuous-batching serving engine on PyTorch.

Twin of the fused ``Engine`` and the ``LoopEngine`` of
``src/repro/serving/engine.py`` for the dense, ssm and moe (MLA) families.
One stacked cache of batch ``max_slots`` is allocated once (a KV or latent
cache over-allocated to a chunk multiple, so a final padded chunk never
clamps back onto live keys; for mamba2 the conv window and the f32 state).
Each scheduler iteration advances every still-prefilling slot by one
fixed-shape chunk of ``chunk_size`` tokens, in ascending slot order, then
runs ONE batch decode step over every slot: idle and prefilling rows ride
along, as in the reference, because sim-mode CIM noise depends on the
batch-global activation scale, and their lengths (and ssm window and
state) are restored afterwards. A prefill chunk tells the model how many
of its tokens are real (``Ctx.prefill_valid``), so the ssm state skips the
chunk's right-pad. ``chunk_size=0`` is the reference's whole-prompt path:
a request is prefilled at admission in one forward, right-padded to a
power-of-two bucket for the dense family and at its true length for ssm
and moe.

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
reference does. On the kernel path of the dense and ssm families every
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
prefill is chunked and the family and path can be captured (dense and ssm,
in off mode or on the CIM kernel path); ``True`` raises where it cannot.
The moe family and the behavioural path draw their noise through eager
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
drained (every ``DRAIN_EVERY`` pending entries and at the end of
``generate``).

Not in this slice (they raise ``NotImplementedError``, see ROADMAP.md):
the ABFT guard, the degradation ladder, fault and drift injection,
calibration and replica failover.
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
from repro_torch.core.deploy import deploy as deploy_params
from repro_torch.kernels.cim_matmul import cim_matmul_fused, cim_matmul_int8
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_gqa_attention)
from repro_torch.kernels.fused_step import fused_dense_layer
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.kernels.ssm_scan import ssm_decode_step
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx

DEFAULT_CHUNK_SIZE = 32
DRAIN_EVERY = 64
# prompt padding of the whole-prompt path: attention masks a right-pad,
# a recurrent state would absorb it (the reference's _BUCKETED_FAMILIES)
BUCKETED_FAMILIES = ("dense", "vlm")
# families whose forward a CUDA graph captures, and the CIM noise seeds a
# layer draws (q, k, v, o, gate, up, down; in_proj, out_proj)
SEEDS_PER_LAYER = {"dense": 7, "ssm": 2}
# kernel wrappers whose launch counts a replay adds
COUNTED = (cim_matmul_fused, cim_matmul_int8, decode_attention,
           flash_gqa_attention, flash_attention, fused_dense_layer,
           mla_decode_attention, ssm_decode_step)
_UNGRAPHED = ("fused_step=True needs a forward that a CUDA graph can "
              "capture: the moe family and the behavioural sim path "
              "(cim.use_kernel=False) draw their noise through eager ops "
              "keyed by host integers, which a replay would freeze; "
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


@dataclasses.dataclass
class RequestError:
    """Structured per-request failure record."""

    reason: str
    phase: str
    slot: Optional[int] = None

    def __str__(self) -> str:
        return f"[{self.phase}/slot={self.slot}] {self.reason}"


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


def _seed_width(cfg: ModelConfig, mode: str) -> int:
    """Seed-table rows a layer draws on the CIM kernel path of a family
    whose noise is all kernel-drawn (0: the forward keeps host keys)."""
    if mode != "sim" or not cfg.cim.use_kernel:
        return 0
    return SEEDS_PER_LAYER.get(cfg.family, 0)


class _Inputs:
    """The host inputs of one forward in one device buffer: the seed table
    (rows x 2 int32 words), the active mask (slots), the chunk's tokens
    and its valid count, each a fixed view. ``put`` fills a pinned host
    copy (a ring of them, each reused only after its copy has run) and
    copies the whole buffer in one asynchronous copy on the current
    stream; on the CPU it writes the buffer itself."""

    RING = 8

    def __init__(self, device: torch.device, rows: int, slots: int,
                 chunk: int):
        sizes = (2 * rows, slots, chunk, 1)
        self.buf = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
        seeds, self.act, self.tokens, self.valid = torch.split(self.buf,
                                                               sizes)
        self.seeds = seeds.view(rows, 2)
        self._offsets = np.cumsum((0,) + sizes[:-1])
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._host = [torch.zeros(self.buf.numel(), dtype=torch.int32,
                                      pin_memory=True)
                          for _ in range(self.RING)]
            self._copied = [torch.cuda.Event() for _ in range(self.RING)]
            self._next = 0

    def put(self, seeds: Optional[np.ndarray] = None, act=None, tokens=None,
            valid: int = 0) -> None:
        if self._cuda:
            i = self._next
            self._next = (i + 1) % self.RING
            self._copied[i].synchronize()
            host = self._host[i]
        else:
            host = self.buf
        h = host.numpy()
        h[:] = 0
        s0, a0, t0, v0 = self._offsets
        if seeds is not None:
            h[s0:s0 + seeds.size] = seeds.reshape(-1)
        if act is not None:
            h[a0:a0 + len(act)] = act
        if tokens is not None:
            h[t0:t0 + tokens.size] = tokens.reshape(-1)
        h[v0] = valid
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
                 device="cuda", **unported):
        if unported:
            raise NotImplementedError(
                f"Engine options {sorted(unported)} are not ported yet; "
                "ROADMAP.md lists them as later work")
        self.device = resolve_device(device)
        cfg, mode = _resolve(cfg, cim_mode, attn_impl)
        if fuse_layer:
            cfg = dataclasses.replace(cfg, fuse_layer=True)
        if chunk_size is None:
            chunk_size = DEFAULT_CHUNK_SIZE
        if chunk_size < 0:
            raise ValueError(f"chunk_size must be >= 0, got {chunk_size}")
        graphable = cfg.family in SEEDS_PER_LAYER and (
            mode == "off" or cfg.cim.use_kernel)
        if fused_step is None:
            fused_step = chunk_size > 0 and graphable
        elif fused_step and chunk_size == 0:
            raise ValueError(
                "fused_step=True requires chunked prefill (chunk_size > 0): "
                "the step programs have no whole-prompt admission path")
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
        self._width = _seed_width(cfg, mode)
        self._inputs = _Inputs(self.device, cfg.n_layers * self._width,
                               max_slots, self.chunk_size)

        params = _to_device(params, self.device)
        self.params = deploy_params(cfg, params) if mode == "sim" else params
        self.caches = tf.init_caches(cfg, max_slots, self._alloc_len,
                                     self.device)
        self.last_tok = torch.zeros((max_slots,), dtype=torch.int64,
                                    device=self.device)
        # the _FROZEN leaves as they were before the current decode step
        self._frozen = tf.freeze_all(self.caches)
        self._graphs: Optional[Dict[str, Any]] = None
        if self.fused_step and self.device.type == "cuda":
            self._capture()
        self.begin()

    # -------------------------------------------- incremental session API
    def begin(self) -> None:
        """Reset scheduler state for a fresh session. The device cache is
        not touched: a recycled slot is wiped by its first chunk (or its
        whole-prompt prefill)."""
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
        self.status: List[str] = []
        self.request_errors: List[Optional[RequestError]] = []
        self.ttft_s: List[Optional[float]] = []
        self.step_log: List[Dict[str, Any]] = []
        self.launch_count = 0
        self.iter_count = 0
        self.replay_count = 0
        self._t0 = time.perf_counter()
        self._turnover = False

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
        return ri

    def cancel(self, r: Request) -> bool:
        """Withdraw a queued or running request between steps; its slot is
        freed host-side (the next occupant's first chunk wipes it). Tokens
        already emitted stay in ``r.out_tokens``."""
        ri = self._req_index.get(id(r))
        if ri is None or self.status[ri] not in ("queued", "running"):
            return False
        if self.status[ri] == "queued":
            self._queue.remove(r)
        else:
            self._free_slot(next(i for i, o in enumerate(self._slots)
                                 if o is r))
            self._turnover = True
        self.status[ri] = "cancelled"
        return True

    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)

    def step(self) -> bool:
        """One scheduler iteration: admit from the queue (whole-prompt:
        prefill at admission), advance every prefilling slot by one chunk,
        run the batch decode. Returns True if any slot did work."""
        self._fill_slots()
        if not any(r is not None for r in self._slots):
            return False
        self.iter_count += 1
        self._turnover = False
        t0 = time.perf_counter()
        launches, replays = self.launch_count, self.replay_count
        n_chunks, decoded = self._iteration()
        if self.record_steps:
            self._sync()
            n = self.launch_count - launches
            self.step_log.append({
                "chunks": n_chunks, "decode": decoded,
                "s": time.perf_counter() - t0, "launches": n,
                "replays": self.replay_count - replays,
                "graph": n > 0 and self.replay_count - replays == n})
        if len(self._pend) >= DRAIN_EVERY:
            self.drain_pending()
        return True

    def drain_pending(self) -> None:
        """Move emitted tokens device -> host into ``out_tokens`` lists
        (one transfer for all pending entries)."""
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

    # ------------------------------------------------- scheduler internals
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_key(self) -> prng.Key:
        self.key, k = prng.split(self.key)
        return k

    def _ctx(self, key: prng.Key) -> Ctx:
        """The CIM context of a forward keyed by ``key`` (split(key)[0]);
        on the seed-table path its draws read the staged table."""
        ctx = Ctx.make(self.cfg, prng.split(key)[0], mode=self.mode)
        if self._width:
            ctx.seeds, ctx.seed_width = self._inputs.seeds, self._width
        return ctx

    def _seeds(self, key: prng.Key) -> Optional[np.ndarray]:
        """The seed table of a forward keyed by ``key`` (None off the
        seed-table path)."""
        if not self._width:
            return None
        return prng.seed_table(prng.split(key)[0], self.cfg.n_layers,
                               self._width)

    def _free_slot(self, s: int) -> None:
        self._slots[s] = None
        self._decoding[s] = False
        self._counts[s] = 0
        self._offsets[s] = 0
        self._rk_slot[s] = (0, 0)

    def _finish_request(self, s: int) -> None:
        self.status[self._req_index[id(self._slots[s])]] = "completed"
        self._free_slot(s)
        self._turnover = True

    def _fail_request(self, s: int, err: RequestError) -> None:
        ri = self._req_index[id(self._slots[s])]
        self.status[ri] = "failed"
        self.request_errors[ri] = err
        self._free_slot(s)

    def _fill_slots(self) -> None:
        for s in range(self.max_slots):
            while self._slots[s] is None and self._queue:
                r = self._queue.pop(0)
                ri = self._req_index[id(r)]
                self.status[ri] = "running"
                self._rk_slot[s] = self._rkeys[ri]
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
        self._inputs.put(seeds=self._seeds(key), tokens=chunk, valid=valid)
        if reset:
            for t in tf.take_slot(self.caches, s).values():
                t.zero_()
        logits = None
        if self._graphed():
            logits = self._replay(self._graphs["chunk"][s])
        if logits is None:
            logits = self._chunk_forward(s, self._ctx(key))
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
        self._inputs.put(seeds=self._seeds(key), valid=true_len)
        ctx = self._ctx(key)
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
        self._inputs.put(seeds=self._seeds(key), act=act)
        self.launch_count += 1
        self._snapshot()
        dead: Dict[int, RequestError] = {}
        try:
            logits = None
            if self._graphed():
                self._tok_in.copy_(self.last_tok)
                logits = self._replay(self._graphs["decode"])
                if logits is None:
                    self._restore()    # the failed replay may have run
            if logits is None:
                logits = self._decode_forward(self._ctx(key), self.last_tok)
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
        seeds = self._seeds(key)
        dead: Dict[int, RequestError] = {}
        self._restore()
        for s in range(self.max_slots):
            if not act[s]:
                continue
            solo = [i == s for i in range(self.max_slots)]
            self.launch_count += 1
            try:
                self._inputs.put(seeds=seeds, act=solo)
                logits = self._decode_forward(self._ctx(key), toks)
                toks = self._pick(logits, toks, temps, tok_idx)
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
        rows = self._inputs.seeds.shape[0]
        self._inputs.put(seeds=np.zeros((rows, 2), np.int32),
                         act=[True] * S,
                         tokens=np.zeros((self.chunk_size,), np.int64),
                         valid=self.chunk_size)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_forward(ctx, self._tok_in)
            self._chunk_forward(0, self._ctx(prng.PRNGKey(0)))
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        pool = torch.cuda.graph_pool_handle()
        try:
            graphs = {"decode": _Graph(
                lambda: self._decode_forward(self._ctx(prng.PRNGKey(0)),
                                             self._tok_in), pool)}
            graphs["chunk"] = [_Graph(
                lambda s=s: self._chunk_forward(s, self._ctx(
                    prng.PRNGKey(0))), pool) for s in range(S)]
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
                 device="cuda", **unported):
        if unported:
            raise NotImplementedError(
                f"LoopEngine options {sorted(unported)} are not ported yet; "
                "ROADMAP.md lists them as later work")
        self.device = resolve_device(device)
        self.cfg, self.mode = _resolve(cfg, cim_mode, attn_impl)
        self.max_slots = max_slots
        self.max_len = max_len
        self.key = prng.PRNGKey(seed)
        self._width = _seed_width(self.cfg, self.mode)
        self._inputs = _Inputs(self.device,
                               self.cfg.n_layers * self._width, 0, 0)
        params = _to_device(params, self.device)
        self.params = (deploy_params(self.cfg, params) if self.mode == "sim"
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
        ctx = Ctx.make(self.cfg, key, mode=self.mode)
        if self._width:
            self._inputs.put(seeds=prng.seed_table(key, self.cfg.n_layers,
                                                   self._width))
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
    mode; raises on what the port does not serve."""
    tf.check_family(cfg)
    if attn_impl is not None:
        if attn_impl not in ("einsum", "kernel"):
            raise ValueError(f"attn_impl must be 'einsum' or 'kernel', "
                             f"got {attn_impl!r}")
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    mode = cim_mode if cim_mode is not None else cfg.cim.mode
    if mode not in ("off", "sim"):
        raise NotImplementedError(f"cim mode {mode!r} is not ported yet "
                                  "(ROADMAP.md)")
    return cfg, mode


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
