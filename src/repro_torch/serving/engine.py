"""Slot-batched continuous-batching serving engine on PyTorch.

Twin of the fused ``Engine`` of ``src/repro/serving/engine.py`` for the
dense, ssm and moe (MLA) families. One stacked cache of batch
``max_slots`` is allocated once (a KV or latent cache over-allocated to a
chunk multiple, so a final padded chunk never clamps back onto live keys;
for mamba2 the conv window and the f32 state). Each scheduler iteration
advances every still-prefilling slot by one fixed-shape chunk of
``chunk_size`` tokens, in ascending slot order, then runs ONE batch decode
step over every slot: idle and prefilling rows ride along, as in the
reference, because sim-mode CIM noise depends on the batch-global
activation scale, and their lengths (and ssm window and state) are
restored afterwards. A prefill chunk tells the model how many of its
tokens are real (``Ctx.prefill_valid``), so the ssm state skips the
chunk's right-pad.

The PRNG contract replays the reference bit for bit:

  * the engine key starts at ``PRNGKey(seed)``; each chunk call and each
    decode step draws ``key, k = split(key)`` in that order and keys its
    CIM noise context with ``split(k)[0]``;
  * a request's sampling key is ``fold_in(fold_in(PRNGKey(seed), 0x5A17),
    uid)`` with ``uid = crc32(rid)`` (or its submission index); token ``i``
    samples under ``fold_in(request key, i)``. Greedy rows (temperature 0)
    take the arg-max, ties to the first index.

Sim mode deploys the weights once into int8 planes at construction and
serves them on the CIM kernel (``cim.use_kernel=True``) or on the
behavioural ``core.cim.cim_dense`` (``use_kernel=False``), as the
reference does. ``fuse_layer=True`` runs every decode step as one
megakernel launch per layer (``kernels/fused_step.py``) where the fused
route applies: a dense float32 model with rope (``_use_fused_layer``). As
in the reference, a config the route never takes (another family, another
dtype, no rope) serves unfused.
Emitted tokens stay on the device until drained (every ``DRAIN_EVERY``
pending entries and at the end of ``generate``).

Not in this slice (they raise ``NotImplementedError``, see ROADMAP.md):
the ABFT guard, the degradation ladder, fault and drift injection,
calibration, replica failover, the whole-prompt path (``chunk_size=0``),
``LoopEngine`` and the per-slot re-probing of a failed batch decode (a
decode error propagates; a failed prefill chunk fails its request only, as
in the reference).
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
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx

DEFAULT_CHUNK_SIZE = 32
DRAIN_EVERY = 64


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


def _sample_tokens(logits: torch.Tensor, temps: List[float],
                   keys: List[prng.Key]) -> torch.Tensor:
    """(B, V) logits + per-row temperatures and keys -> (B,) int64.

    Greedy rows take the arg-max; sampled rows draw
    ``jax.random.categorical`` under their key (arg-max of the scaled
    logits plus Gumbel noise from the Threefry twin)."""
    toks = torch.argmax(logits, dim=-1)
    for row, (t, key) in enumerate(zip(temps, keys)):
        if t > 0:
            scaled = logits[row].to(torch.float32) / t
            g = prng.gumbel(key, tuple(scaled.shape), device=logits.device)
            toks[row] = torch.argmax(g + scaled)
    return toks


def _row_sample_keys(rkeys: List[prng.Key], tok_idx) -> List[prng.Key]:
    return [prng.fold_in(k, int(i)) for k, i in zip(rkeys, tok_idx)]


class Engine:
    """Fused slot-batched engine: per iteration, one chunk per prefilling
    slot, then one batch decode step for all slots."""

    def __init__(self, cfg: ModelConfig, params: Any, max_slots: int = 4,
                 max_len: int = 512, cim_mode: Optional[str] = None,
                 seed: int = 0, attn_impl: Optional[str] = None,
                 chunk_size: Optional[int] = None,
                 record_ttft: bool = False, record_steps: bool = False,
                 fuse_layer: bool = False, device="cuda", **unported):
        if unported:
            raise NotImplementedError(
                f"Engine options {sorted(unported)} are not ported yet; "
                "ROADMAP.md lists them as later work")
        self.device = resolve_device(device)
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
        if fuse_layer:
            cfg = dataclasses.replace(cfg, fuse_layer=True)
        if chunk_size is None:
            chunk_size = DEFAULT_CHUNK_SIZE
        if chunk_size <= 0:
            raise NotImplementedError(
                "whole-prompt prefill (chunk_size=0) is not ported; the "
                "port prefills in chunks (ROADMAP.md)")
        self.cfg = cfg
        self.mode = mode
        self.max_slots = max_slots
        self.max_len = max_len
        self.chunk_size = int(chunk_size)
        self.record_ttft = record_ttft
        self.record_steps = record_steps
        self._alloc_len = -(-max_len // self.chunk_size) * self.chunk_size
        self.key = prng.PRNGKey(seed)
        self._sample_base = prng.fold_in(prng.PRNGKey(seed), 0x5A17)

        params = _to_device(params, self.device)
        self.params = deploy_params(cfg, params) if mode == "sim" else params
        self.caches = tf.init_caches(cfg, max_slots, self._alloc_len,
                                     self.device)
        self.last_tok = torch.zeros((max_slots,), dtype=torch.int64,
                                    device=self.device)
        self.begin()

    # -------------------------------------------- incremental session API
    def begin(self) -> None:
        """Reset scheduler state for a fresh session. The device cache is
        not touched: a recycled slot is wiped by its first chunk."""
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
        """One scheduler iteration: admit from the queue, advance every
        prefilling slot by one chunk, run the batch decode. Returns True if
        any slot did work."""
        self._fill_slots()
        if not any(r is not None for r in self._slots):
            return False
        self._turnover = False
        t0 = time.perf_counter()
        n_chunks, decoded = self._iteration()
        if self.record_steps:
            self._sync()
            self.step_log.append({"chunks": n_chunks, "decode": decoded,
                                  "s": time.perf_counter() - t0})
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
        kctx, _ = prng.split(key)
        return Ctx.make(self.cfg, kctx, mode=self.mode)

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
            if self._slots[s] is None and self._queue:
                r = self._queue.pop(0)
                self.status[self._req_index[id(r)]] = "running"
                self._rk_slot[s] = self._rkeys[self._req_index[id(r)]]
                self._slots[s] = r

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
            chunk = np.zeros((1, self.chunk_size), np.int64)
            chunk[0, :valid] = prompt[off:off + valid]
            is_final = off + valid >= prompt.shape[0]
            n += 1
            key = self._next_key()
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

    def _chunk(self, s: int, chunk: np.ndarray, reset: bool, valid: int,
               is_final: bool, temp: float, key: prng.Key) -> torch.Tensor:
        """Advance slot ``s``'s prefill by one fixed-shape chunk, on views
        of its cache row. Returns the token sampled at the last valid
        position (committed to ``last_tok`` on the final chunk)."""
        ctx = self._ctx(key)
        ctx.prefill_valid = torch.tensor([valid], device=self.device)
        sl = tf.take_slot(self.caches, s)
        if reset:
            for t in sl.values():
                t.zero_()
        start = tf.cache_len(sl).clone()
        tokens = torch.from_numpy(chunk).to(self.device)
        logits, sl = tf.forward(self.params, {"tokens": tokens}, self.cfg,
                                ctx, sl)
        tf.set_cache_lens(sl, start + valid)
        tok = _sample_tokens(logits[:, valid - 1], [temp],
                             [prng.fold_in(self._rk_slot[s], 0)])[0]
        if is_final:
            # a new tensor: the pending token log may still hold the old one
            self.last_tok = self.last_tok.clone()
            self.last_tok[s] = tok
        return tok

    def _decode(self, act: List[bool]) -> None:
        """One batch decode step over every slot; inactive rows keep their
        token, cache length and ssm window and state."""
        tok_idx = list(self._counts)
        ctx = self._ctx(self._next_key())
        temps = [float(r.temperature) if r is not None else 0.0
                 for r in self._slots]
        active = torch.tensor(act, device=self.device)
        inactive = [s for s, a in enumerate(act) if not a]
        frozen = tf.freeze_rows(self.caches, inactive)
        logits, self.caches = tf.forward(
            self.params, {"tokens": self.last_tok[:, None]}, self.cfg, ctx,
            self.caches)
        toks = _sample_tokens(logits[:, -1], temps,
                              _row_sample_keys(self._rk_slot, tok_idx))
        toks = torch.where(active, toks, self.last_tok)
        tf.mask_cache_advance(self.caches, frozen, inactive)
        self.last_tok = toks
        self._pend.append((toks, [self._req_index[id(r)] if act[s] else None
                                  for s, r in enumerate(self._slots)]))
        for s, r in enumerate(self._slots):
            if r is None or not act[s]:
                continue
            self._counts[s] += 1
            if self._counts[s] >= r.max_new_tokens:
                self._finish_request(s)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
