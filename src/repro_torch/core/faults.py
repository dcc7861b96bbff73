"""Deterministic structural-fault injection for the CR-CIM sim.

Twin of ``src/repro/core/faults.py``:

  * **stuck-at bitcells** (``stuck_bit_plane``): a Bernoulli(rate) subset
    of the deployed plane's two's-complement bits forced to a fair-coin
    value, applied once at deploy time, so the CIM kernel consumes the
    faulted plane unchanged;
  * **per-column gain / offset** of the readout chain (``column_gain``,
    ``column_offset_z``);
  * **ADC stuck-code** (``adc_stuck_cols``): a per-column subset whose ADC
    returns ``adc_stuck_code`` for every conversion;
  * **vote-count brownouts** (``brownout_mask``): a per-conversion subset,
    keyed on the call's key, whose CB majority vote collapses to
    ``brownout_votes``;
  * **transient disturbance** (``transient_mag``), which the guard adds to
    the rows the engine names (``core.guard``);
  * **whole-replica failures** (``ReplicaFaultSpec``), which the replica
    router (``serving/router.py``) injects at its own step counter.

Every realisation is a function of (``FaultSpec.seed``, position) under
the reference's Threefry draws, so the port reproduces each bit for bit.
A key is a host pair of ints or a pair of 0-d int64 device tensors (the
words of a seed-table row): ``prng``'s Threefry takes either, so a CUDA
graph can replay a draw whose key changes every call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import prng

DOMAIN_FAULT = 0x5D2F8A31
# the brownout draws its normal under fold_in(key, BROWNOUT_FOLD)
BROWNOUT_FOLD = 0x0FA1


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault scenario: rates per affected element
    (bitcell / column / conversion), magnitudes in the units noted."""

    seed: int = 0
    stuck_rate: float = 0.0      # per-bitcell stuck-at prob (deploy time)
    col_gain_std: float = 0.0    # per-column multiplicative gain std
    col_offset_std: float = 0.0  # per-column offset std, in output sigmas
    brownout_rate: float = 0.0   # per-conversion prob of CB vote collapse
    brownout_votes: int = 1      # votes remaining during a brownout
    adc_stuck_rate: float = 0.0  # per-column prob the SAR ADC is stuck
    adc_stuck_code: int = 0      # code a stuck ADC emits
    transient_mag: float = 0.0   # engine-injected per-row disturbance, in
                                 # output sigmas

    def any_output_fault(self) -> bool:
        """True if the output-referred runtime faults are active."""
        return (self.col_gain_std > 0.0 or self.col_offset_std > 0.0
                or self.adc_stuck_rate > 0.0 or self.brownout_rate > 0.0)


@dataclasses.dataclass(frozen=True)
class ReplicaFaultSpec:
    """One seeded whole-replica failure scenario, injected by the router
    at its own step counter so that a failover run replays exactly:

      * ``mode="kill"``: ``Engine.kill()`` at ``at_step``, device loss;
        later steps and drains raise and undrained tokens are gone;
      * ``mode="wedge"``: ``Engine.wedge()`` at ``at_step``; steps return
        and nothing advances, which only the router's no-progress
        watchdog sees;
      * ``mode="storm"``: no router action; ``build_pool`` builds the
        victim with ``storm_fault()`` on every slot, so its guard's hard
        trips drag its health score down and the router drains it.

    ``victim=None`` derives the victim from ``seed``."""

    seed: int = 0
    mode: str = "kill"            # kill | wedge | storm
    at_step: int = 8              # router step at which kill/wedge fires
    victim: Optional[int] = None  # replica index; None: seeded choice
    storm_transient_mag: float = 64.0   # the storm's disturbance, sigmas

    def __post_init__(self):
        if self.mode not in ("kill", "wedge", "storm"):
            raise ValueError(f"unknown replica fault mode {self.mode!r}")

    def victim_of(self, n_replicas: int) -> int:
        if self.victim is not None:
            if not 0 <= self.victim < n_replicas:
                raise ValueError(
                    f"victim {self.victim} out of range for {n_replicas}")
            return self.victim
        # splitmix-style scramble of the seed
        z = (self.seed * 0x9E3779B9 + DOMAIN_FAULT) & 0xFFFFFFFF
        z ^= z >> 16
        return z % n_replicas

    def storm_fault(self) -> FaultSpec:
        """The victim's ``FaultSpec``: a persistent
        ``storm_transient_mag``-sigma disturbance on its faulted rows under
        the guard, so hard trips land on that replica only."""
        return FaultSpec(seed=self.seed,
                         transient_mag=self.storm_transient_mag)


def stuck_bit_plane(wq: torch.Tensor, bits: int, rate: float,
                    key: prng.Key, start: int = 0) -> torch.Tensor:
    """Force a Bernoulli(rate) subset of the stored bits to random 0/1.

    Bit ``i`` draws ``uniform(km)`` (stuck?) and ``uniform(kv)`` (value)
    over ``wq``'s shape, ``km, kv = split(fold_in(key, i))``. ``start``
    offsets the flat index: the result is then the slice of the draw over
    a larger plane that begins there (a stacked plane a layer at a time,
    bit for bit). The reassembled value may reach ``-2^(bits-1)`` and is
    not clipped, as in the reference."""
    if rate <= 0.0:
        return wq
    dev = wq.device
    u = torch.remainder(wq.to(torch.int32), 2 ** bits)
    out = torch.zeros_like(u)
    for i in range(bits):
        km, kv = prng.split(prng.fold_in(key, i))
        stuck = prng.uniform(km, tuple(wq.shape), device=dev,
                             start=start) < rate
        val = prng.uniform(kv, tuple(wq.shape), device=dev,
                           start=start) < 0.5
        bit = torch.where(stuck, val.to(torch.int32), (u >> i) & 1)
        out = out + (bit << i)
    signed = out - (out >= 2 ** (bits - 1)).to(torch.int32) * (2 ** bits)
    return signed.to(wq.dtype)


_COLUMNS: dict = {}


def _cached(kind: str, fault: FaultSpec, n: int, device, make):
    """A per-column realisation, drawn once per (scenario, width,
    device)."""
    kk = (kind, fault, n, torch.device(device))
    if kk not in _COLUMNS:
        if len(_COLUMNS) >= 512:
            _COLUMNS.clear()
        _COLUMNS[kk] = make()
    return _COLUMNS[kk]


def column_gain(fault: FaultSpec, n: int,
                device="cpu") -> Optional[torch.Tensor]:
    """(N,) multiplicative readout gain per column, or None when off."""
    if fault.col_gain_std <= 0.0:
        return None
    z = _cached("gain", fault, n, device, lambda: prng.normal(
        prng.fold_in(prng.PRNGKey(fault.seed), 1), (n,), device=device))
    return 1.0 + fault.col_gain_std * z


def column_offset_z(fault: FaultSpec, n: int,
                    device="cpu") -> Optional[torch.Tensor]:
    """(N,) standard-normal offset per column (the caller scales it by
    ``col_offset_std * sigma``), or None when off."""
    if fault.col_offset_std <= 0.0:
        return None
    return _cached("offset", fault, n, device, lambda: prng.normal(
        prng.fold_in(prng.PRNGKey(fault.seed), 2), (n,), device=device))


def adc_stuck_cols(fault: FaultSpec, n: int,
                   device="cpu") -> Optional[torch.Tensor]:
    """(N,) bool mask of the columns whose ADC is stuck, or None when off:
    Threefry keyed ``(seed ^ DOMAIN_FAULT, 3)`` at counter (column, 0)."""
    if fault.adc_stuck_rate <= 0.0:
        return None

    def make():
        cols = torch.arange(n, dtype=torch.int64, device=device)
        bits, _ = prng.threefry2x32((fault.seed & prng.M32) ^ DOMAIN_FAULT,
                                    3, cols, 0)
        return prng.uniform_from_bits(bits) < fault.adc_stuck_rate

    return _cached("stuck", fault, n, device, make)


def brownout_mask(fault: FaultSpec, k0, k1,
                  idx: torch.Tensor) -> torch.Tensor:
    """Per-conversion brownout events of one ``sar_convert`` call: ``k0``,
    ``k1`` the call's key words (``k0`` already xored with the SAR domain,
    as ``sar_convert`` holds it), ``idx`` the flat conversion index."""
    bits, _ = prng.threefry2x32(k0 ^ DOMAIN_FAULT,
                                k1 ^ (fault.seed & prng.M32), idx, 0xB0)
    return prng.uniform_from_bits(bits) < fault.brownout_rate


def apply_output_faults(y: torch.Tensor, fault: FaultSpec, sigma,
                        stuck_value, brownout_extra_std,
                        key=None) -> torch.Tensor:
    """The per-column runtime faults on a matmul output ``y`` (..., N), in
    the physical order: gain, offset (``col_offset_std * sigma`` times the
    column's normal), the brownout stand-in (``brownout_extra_std`` times a
    normal of ``y``'s shape under ``key``; only with a key), then a stuck
    ADC column replaced by ``stuck_value``. ``sigma``, ``stuck_value`` and
    ``brownout_extra_std`` are in y's units (floats or 0-d tensors)."""
    n = y.shape[-1]
    dev = y.device
    g = column_gain(fault, n, dev)
    if g is not None:
        y = y * g
    z = column_offset_z(fault, n, dev)
    if z is not None:
        y = y + (fault.col_offset_std * sigma) * z
    if fault.brownout_rate > 0.0 and key is not None:
        y = y + brownout_extra_std * prng.normal(key, tuple(y.shape),
                                                 device=dev)
    stuck = adc_stuck_cols(fault, n, dev)
    if stuck is not None:
        if not isinstance(stuck_value, torch.Tensor):
            stuck_value = torch.full((), stuck_value, dtype=torch.float32,
                                     device=dev)
        y = torch.where(stuck, stuck_value.to(torch.float32), y)
    return y
