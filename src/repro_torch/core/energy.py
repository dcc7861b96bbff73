"""Macro energy / throughput model — TOPS/W, FoMs, SAC efficiency.

A copy of the JAX package's ``core/energy.py`` (pure Python) pointed at the
port's ``CIMSpec`` and SAC policies; the 1024-row K tile is
``core.cim.MACRO_ROWS``.

Component model per output element per K-tile (1024 rows, ``wb`` weight
planes -> ``wb`` SAR conversions):

    E(ib, wb, cb, comparator) = rows * e_mac            (analog MAC array)
                              + wb * decisions * e_cmp  (comparator)
                              + wb * e_dac              (C-DAC + SAR logic)

with decisions = 10 (wo/CB) or 25 (w/CB: 7 + 3x6 MV), and the brute-force
low-noise comparator costing 4x e_cmp (2x noise for 4x energy — thermal
noise scaling). 1b-normalised ops = 2 * rows * ib * wb.

Constants are **calibrated, not measured** (DESIGN.md §2): three anchors from
the paper pin the three free constants:

  (1) CB conversion power ratio 1.9x  ->  e_dac = (20/3) e_cmp
  (2) SAC efficiency 2.1x on ViT-small (4b-attn-woCB / 6b-mlp-wCB vs the
      uniform-8b low-noise baseline)  ->  e_mac / e_cmp
  (3) peak 818 TOPS/W (6b/6b wo/CB)   ->  absolute scale (Joules)

The CB *time* ratio 2.5x (25 vs 10 decisions) then follows structurally, and
peak 1.2 TOPS (1b-norm) calibrates the decision time t_dec for the 1088x78
array. The comparator-energy 4x claim vs conventional CIMs (attenuation ->
2x noise penalty -> 4x energy) enters the conventional-scheme comparison.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.cim import MACRO_ROWS, CIMSpec
from repro_torch.core.sac import ROLE_CLASS, Policy, get_policy

ARRAY_COLS = 78            # physical columns of the prototype
ARRAY_ROWS = 1088          # physical rows (1024 logical)
PEAK_TOPS_W = 818e12       # paper, 1b-normalised
PEAK_TOPS = 1.2e12         # paper, 1b-normalised
SAC_TARGET = 2.1           # paper's transformer efficiency improvement
CB_POWER_RATIO = 1.9       # w/CB vs wo/CB conversion power
CB_TIME_RATIO = 2.5        # w/CB vs wo/CB conversion time (25 vs 10 decisions)


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    e_cmp: float   # J per comparator decision (relaxed comparator)
    e_dac: float   # J per conversion for C-DAC switching + SAR logic
    e_mac: float   # J per row analog MAC (one cell charge op)
    t_dec: float   # s per SAR decision (sets throughput)
    rows: int = MACRO_ROWS

    # ------------------------------------------------------------------ ops
    def decisions(self, spec: CIMSpec) -> int:
        return spec.adc.decisions(spec.cb)

    def conversion_energy(self, spec: CIMSpec) -> float:
        cmp_scale = 4.0 if spec.comparator == "lownoise" else 1.0
        if spec.scheme == "conventional":
            # conventional charge CIM: attenuation halves swing -> needs a 2x
            # lower-noise comparator for parity -> 4x comparator energy.
            cmp_scale *= 4.0
        return self.decisions(spec) * self.e_cmp * cmp_scale + self.e_dac

    def output_tile_energy(self, spec: CIMSpec) -> float:
        """J per output element per K-tile."""
        return self.rows * self.e_mac + spec.w_bits * self.conversion_energy(spec)

    def output_tile_time(self, spec: CIMSpec) -> float:
        return spec.w_bits * self.decisions(spec) * self.t_dec

    @staticmethod
    def ops_1b(m: int, k: int, n: int, spec: CIMSpec) -> float:
        """1b-normalised op count (MAC = 2 ops) for y = x(m,k) @ w(k,n)."""
        return 2.0 * m * k * n * spec.in_bits * spec.w_bits

    def matmul_energy(self, m: int, k: int, n: int, spec: CIMSpec) -> float:
        tiles = -(-k // self.rows)
        # partial K-tiles still pay full conversion cost; MAC energy ∝ actual rows
        return m * n * (
            k * self.e_mac
            + tiles * spec.w_bits * self.conversion_energy(spec)
        )

    def tops_per_watt(self, spec: CIMSpec) -> float:
        """1b-normalised TOPS/W of the macro at this operating point."""
        e = self.output_tile_energy(spec)
        return 2.0 * self.rows * spec.in_bits * spec.w_bits / e

    def tops(self, spec: CIMSpec) -> float:
        """1b-normalised TOPS of the 1088x78 array at this operating point."""
        ops = 2.0 * self.rows * spec.in_bits * spec.w_bits * ARRAY_COLS / spec.w_bits
        return ops / (self.decisions(spec) * self.t_dec) / 1.0


# --------------------------------------------------------------------- SAC


OpTrace = List[Tuple[str, int, int, int]]  # (role, m, k, n)


def vit_small_linear_trace(seq: int = 65, d: int = 384, depth: int = 12,
                           mlp_ratio: int = 4) -> OpTrace:
    """Per-image linear-layer op trace of ViT-small/CIFAR (paper's workload)."""
    trace: OpTrace = []
    for _ in range(depth):
        trace.append(("attn_qkv", seq, d, 3 * d))
        trace.append(("attn_out", seq, d, d))
        trace.append(("mlp_in", seq, d, mlp_ratio * d))
        trace.append(("mlp_out", seq, mlp_ratio * d, d))
    return trace


def trace_energy(trace: OpTrace, policy: Policy, em: "EnergyModel") -> float:
    total = 0.0
    for role, m, k, n in trace:
        spec = policy.spec_for_role(role)
        if spec is None:
            continue  # digital op, not on the macro
        total += em.matmul_energy(m, k, n, spec)
    return total


def sac_efficiency(em: "EnergyModel", trace: Optional[OpTrace] = None,
                   baseline: str = "uniform_8b", sac: str = "paper_sac") -> float:
    trace = trace or vit_small_linear_trace()
    e_base = trace_energy(trace, get_policy(baseline), em)
    e_sac = trace_energy(trace, get_policy(sac), em)
    return e_base / e_sac


# -------------------------------------------------------------- calibration


@lru_cache(maxsize=1)
def calibrated_model() -> EnergyModel:
    """Solve the three anchors for (e_cmp, e_dac, e_mac, t_dec). See module doc."""
    # (1) CB power ratio: (25 e + d) / (10 e + d) = 1.9  ->  d = (20/3) e
    dec_wo, dec_w = 10, 25
    d_over_e = (dec_w - CB_POWER_RATIO * dec_wo) / (CB_POWER_RATIO - 1.0)  # 6.667

    # (2) SAC ratio on the ViT-small trace pins a = rows*e_mac in units of e.
    # Energies per output-K-tile (units of e_cmp):
    #   baseline 8b lownoise : a + 8 * (4*10 + d/e)
    #   attn 4b wo/CB        : a + 4 * (10 + d/e)
    #   mlp 6b w/CB          : a + 6 * (25 + d/e)
    trace = vit_small_linear_trace()
    rows = MACRO_ROWS

    def tiles(k):
        return -(-k // rows)

    n_base = n_attn = n_mlp = 0.0   # conversion-count weights (sum m*n*tiles)
    macs = 0.0                      # sum m*n*k (row ops)
    macs_attn = macs_mlp = 0.0
    for role, m, k, n in trace:
        cnt = m * n * tiles(k)
        macs += m * n * k
        n_base += cnt
        if ROLE_CLASS[role] == "attn":
            n_attn += cnt
            macs_attn += m * n * k
        else:
            n_mlp += cnt
            macs_mlp += m * n * k
    # ratio(a) = [macs*me + n_base*8*(40+d)] / [macs*me + n_attn*4*(10+d) + n_mlp*6*(25+d)]
    # linear in me (=e_mac/e_cmp): solve ratio = SAC_TARGET.
    dd = d_over_e
    num_c = n_base * 8 * (40 + dd)
    den_c = n_attn * 4 * (10 + dd) + n_mlp * 6 * (25 + dd)
    # macs*me + num_c = SAC*(macs*me + den_c)
    me = (num_c - SAC_TARGET * den_c) / (macs * (SAC_TARGET - 1.0))
    if me <= 0:
        raise RuntimeError("SAC calibration infeasible with this baseline")

    # (3) absolute scale: peak TOPS/W at 6b/6b wo/CB relaxed comparator.
    # E_tile = rows*me*e + 6*(10 + dd)*e ; ops = 2*rows*36
    e_tile_units = rows * me + 6 * (10 + dd)
    e_cmp = 2.0 * rows * 36 / (PEAK_TOPS_W * e_tile_units)
    e_dac = dd * e_cmp
    e_mac = me * e_cmp

    # (4) throughput: peak 1.2 TOPS(1b) at 6b/6b wo/CB over 78 columns.
    # ops/s = cols * 2*rows*ib*wb / (wb * 10 * t_dec)
    t_dec = ARRAY_COLS * 2.0 * rows * 36 / (6 * 10 * PEAK_TOPS)
    return EnergyModel(e_cmp=e_cmp, e_dac=e_dac, e_mac=e_mac, t_dec=t_dec, rows=rows)


# ------------------------------------------------------------------- FoMs


def snr_fom(tops_w: float, snr_db: float) -> float:
    """FoM = TOPS/W * 2^ENOB with ENOB = (SNR[dB] - 1.76)/6.02 (paper Fig. 6)."""
    enob = (snr_db - 1.76) / 6.02
    return tops_w / 1e12 * 2.0 ** enob


def summary(em: Optional[EnergyModel] = None) -> Dict[str, float]:
    em = em or calibrated_model()
    peak = CIMSpec(in_bits=6, w_bits=6, cb=False)
    wcb = CIMSpec(in_bits=6, w_bits=6, cb=True)
    return {
        "e_cmp_fJ": em.e_cmp * 1e15,
        "e_dac_fJ": em.e_dac * 1e15,
        "e_mac_fJ": em.e_mac * 1e15,
        "t_dec_ns": em.t_dec * 1e9,
        "peak_tops_w_1b": em.tops_per_watt(peak) / 1e12,
        "tops_w_1b_wCB": em.tops_per_watt(wcb) / 1e12,
        "peak_tops_1b": em.tops(peak) / 1e12,
        "cb_power_ratio": em.conversion_energy(wcb) / em.conversion_energy(peak),
        "cb_time_ratio": em.output_tile_time(wcb) / em.output_tile_time(peak),
        "sac_efficiency": sac_efficiency(em),
    }
