"""Software-Analog Co-design policies: layer role -> macro operating point.

Twin of ``core/sac.py``: attention linears at 4b/4b without CSNR-Boost,
MLP linears at 6b/6b with it (the paper's policy); router, head and
embeddings stay digital. ``DegradeLadder`` is the serving front-end's
load-adaptive vote ladder.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.cim import CIMSpec

ROLE_CLASS: Dict[str, Optional[str]] = {
    "attn_qkv": "attn",
    "attn_out": "attn",
    "mlp_in": "mlp",
    "mlp_out": "mlp",
    "moe_expert": "mlp",
    "moe_shared": "mlp",
    "ssm_in": "mlp",
    "ssm_out": "mlp",
    "conv": "mlp",
    "router": None,
    "head": None,
    "embed": None,
    "cross_qkv": "attn",
    "cross_out": "attn",
}


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    attn: Optional[CIMSpec]
    mlp: Optional[CIMSpec]

    def spec_for_role(self, role: str) -> Optional[CIMSpec]:
        cls = ROLE_CLASS.get(role, "mlp")
        if cls is None:
            return None
        return self.attn if cls == "attn" else self.mlp


def paper_sac() -> Policy:
    return Policy(name="paper_sac",
                  attn=CIMSpec(in_bits=4, w_bits=4, cb=False),
                  mlp=CIMSpec(in_bits=6, w_bits=6, cb=True))


def cb_only() -> Policy:
    return Policy(name="cb_only",
                  attn=CIMSpec(in_bits=6, w_bits=6, cb=False),
                  mlp=CIMSpec(in_bits=6, w_bits=6, cb=True))


def uniform_baseline() -> Policy:
    spec = CIMSpec(in_bits=8, w_bits=8, cb=False, comparator="lownoise")
    return Policy(name="uniform_8b", attn=spec, mlp=spec)


def uniform(in_bits: int = 6, w_bits: int = 6, cb: bool = True) -> Policy:
    spec = CIMSpec(in_bits=in_bits, w_bits=w_bits, cb=cb)
    return Policy(name=f"uniform_{in_bits}b{'_cb' if cb else ''}",
                  attn=spec, mlp=spec)


@dataclasses.dataclass(frozen=True)
class DegradeLadder:
    """Load-adaptive accuracy/energy ladder: level 0 admits at full
    fidelity, higher levels admit new requests at reduced CB majority-vote
    counts (in sim mode, the extra output noise of
    ``core.cim.vote_drop_extra_std_int``). The front-end picks the level
    with hysteresis against its admission-queue depth: one rung up when the
    depth reaches the high watermark, one down when it falls below the low
    one, held in between.

    ``votes``: the vote count per level; index 0 must be ``None`` (full
    votes: a level-0 row is bit-identical to a ladder-free engine), the
    rest strictly decreasing ints >= 1."""

    votes: tuple = (None, 3, 1)

    def __post_init__(self):
        if not self.votes or self.votes[0] is not None:
            raise ValueError(
                f"ladder level 0 must be None (full votes), got {self.votes}")
        prev = None
        for v in self.votes[1:]:
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"ladder vote counts must be ints >= 1, got {self.votes}")
            if prev is not None and v >= prev:
                raise ValueError(
                    f"ladder vote counts must strictly decrease, "
                    f"got {self.votes}")
            prev = v

    @property
    def n_levels(self) -> int:
        return len(self.votes)

    def votes_at(self, level: int, full_votes: int = 6) -> int:
        """Effective vote count at ``level`` (for records and energy)."""
        v = self.votes[min(max(level, 0), len(self.votes) - 1)]
        return full_votes if v is None else min(v, full_votes)

    def next_level(self, current: int, depth: int,
                   high: int, low: int) -> int:
        """One hysteresis step of the ladder controller."""
        if depth >= high:
            return min(current + 1, len(self.votes) - 1)
        if depth < low:
            return max(current - 1, 0)
        return current


POLICIES = {
    "paper_sac": paper_sac,
    "cb_only": cb_only,
    "uniform_8b": uniform_baseline,
    "uniform_6b": lambda: uniform(6, 6, True),
    "none": None,
}


def get_policy(name: Optional[str]) -> Optional[Policy]:
    if name is None or name == "none":
        return None
    return POLICIES[name]()
