"""Software-Analog Co-design policies: layer role -> macro operating point.

Twin of ``core/sac.py`` without the degradation ladder: attention linears at
4b/4b without CSNR-Boost, MLP linears at 6b/6b with it (the paper's policy);
router, head and embeddings stay digital.
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
