"""The models' tensor-parallel forward on a live mesh (dense and GQA
families; the expert-parallel MoE lives in ``models/moe.py``).

Under ``use_rules(default_rules(mesh))`` over a live ``DeviceMesh`` of
more than one rank (``distributed.collectives.live_mesh``),
``transformer.forward`` makes a ``TP`` state for the forward and every
layer reads it from ``Ctx.tp``. The caller passes the global batch on
every rank; activations then stay local tensors, each rank holding its
block of ``distributed.sharding.port_spec``:

  * the batch is split over the data axes where they divide it, as the
    reference's ``shard(x, "batch", "seq", "embed")`` does; every rank of
    a data group computes its rows only;
  * ``embed`` looks up a vocab-sharded table with a mask and an
    all-reduce over ``model`` (one nonzero term a value: exact);
  * ``dense`` runs column-parallel (a plane split over N: q, k, v, gate,
    up; the output stays this rank's columns) or row-parallel (split over
    K: o, down; the input is this rank's K block, the partial products
    summed over ``model``) by the plane's resolved spec
    (``rules.param_spec``), with the planes of ``deploy(rules=)`` (local
    blocks, gathered over the data axes where FSDP split them: exact) or
    whole planes, which it slices. In sim mode on the CIM kernel a column
    shard passes its first global row and column to the noise counter
    and a row shard runs the int32 tile partials, an int32 all-reduce and
    the tile epilogue (``kernels.ops.cim_matmul_deployed_rows``); the
    activation scale is that of the whole activation, all-gathered (the
    same mean over the same tensor: bit-equal to one rank); in off mode
    the row-parallel float partials are summed by an all-reduce (another
    float order, as the reference's psum);
  * attention runs rows 2 and 3 on the rank's local heads (their split
    plans those of the whole model's heads, ``plan_kv``), the caches hold
    the local rows and KV heads (``local_cache_dims``); heads that do not
    divide the model axis are all-gathered and computed whole;
  * ``unembed`` gives vocab-sharded logits; ``gather_logits`` assembles
    the global logits from the ranks' blocks; ``lm_loss`` runs a
    vocab-parallel cross-entropy (max and sum all-reduces).

Only the dense, vlm and moe-with-GQA families are sharded; the others
raise ``NotImplementedError`` naming ROADMAP A7.3, as do the behavioural
sim linears (``cim.use_kernel=False``), qat mode and the robustness
epilogues (guard, faults, drift, the load ladder) under a live mesh:
nothing falls back to unsharded numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (AxisVal, ShardingRules,
                                              get_rules, port_spec, shard)

A73 = "not sharded yet under a live mesh (ROADMAP A7.3)"

# logical axes of each role's weight (K, N), as the models' inits give them
_ROLE_AXES = {"attn_qkv": ("embed", "heads"), "mlp_in": ("embed", "mlp"),
              "attn_out": ("heads", "embed"), "mlp_out": ("mlp", "embed"),
              "router": ("embed", None)}


@dataclasses.dataclass(frozen=True)
class TP:
    lm: col.LiveMesh
    rules: ShardingRules
    batch: AxisVal          # axes the batch is split over in this forward
    batch_size: int         # the global batch

    @property
    def model(self) -> int:
        return self.lm.sizes.get("model", 1)

    def model_index(self) -> int:
        return self.lm.coords.get("model", 0)


def check_family(cfg: ModelConfig, what: str = "forward") -> None:
    if cfg.family not in ("dense", "vlm", "moe") or cfg.mla is not None:
        fam = "moe with MLA" if cfg.mla is not None else cfg.family
        raise NotImplementedError(f"the {fam} family's {what} is {A73}")


def begin(cfg: ModelConfig, batch_size: int, seq: int) -> Optional[TP]:
    """The forward's TP state under live rules, else None."""
    rules = get_rules()
    lm = col.live_mesh(rules)
    if lm is None:
        return None
    check_family(cfg)
    b_axes = port_spec(rules, ("batch", "seq", "embed"),
                       (batch_size, seq, cfg.d_model))[0]
    return TP(lm, rules, b_axes, batch_size)


def local_cache_dims(cfg: ModelConfig, batch: int):
    """(rows, KV heads) of this rank's cache under live rules (the whole
    batch and heads otherwise)."""
    rules = get_rules()
    lm = col.live_mesh(rules)
    if lm is None:
        return batch, cfg.n_kv_heads
    check_family(cfg, "cache")
    spec = port_spec(rules, ("batch", "seq", "kv_heads", "head_dim"),
                     (batch, 1, cfg.n_kv_heads, cfg.hd))
    return batch // lm.size(spec[0]), cfg.n_kv_heads // lm.size(spec[2])


def batch_block(tp: TP, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor every rank holds whole (the batch's
    tokens, labels, a vlm prefix)."""
    return shard(x, "batch", *([None] * (x.ndim - 1)),
                 held=(None,) * x.ndim)


def _vocab_block(tp: TP, v: int, d: int):
    """(first row, rows) of this rank's block of a (vocab, d) table."""
    spec = tp.rules.param_spec(("vocab", "embed"), (v, d))[0]
    if "model" not in col.axes_of(spec):
        return 0, v
    n = v // tp.model
    return tp.model_index() * n, n


def embed(tp: TP, p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """This rank's rows of the embeddings: a masked lookup in its vocab
    block, all-reduced over ``model``."""
    tokens = batch_block(tp, tokens)
    e = p["e"]
    v0, n = _vocab_block(tp, *e.shape)
    if n == e.shape[0]:
        return e.to(dtype)[tokens]
    local = tokens.long() - v0
    ok = (local >= 0) & (local < n)
    x = e[v0:v0 + n].to(dtype)[local.clamp(0, n - 1)]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=dtype,
                                                  device=x.device))
    return col.all_reduce(x, "model", tp.lm)


def unembed(tp: TP, p, x: torch.Tensor) -> torch.Tensor:
    """Vocab-sharded logits: this rank's vocab block of the digital head."""
    e = p["e"]
    v0, n = _vocab_block(tp, *e.shape)
    return x @ e[v0:v0 + n].to(x.dtype).T


def gather_logits(cfg: ModelConfig, logits: torch.Tensor,
                  batch_size: int) -> torch.Tensor:
    """The global (B, S, vocab) logits from this rank's block, on every
    rank (``logits`` as it is with no live mesh). ``batch_size``: the
    global batch."""
    rules = get_rules()
    lm = col.live_mesh(rules)
    if lm is None:
        return logits
    spec = port_spec(rules, ("batch", "seq", "vocab"),
                     (batch_size,) + tuple(logits.shape[1:-1])
                     + (cfg.vocab_size,))
    held = (spec[0] if logits.shape[0] != batch_size else None, None,
            spec[2] if logits.shape[-1] != cfg.vocab_size else None)
    return col.relayout(logits, held, (None,) * 3, lm)


def lm_loss(tp: TP, cfg: ModelConfig, logits: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """``transformer.lm_loss`` on this rank's block of the logits: the
    log-sum-exp over the vocab by a max and a sum all-reduce over
    ``model``, the label's logit by a masked gather and a sum all-reduce,
    the token sums over the data axes. Another float order than one
    device's ``log_softmax``."""
    labels = batch_block(tp, labels).long()
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    lf = logits.to(torch.float32)
    valid = labels >= 0
    safe = labels.clamp_min(0)
    if lf.shape[-1] == cfg.vocab_size:
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, -1, safe[..., None])[..., 0]
    else:
        v0 = tp.model_index() * lf.shape[-1]
        mx = col.all_reduce(lf.amax(dim=-1), "model", tp.lm, "max")
        se = col.all_reduce(torch.exp(lf - mx[..., None]).sum(dim=-1),
                            "model", tp.lm)
        lse = mx + torch.log(se)
        local = safe - v0
        ok = (local >= 0) & (local < lf.shape[-1])
        got = torch.gather(lf, -1, local.clamp(0, lf.shape[-1] - 1)[..., None])
        tgt = col.all_reduce(torch.where(ok, got[..., 0], 0.0), "model",
                             tp.lm)
    per = (lse - tgt + 1e-4 * torch.square(lse)) * valid
    tot = torch.stack([per.sum(), valid.sum().to(torch.float32)])
    if tp.batch is not None:
        tot = col.all_reduce(tot, tp.batch, tp.lm)
    return tot[0] / torch.clamp_min(tot[1], 1)


def split_heads(ctx, y: torch.Tensor, b: int, s: int, h: int, hd: int,
                name: str) -> torch.Tensor:
    """(B, S, columns) of a q/k/v projection -> (B, S, heads, D) in the
    port spec of ``(batch, seq, name, head_dim)``: this rank's heads where
    they divide ``model``, else all of them (a column block of a split
    plane all-gathered)."""
    tp = ctx.tp
    if tp is None:
        return y.reshape(b, s, h, hd)
    want = port_spec(tp.rules, ("batch", "seq", name, "head_dim"),
                     (b, s, h, hd))[2]
    sharded = y.shape[-1] != h * hd
    if sharded and want is None:
        y = col.all_gather(y, -1, "model", tp.lm)
    elif not sharded and want is not None:
        y = col.block(y, -1, want, tp.lm)
    return y.reshape(b, s, -1, hd)


def _act_scale(ctx, tp: TP, x: torch.Tensor, spec, k_dim: int):
    """The activation scale of the whole activation (every row, all of
    K): ``layers._act_scale`` of the all-gathered tensor, bit-equal to
    one rank's; with no clip fit the abs-max by a max all-reduce."""
    from repro_torch.models.layers import _act_scale as one_rank
    k_block = x.shape[-1] != k_dim
    if ctx.cfg.cim.act_clip_sigmas > 0:
        whole = col.all_gather(x, -1, "model", tp.lm) if k_block else x
        if tp.batch is not None:
            whole = col.all_gather(whole, 0, tp.batch, tp.lm)
        return one_rank(ctx, whole, spec)
    amax = x.to(torch.float32).abs().amax()
    if k_block:
        amax = col.all_reduce(amax, "model", tp.lm, "max")
    if tp.batch is not None:
        amax = col.all_reduce(amax, tp.batch, tp.lm, "max")
    return torch.clamp_min(amax, 1e-8) / quant.qmax(spec.in_bits)


def param_block(t: torch.Tensor, shape, pspec, want, lm) -> torch.Tensor:
    """A weight or plane in the layout ``want``: ``t`` is its local block
    under ``pspec`` (placed by ``deploy(rules=)``) or the whole tensor."""
    held = (None,) * len(shape) if tuple(t.shape) == tuple(shape) else pspec
    return col.relayout(t, held, want, lm)


def dense(ctx, p, x: torch.Tensor, role: str) -> torch.Tensor:
    """``layers.dense`` on a live mesh (see module doc)."""
    from repro_torch.kernels import ops as kops
    tp = ctx.tp
    names = _ROLE_AXES.get(role)
    if names is None:
        raise NotImplementedError(f"role {role!r} is {A73}")
    if (ctx.guard is not None or ctx.fault is not None
            or ctx.drift is not None or ctx.degrade_rows is not None):
        raise NotImplementedError(f"the robustness epilogues are {A73}")
    spec = ctx.spec_for(role)
    w = p["w"]
    k_dim, n_dim = w.shape[-2:]
    pspec = tp.rules.param_spec(names, (k_dim, n_dim))
    mdim = next((d for d, a in enumerate(pspec)
                 if "model" in col.axes_of(a)), None)
    want = tuple("model" if d == mdim else None for d in range(2))
    m = tp.model if mdim is not None else 1
    rows = mdim == 0
    k_here = k_dim // m if rows else k_dim
    xs = key = wq = None
    if spec is not None:
        wq = p.get(f"wq{spec.w_bits}")
        if ctx.mode != "sim" or wq is None or not ctx.cfg.cim.use_kernel:
            raise NotImplementedError(
                f"{ctx.mode} mode off the deployed CIM kernel "
                f"(cim.use_kernel) is {A73}")
        key = ctx.next_key()
        xs = _act_scale(ctx, tp, x, spec, k_dim)
    if x.shape[-1] != k_here:
        x = (col.block(x, -1, "model", tp.lm) if rows
             else col.all_gather(x, -1, "model", tp.lm))
    m_rows = x.numel() // x.shape[-1]
    row0 = tp.lm.index(tp.batch) * m_rows if tp.batch is not None else 0
    col0 = tp.model_index() * (n_dim // m) if mdim == 1 else 0
    reduce = (lambda t: col.all_reduce(t, "model", tp.lm))
    if spec is None:
        wl = param_block(w, (k_dim, n_dim), want, want, tp.lm)
        y = x @ wl.to(x.dtype)
        if rows:
            y = reduce(y)
    else:
        wl = param_block(wq, (k_dim, n_dim), pspec, want, tp.lm)
        ws = p[f"ws{spec.w_bits}"]
        if rows:
            y = kops.cim_matmul_deployed_rows(
                x, wl, ws, spec, key, xs, tp.model_index() * k_here, k_dim,
                reduce, row0=row0)
        else:
            y = kops.cim_matmul_deployed(x, wl, ws, spec, key, x_scale=xs,
                                         row0=row0, col0=col0)
        y = y.to(x.dtype)
    if "b" in p:
        b = p["b"]
        y = y + (b[col0:col0 + y.shape[-1]] if mdim == 1 else b).to(x.dtype)
    return y
