"""Multi-process runners of the port's distribution tests (not a test
module: no ``test_`` prefix).

``run_ranks(case, world, tmp)`` starts ``world`` processes, each one rank
of a gloo process group initialised through a ``file://`` store under
``tmp`` (so parallel test workers never share a port), runs the torch case
on every rank and returns each rank's arrays. ``run_jax(case, n, tmp)``
runs the JAX reference case in one process over ``n`` forced host
devices, on a mesh of Auto axis types (jax 0.9's ``jax.make_mesh``
defaults to Explicit ones, which the reference's shard_map code predates;
ROADMAP C9). Inputs go in as an ``.npz`` written by the caller, results
come back the same way.

  python tests/torch_dist_helpers.py torch CASE RANK WORLD DIR
  python tests/torch_dist_helpers.py jax CASE N DIR
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _load(path):
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def run_ranks(case, world, tmp, inputs, timeout=240):
    """Every rank's result arrays (a list, rank order)."""
    tmp = Path(tmp)
    np.savez(tmp / "inputs.npz", **inputs)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "torch", case, str(r), str(world),
         str(tmp)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs
    return [_load(tmp / f"rank{r}.npz") for r in range(world)]


def run_jax(case, n, tmp, inputs, timeout=300):
    tmp = Path(tmp)
    np.savez(tmp / "jax_inputs.npz", **inputs)
    out = subprocess.run(
        [sys.executable, __file__, "jax", case, str(n), str(tmp)],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"),
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return _load(tmp / "jax.npz")


# ------------------------------------------------------------ the cases


def torch_compress(rank, world, inp):
    """The compression cases reduce the gradient of ``sum(x @ (w[:4] *
    w[:4])) / 2 + sum(x[:, :1] * b)``: every product is one rounding in
    either framework, every sum exact (dyadic x)."""
    import torch
    from repro_torch.distributed.compression import compressed_dp_grads

    def grad_fn(p, b):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        w4 = leaves["w"][:4]
        loss = (b["x"] @ (w4 * w4)).sum() / 2 + (b["x"][:, :1]
                                                * leaves["b"]).sum()
        gs = torch.autograd.grad(loss, [leaves["b"], leaves["w"]])
        return {"b": gs[0], "w": gs[1]}

    params = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    batch = {"x": torch.from_numpy(inp["x"])}
    key = tuple(int(k) for k in inp["key"])
    got = compressed_dp_grads(grad_fn, params, batch, key=key)
    out = {f"g_{k}": v.numpy() for k, v in got.items()}
    if rank == 0:
        # the same formula reckoned in one process: every rank's gradient
        # and shared scale, each rank's rounding key, the int32 sum
        from repro_torch.core import prng
        from repro_torch.distributed.compression import quantize_int8
        b = inp["x"].shape[0] // world
        per = [grad_fn(params, {"x": batch["x"][r * b:(r + 1) * b]})
               for r in range(world)]
        for i, k in enumerate(sorted(per[0])):
            m = max(torch.maximum(g[k].abs().max(), torch.tensor(1e-12))
                    for g in per)
            scale = m / 127.0
            tot = sum(quantize_int8(g[k], prng.fold_in(prng.fold_in(key, i),
                                                       r), scale)
                      .to(torch.int32) for r, g in enumerate(per))
            out[f"one_{k}"] = (tot.to(torch.float32) * scale / world).numpy()
        # the plain mean of the shards' gradients (a sum loss: the whole
        # batch's gradient over the ranks)
        full = grad_fn(params, batch)
        out.update({f"mean_{k}": (v / world).numpy()
                    for k, v in full.items()})
    return out


def jax_compress(n, inp):
    import jax
    import jax.numpy as jnp
    from repro.distributed.compression import compressed_dp_grads
    mesh = jax.make_mesh((n,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    def grad_fn(p, b):
        def loss(p):
            w4 = p["w"][:4]
            return (jnp.sum(b["x"] @ (w4 * w4)) / 2
                    + jnp.sum(b["x"][:, :1] * p["b"]))
        return jax.grad(loss)(p)

    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    got = compressed_dp_grads(grad_fn, params, {"x": jnp.asarray(inp["x"])},
                              mesh, "data", jnp.asarray(inp["key"],
                                                        jnp.uint32))
    return {f"g_{k}": np.asarray(v) for k, v in got.items()}


def _stage_torch(w, xb):
    import torch
    return xb + torch.tanh(xb @ w)


def torch_pipeline(rank, world, inp):
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import pipeline_apply
    ws = torch.from_numpy(inp["ws"]).requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = pipeline_apply(_stage_torch, ws, x, n_micro=int(inp["n_micro"]))
    (y ** 2).sum().backward()
    # only stage 0 reads x: the other ranks' x has no gradient
    gw = ws.grad.clone()
    gx = x.grad.clone() if x.grad is not None else torch.zeros_like(x)
    dist.all_reduce(gw)
    dist.all_reduce(gx)
    return {"y": y.detach().numpy(), "gw": gw.numpy(), "gx": gx.numpy(),
            "own_gw": ws.grad[rank].numpy()}


def jax_pipeline(n, inp):
    import jax
    import jax.numpy as jnp
    from repro.distributed.pipeline import pipeline_apply
    mesh = jax.make_mesh((n,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    n_micro = int(inp["n_micro"])
    ws, x = jnp.asarray(inp["ws"]), jnp.asarray(inp["x"])

    def stage_fn(w, xb):
        return xb + jnp.tanh(xb @ w)

    def run(ws, x):
        return pipeline_apply(stage_fn, ws, x, mesh, axis="pod",
                              n_micro=n_micro)

    y = run(ws, x)
    gw, gx = jax.grad(lambda ws, x: jnp.sum(run(ws, x) ** 2),
                      argnums=(0, 1))(ws, x)
    seq = x
    for i in range(n):
        seq = stage_fn(ws[i], seq)
    return {"y": np.asarray(y), "gw": np.asarray(gw), "gx": np.asarray(gx),
            "seq": np.asarray(seq)}


def torch_deploy(rank, world, inp):
    """``deploy(rules=)`` of the tiny qwen2 (guarded) on a (data 1, model
    world) mesh against the unsharded deploy: every plane a DTensor whose
    local shard equals its slice of the whole plane, bit for bit; and the
    CIM kernel's plain version on a column shard of the q and gate planes
    (readout noise zero) equals the column slice of the whole plane's
    output."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import (deploy, init_params,
                                         plane_logical_axes)
    from repro_torch.distributed.sharding import (default_rules, local_slice,
                                                  placements)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import param_specs

    cfg = dataclasses.replace(
        get_config("qwen2-0.5b").reduced(), n_layers=2, d_model=128,
        d_ff=256, vocab_size=128, n_heads=4, n_kv_heads=2, head_dim=32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_debug_mesh(1, world, device_type="cpu")
    rules = default_rules(mesh)
    plain = deploy(cfg, params, guard=True)
    shard = deploy(cfg, params, guard=True, rules=rules)
    axes = param_specs(cfg)[1]
    coords = {"data": 0, "model": rank}
    stats = {"planes": 0, "tp_sharded": 0, "mismatch": 0, "misplaced": 0}

    def walk(a, b, ax, path):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], ax.get(k, {}), f"{path}/{k}")
            elif k.startswith(("wq", "ws", "wc")) or k[-3:-1] in ("_q", "_s"):
                stats["planes"] += 1
                assert isinstance(b[k], DTensor), (path, k)
                plane = "wq" if k.startswith("wq") else (
                    k[:2] if k[0] == "w" else k[-3:-1])
                base = ax.get("w") if "w" in ax else ax.get(k[:-3])
                names = plane_logical_axes(base, plane)
                spec = rules.param_spec(names, tuple(a[k].shape))
                if tuple(b[k].placements) != placements(spec, mesh):
                    stats["misplaced"] += 1
                if "model" in spec:
                    stats["tp_sharded"] += 1
                want = a[k][local_slice(spec, a[k].shape, mesh, coords)]
                if not torch.equal(b[k].to_local(), want):
                    stats["mismatch"] += 1

    walk(plain, shard, axes, "")
    out = {k: np.array(v) for k, v in stats.items()}
    out.update(row1_shard_errors(cfg, plain, shard, rank, "cpu"))
    return out


def row1_shard_errors(cfg, plain, shard, rank, device):
    """Row 1 (``cim_matmul_fused``, readout noise 0) on this rank's column
    shard of layer 0's q and gate planes against the column slice of the
    whole plane's output: the largest absolute difference of each."""
    import torch

    from repro_torch.core.sac import get_policy
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    pol = get_policy(cfg.cim.policy)
    g = torch.Generator(device=device).manual_seed(7)
    out = {}
    for name, node, full, spec in (
            ("q", shard["blocks"]["attn"]["q"],
             plain["blocks"]["attn"]["q"], pol.attn),
            ("gate", shard["blocks"]["mlp"]["gate"],
             plain["blocks"]["mlp"]["gate"], pol.mlp)):
        bits = spec.w_bits
        wq_full = full[f"wq{bits}"][0]
        wq = node[f"wq{bits}"].to_local()[0]
        n = wq.shape[-1]
        x = torch.randn((8, cfg.d_model), generator=g, device=device)
        # the activation scale and the output's (activation x weight)
        qp = torch.tensor([0.02, 0.02 * float(full[f"ws{bits}"][0])],
                          device=device)
        kw = dict(seed=(1, 2), sigma=0.0, in_bits=spec.in_bits)
        y = cim_matmul_fused(x, wq.contiguous(), qp, **kw)
        y_full = cim_matmul_fused(x, wq_full.contiguous(), qp, **kw)
        out[f"row1_{name}_err"] = np.array(float(
            (y - y_full[:, rank * n:(rank + 1) * n]).abs().max()))
        out[f"row1_{name}_cols"] = np.array(n)
    return out


# ------------------------------------- the models' sharded forward (A7.2)


def flat_tree(tree, pre="p"):
    """A nested dict of arrays as {"p/a/b": array} (npz keys)."""
    out = {}
    for k, v in tree.items():
        key = f"{pre}/{k}"
        out.update(flat_tree(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def unflat_tree(flat, pre="p"):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(pre + "/"):
            continue
        node = tree
        parts = key[len(pre) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def model_cfg(get_config, inp, mode):
    """The reduced config of a sharded-forward case (float32; attention
    through the einsum reference on the JAX side, through the kernels'
    routes (plain versions on the CPU) on the port's; the CIM kernel path
    in sim)."""
    import dataclasses
    base = get_config(str(inp["arch"]))
    return dataclasses.replace(
        base.reduced(), dtype="float32",
        cim=dataclasses.replace(base.cim, mode=mode, use_kernel=True))


def runs_of(inp):
    """The case's runs as (name, mode, data, model): ``inp["runs"]`` holds
    strings ``"<mode>:<data>x<model>"``."""
    out = []
    for r in inp["runs"]:
        mode, mesh = str(r).split(":")
        data, model = (int(v) for v in mesh.split("x"))
        out.append((str(r).replace(":", "_"), mode, data, model))
    return out


def _steps(inp):
    """The batch of each forward: the prefill, then one token a row for
    each decode step (forward i keyed ``fold_in(key, i)``)."""
    out = [inp["tokens"]]
    for i in range(inp["decode"].shape[0]):
        out.append(inp["decode"][i][:, None])
    return out


def jax_forward(n, inp):
    """The reference's forward of a case, each run on a (data, model)
    mesh of Auto axis types (over the first data x model of the ``n``
    forced devices) under ``use_rules(default_rules(mesh))`` (sim: the
    planes of ``deploy(rules=)``): per run the prefill's and the decode
    steps' logits, or with labels the loss; and the parameters it drew
    (``p/...``, from ``PRNGKey(0)``)."""
    import dataclasses
    import jax
    from repro.configs.registry import get_config
    from repro.core.deploy import deploy
    from repro.distributed.sharding import default_rules, use_rules
    from repro.models import transformer as jtf
    from repro.models.model import build
    key = jax.random.PRNGKey(int(inp["key"]))
    out = {}
    for name, mode, data, model in runs_of(inp):
        cfg = dataclasses.replace(model_cfg(get_config, inp, mode),
                                  attn_impl="einsum")
        api = build(cfg)
        params, _ = api.init(jax.random.PRNGKey(0))
        out.update(flat_tree(jax.tree.map(np.asarray, params)))
        mesh = jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:data * model])
        rules = default_rules(mesh)
        dp = deploy(cfg, params, rules=rules) if mode == "sim" else params
        with use_rules(rules):
            if "labels" in inp:
                loss = jax.jit(lambda p, b: api.loss(p, b, key))(
                    dp, {"tokens": inp["tokens"], "labels": inp["labels"]})
                out[f"{name}/loss"] = np.asarray(loss)
                continue
            fwd = jax.jit(lambda p, b, c, k: api.forward(p, b, k, c))
            caches = jtf.init_caches(cfg, inp["tokens"].shape[0],
                                     int(inp["max_len"]))
            for i, toks in enumerate(_steps(inp)):
                logits, caches = fwd(dp, {"tokens": toks}, caches,
                                     jax.random.fold_in(key, i))
                out[f"{name}/logits{i}"] = np.asarray(logits)
    return out


def torch_forward(rank, world, inp):
    """The port's forward of a case on this rank, each run on a (data,
    model) gloo mesh of the ``world`` ranks, the JAX parameters carried
    over (``params_from_jax``; sim: ``deploy(rules=)``): per run the
    global logits of the prefill and the decode steps
    (``parallel.gather_logits``) or the loss, the collectives' counts and
    (moe) the experts of this rank's bank block. Rank 0 also runs the same
    forwards with no rules (``one/...``) and, for moe, under rules on a
    ``VirtualMesh`` of the run's shape (``grouped/...``: the grouped
    dispatch in one process)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import deploy as dep
    from repro_torch.core import prng
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import (VirtualMesh, default_rules,
                                                  use_rules)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build
    from repro_torch.models.parallel import gather_logits
    params = dep.params_from_jax(unflat_tree(inp))
    b = inp["tokens"].shape[0]
    key = prng.PRNGKey(int(inp["key"]))
    out = {}

    def run(cfg, rules, placed):
        api = build(cfg)
        got = {}
        with use_rules(rules):
            if "labels" in inp:
                got["loss"] = api.loss(placed, {
                    "tokens": torch.from_numpy(inp["tokens"]),
                    "labels": torch.from_numpy(inp["labels"])},
                    key).detach().numpy()
                return got
            caches = tf.init_caches(cfg, b, int(inp["max_len"]))
            for i, toks in enumerate(_steps(inp)):
                logits, _ = api.forward(placed, {
                    "tokens": torch.from_numpy(np.ascontiguousarray(toks))},
                    prng.fold_in(key, i), caches)
                got[f"logits{i}"] = gather_logits(cfg, logits, b).numpy()
        return got

    for name, mode, data, model in runs_of(inp):
        cfg = model_cfg(get_config, inp, mode)
        sim = mode == "sim"
        rules = default_rules(make_debug_mesh(data, model, device_type="cpu"))
        placed = dep.deploy(cfg, params, rules=rules) if sim else params
        for k in col.COUNTS:
            col.COUNTS[k] = 0
        out.update({f"{name}/{k}": v
                    for k, v in run(cfg, rules, placed).items()})
        out.update({f"{name}/coll_{k}": np.array(v)
                    for k, v in col.COUNTS.items()})
        if cfg.moe is not None and sim:
            bank = [k for k in placed["blocks"]["moe"]
                    if k.startswith("w_gate_q")][0]
            out[f"{name}/local_experts"] = np.array(
                placed["blocks"]["moe"][bank].to_local().shape[1])
        if rank == 0:
            whole = dep.deploy(cfg, params) if sim else params
            out.update({f"{name}/one/{k}": v
                        for k, v in run(cfg, None, whole).items()})
            if cfg.moe is not None:
                vm = VirtualMesh.make(data=data, model=model)
                out.update({f"{name}/grouped/{k}": v for k, v in
                            run(cfg, default_rules(vm), whole).items()})
    return out


def torch_outside(rank, world, inp):
    """Under a live mesh every family and mode outside A7.2's slice must
    raise ``NotImplementedError`` naming ROADMAP A7.3 (never run
    unsharded numbers): 1 a case that raised so, else 0."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import deploy as dep
    from repro_torch.core import prng
    from repro_torch.distributed.sharding import default_rules, use_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build
    rules = default_rules(make_debug_mesh(1, world, device_type="cpu"))
    out = {}
    cases = [(a, "off", True) for a in
             ("mamba2-130m", "zamba2-7b", "deepseek-v2-236b",
              "whisper-medium", "vit-small-cifar")]
    cases += [("qwen2-0.5b", "sim", False), ("qwen2-0.5b", "qat", True)]
    for arch, mode, kernel in cases:
        base = get_config(arch)
        cfg = dataclasses.replace(
            base.reduced(), cim=dataclasses.replace(base.cim, mode=mode,
                                                    use_kernel=kernel))
        params = dep.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if mode == "sim":
            params = dep.deploy(cfg, params)
        if cfg.family == "vit":
            batch = {"images": torch.zeros((2, cfg.image_size,
                                            cfg.image_size, 3))}
        else:
            batch = {"tokens": torch.zeros((2, 4), dtype=torch.int64)}
            if cfg.family == "encdec":
                batch["frames"] = torch.zeros((2, cfg.n_frames, cfg.d_model))
        try:
            with use_rules(rules):
                build(cfg).forward(params, batch, prng.PRNGKey(0))
            out[f"{arch}_{mode}"] = np.array(0)
        except NotImplementedError as e:
            out[f"{arch}_{mode}"] = np.array(int("A7.3" in str(e)))
    with use_rules(rules):
        try:
            tf.init_caches(get_config("mamba2-130m").reduced(), 2, 8)
            out["mamba2_cache"] = np.array(0)
        except NotImplementedError as e:
            out["mamba2_cache"] = np.array(int("A7.3" in str(e)))
    return out


TORCH_CASES = {"compress": torch_compress, "pipeline": torch_pipeline,
               "deploy": torch_deploy, "forward": torch_forward,
               "outside": torch_outside}
JAX_CASES = {"compress": jax_compress, "pipeline": jax_pipeline,
             "forward": jax_forward}


def _main(argv):
    side, case = argv[0], argv[1]
    if side == "jax":
        n, tmp = int(argv[2]), Path(argv[3])
        np.savez(tmp / "jax.npz",
                 **JAX_CASES[case](n, _load(tmp / "jax_inputs.npz")))
        return
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, tmp = int(argv[2]), int(argv[3]), Path(argv[4])
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}",
                            rank=rank, world_size=world)
    try:
        out = TORCH_CASES[case](rank, world, _load(tmp / "inputs.npz"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(tmp / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    _main(sys.argv[1:])
