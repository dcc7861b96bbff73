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


TORCH_CASES = {"compress": torch_compress, "pipeline": torch_pipeline,
               "deploy": torch_deploy}
JAX_CASES = {"compress": jax_compress, "pipeline": jax_pipeline}


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
