"""The port's sharding rules and tensor-parallel deploy against the JAX
package: ``models.model.param_specs`` (shapes and logical axes, leaf for
leaf) for every arch of the registry; the rules' parameter and activation
specs on the virtual meshes pod2x16x16, 16x16, 2x4 and 1x2 (every
parameter of every arch, and the models' activation name tuples); the
``VirtualMesh`` and axis helpers; ``plan_deploy_sharding`` key for key
for every arch, deepseek-v2-236b and zamba2-7b included; and
``deploy(rules=)`` on two gloo ranks: every plane a DTensor whose local
shard equals its slice of the unsharded plane bit for bit, and the CIM
kernel's plain version on a column shard equal to the column slice of the
whole plane's output (readout noise zero)."""

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jget
from repro.configs.registry import list_archs
from repro.core.deploy import plan_deploy_sharding as jplan
from repro.core.guard import GuardSpec as JGuardSpec
from repro.distributed import sharding as jsh
from repro.models.model import param_specs as jparam_specs
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import plan_deploy_sharding
from repro_torch.core.guard import GuardSpec
from repro_torch.distributed import sharding as sh
from repro_torch.models.model import param_specs
from torch_dist_helpers import run_ranks

ARCHS = list_archs()
MESHES = [dict(pod=2, data=16, model=16), dict(data=16, model=16),
          dict(data=2, model=4), dict(data=1, model=2)]
ACTIVATIONS = [("batch", "seq", "embed"), ("batch", "seq", "heads", None),
               ("batch", "seq", "kv_heads", "head_dim"),
               ("batch", "heads", "qseq", "seq"), ("batch", "seq", "mlp"),
               ("batch", "seq", "vocab"), ("experts", "batch", "embed"),
               ("batch", "frames", "embed"), ("batch", "seq", "state")]
ACT_SHAPES = [(8, 128, 896), (32, 4096, 14, 64), (16, 2048, 2, 128),
              (64, 16, 512, 512), (2, 96, 4864), (256, 1, 151936),
              (160, 48, 5120), (4, 1500, 1024), (8, 64, 128)]


def _is_axes(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _flat_jax(tree, leaf=None):
    return {tuple(p.key for p in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, pre + (k,)) if isinstance(v, dict)
                   else {pre + (k,): v})
    return out


@pytest.fixture(scope="module")
def specs():
    return {a: (jparam_specs(jget(a)), param_specs(get_config(a)))
            for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(specs, arch):
    """Every leaf's path and shape (meta tensors: nothing allocated), and
    its logical axes."""
    (jshapes, jaxes), (shapes, axes) = specs[arch]
    got = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    assert all(v.device.type == "meta" for v in _flat(shapes).values())
    assert got == {k: tuple(v.shape) for k, v in _flat_jax(jshapes).items()}
    assert _flat(axes) == _flat_jax(jaxes, _is_axes)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
def test_rule_specs_equal_jax(specs, mesh):
    """Parameter specs of every leaf of every arch, activation specs of
    the models' name tuples, under the default rules and their variants
    (sequence-sharded, no FSDP): each equal to the reference's spec."""
    vm, jvm = sh.VirtualMesh.make(**mesh), jsh.VirtualMesh.make(**mesh)
    for kw in ({}, dict(seq_sharded=True), dict(fsdp_params=False)):
        rules, jrules = sh.default_rules(vm, **kw), jsh.default_rules(jvm,
                                                                      **kw)
        for arch in ARCHS:
            _, (shapes, axes) = specs[arch]
            flat_axes = _flat(axes)
            for path, t in _flat(shapes).items():
                names, shape = flat_axes[path], tuple(t.shape)
                assert rules.param_spec(names, shape) == tuple(
                    jrules.param_spec(names, shape)), (arch, path)
        for names, shape in zip(ACTIVATIONS, ACT_SHAPES):
            assert rules.activation_spec(names, shape) == tuple(
                jrules.activation_spec(names, shape)), names


def test_virtual_mesh_and_axis_helpers_equal_jax():
    for mesh in MESHES + [dict(data=8), dict(pod=4)]:
        vm, jvm = sh.VirtualMesh.make(**mesh), jsh.VirtualMesh.make(**mesh)
        assert vm.shape == jvm.shape
        assert sh.mesh_axis_sizes(vm) == jsh.mesh_axis_sizes(jvm)
        assert sh.dp_axes(vm) == jsh.dp_axes(jvm)
        assert sh.tp_axis(vm) == jsh.tp_axis(jvm)
        assert sh.pp_axis(vm) == jsh.pp_axis(jvm)
        assert vm.devices.size == jvm.devices.size
    with pytest.raises(ValueError) as got:
        sh.VirtualMesh.make(rows=4, data=2)
    with pytest.raises(ValueError) as want:
        jsh.VirtualMesh.make(rows=4, data=2)
    assert str(got.value) == str(want.value)
    assert sh.MESH_AXES == jsh.MESH_AXES


def test_rules_context_and_shard_identity():
    import torch
    rules = sh.default_rules(sh.VirtualMesh.make(data=2, model=2))
    x = torch.ones(4, 3)
    assert sh.get_rules() is None
    with sh.use_rules(rules) as r:
        assert r is rules and sh.get_rules() is rules
        assert sh.shard(x, "batch", "embed") is x
    assert sh.get_rules() is None
    vm = sh.VirtualMesh.make(pod=2, data=2, model=2)
    spec = ("model", ("pod", "data"), None)
    assert sh.local_slice(spec, (4, 8, 3), vm,
                          {"pod": 1, "data": 0, "model": 1}) == (
        slice(2, 4), slice(4, 6), slice(None))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_deploy_sharding_equal_jax(arch):
    """The report equals the reference's dict key for key on a 16x16
    virtual mesh (and, for two archs, with a segmented checksum guard);
    a config with no SAC policy raises in both."""
    cases = [(sh.VirtualMesh.make(data=16, model=16),
              jsh.VirtualMesh.make(data=16, model=16), False, False)]
    if arch in ("qwen2-0.5b", "deepseek-v2-236b"):
        cases.append((sh.VirtualMesh.make(pod=2, data=2, model=4),
                      jsh.VirtualMesh.make(pod=2, data=2, model=4),
                      GuardSpec(segments=4), JGuardSpec(segments=4)))
    for vm, jvm, guard, jguard in cases:
        try:
            want = jplan(jget(arch), jsh.default_rules(jvm), guard=jguard)
        except ValueError as e:
            with pytest.raises(ValueError, match="no SAC policy"):
                plan_deploy_sharding(get_config(arch), sh.default_rules(vm))
            assert "no SAC policy" in str(e)
            continue
        got = plan_deploy_sharding(get_config(arch), sh.default_rules(vm),
                                   guard=guard)
        assert got == want
        assert got["ok"] and got["tp_sharded_planes"] > 0


def test_deploy_rules_two_ranks_bit_identical(tmp_path):
    ranks = run_ranks("deploy", 2, tmp_path, {"unused": np.zeros(1)})
    for r in ranks:
        assert int(r["planes"]) == 21 and int(r["tp_sharded"]) == 9
        assert int(r["mismatch"]) == 0 and int(r["misplaced"]) == 0
        for name in ("q", "gate"):
            assert float(r[f"row1_{name}_err"]) == 0.0
    assert int(ranks[0]["row1_q_cols"]) == 64
    assert int(ranks[0]["row1_gate_cols"]) == 128
