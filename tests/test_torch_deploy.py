"""The port's deploy pass and parameter bridge against the JAX package:
deployed int8 planes and their scales bit-equal, the converted tree equal
leaf for leaf, and the torch-native initialiser equal in law."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import deploy as jdeploy
from repro.models.model import build as jbuild
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import deploy


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planes_bit_equal_jax_deploy(dtype):
    jc = dataclasses.replace(jget("qwen2-0.5b").reduced(), dtype=dtype)
    tc = dataclasses.replace(get_config("qwen2-0.5b").reduced(), dtype=dtype)
    params, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    jd = _flat(jax.tree.map(np.asarray, jdeploy.deploy(jc, params)))
    td = _flat(deploy.deploy(tc, deploy.params_from_jax(
        jax.tree.map(np.asarray, params))))
    assert sorted(jd) == sorted(td)
    planes = [k for k in jd if k.rsplit("/", 1)[1][:2] in ("wq", "ws")]
    assert len(planes) == 14
    for k in jd:
        a, b = jd[k], td[k]
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(a.view(np.int16),
                                          b.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
    assert deploy.plane_summary(_unflat(td)) == jdeploy.plane_summary(
        jdeploy.deploy(jc, params))


def _unflat(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_init_params_matches_jax_tree_in_law():
    jc = jget("qwen2-0.5b").reduced()
    tc = get_config("qwen2-0.5b").reduced()
    jp = _flat(jax.tree.map(np.asarray, jbuild(jc).init(
        jax.random.PRNGKey(0))[0]))
    tp = _flat(deploy.init_params(tc, torch.Generator().manual_seed(0),
                                  "cpu"))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        a, b = jp[k], tp[k].numpy()
        assert a.shape == b.shape and str(b.dtype) == str(a.dtype), k
        if k.endswith("/b"):
            assert not b.any()
        elif k.endswith("/g"):
            assert (b == 1).all()
        else:
            # N(0, 1/d_in) weights and N(0, 0.02^2) embeddings: stds
            # agree within sampling error
            assert abs(a.std() / b.std() - 1) < 0.05, k


def test_registry_lists_only_ported_archs():
    """Every arch of the reference's registry is ported: the lists equal,
    and an unknown name raises ``KeyError``."""
    from repro.configs.registry import list_archs as jlist
    assert list_archs() == jlist() == [
        "deepseek-67b", "deepseek-v2-236b", "internlm2-1.8b", "mamba2-130m",
        "olmoe-1b-7b", "phi3-mini-3.8b", "pixtral-12b", "qwen2-0.5b",
        "vit-small-cifar", "whisper-medium", "zamba2-7b"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-9b")
    for arch in list_archs():
        full, ref = get_config(arch), jget(arch)
        for ours, theirs in ((full, ref), (full.reduced(), ref.reduced())):
            for f in dataclasses.fields(ours):
                a, b = getattr(ours, f.name), getattr(theirs, f.name)
                if f.name in ("cim", "moe", "ssm", "mla") and a is not None:
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, (arch, f.name)
            assert ours.param_count() == theirs.param_count()


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy.init_params(cfg, torch.Generator())
