"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the reduced model's greedy tokens on the card against the CPU.

Every test here needs a CUDA card and skips elsewhere; the file imports
nothing of JAX, so it runs on the card as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerances: the CIM kernel's integer part (sigma = 0) is exact; with
noise, 1e-6 * tiles * max|y| + 1e-5 * sigma (Box-Muller's logf/cosf
ulps). Attention on a bf16 cache or with bf16 queries writes bf16 and
rounds p to bf16 before p @ V as the reference kernel does: 2^-6 of the
output's scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import cim, quant, sac
from repro_torch.core.deploy import init_params
from repro_torch.kernels.cim_matmul import (cim_matmul_fused,
                                            cim_matmul_fused_plain)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                 flash_gqa_plain)
from repro_torch.models.attention import _kv_quant
from repro_torch.serving.engine import Engine, Request

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [1, 4, 8, 32])
@pytest.mark.parametrize("k,n", [(896, 128), (896, 4864), (4864, 896)])
def test_cim_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    wq = torch.randint(-31, 32, (k, n), generator=g, device=cuda,
                       dtype=torch.int8)
    xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(6)
    qp = torch.stack([xs, torch.ones_like(xs)])
    assert torch.equal(cim_matmul_fused(x, wq, qp, None, 0.0, 6),
                       cim_matmul_fused_plain(x, wq, qp, None, 0.0, 6))
    sigma = cim.output_noise_std_int_per_tile(sac.paper_sac().mlp, k)
    yk = cim_matmul_fused(x, wq, qp, (5, 6), sigma, 6)
    yp = cim_matmul_fused_plain(x, wq, qp, (5, 6), sigma, 6)
    tol = 1e-6 * -(-k // 1024) * yp.abs().max().item() + 1e-5 * sigma
    assert (yk - yp).abs().max().item() <= tol


@pytest.mark.parametrize("int8", [False, True])
def test_attention_kernels_match_plain(cuda, int8):
    b, t, h, kv, d = 4, 320, 14, 2, 64
    g = torch.Generator(device=cuda).manual_seed(int(int8))
    kf = torch.randn((b, t, kv, d), generator=g, device=cuda)
    vf = torch.randn((b, t, kv, d), generator=g, device=cuda)
    if int8:
        (kc, ks), (vc, vs) = _kv_quant(kf), _kv_quant(vf)
    else:
        kc, vc, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
    q = torch.randn((b, h, d), generator=g, device=cuda).bfloat16()
    lens = torch.tensor([0, 1, 77, t], dtype=torch.int32, device=cuda)
    a = decode_attention(q, kc, vc, lens, ks, vs).float()
    p = decode_attention_plain(q, kc, vc, lens, ks, vs).float()
    assert (a - p).abs().max().item() <= 2 ** -6 * p.abs().max().item()
    assert a[0].abs().max().item() == 0.0
    qf = torch.randn((1, 32, h, d), generator=g, device=cuda).bfloat16()
    one = [None if x is None else x[:1] for x in (ks, vs)]
    for start in (0, 32, 256):
        st = torch.tensor([start], dtype=torch.int32, device=cuda)
        a, counts = flash_gqa_attention(qf, kc[:1], vc[:1], st, *one,
                                        return_block_counts=True)
        p = flash_gqa_plain(qf, kc[:1], vc[:1], st, *one).float()
        assert (a.float() - p).abs().max().item() <= \
            2 ** -6 * p.abs().max().item()
        assert counts[0, 0].tolist() == [-(-(start + 8 * (i + 1)) // 32)
                                         for i in range(4)]


def test_reduced_model_tokens_card_equal_cpu(cuda):
    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
    outs = [Engine(cfg, params, max_slots=2, max_len=128, attn_impl="kernel",
                   device=dev).generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
        for dev in (cuda, "cpu")]
    assert outs[0] == outs[1]
