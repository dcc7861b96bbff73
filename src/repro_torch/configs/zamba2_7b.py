"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

arXiv:2411.15242. Modelled as 27 super-blocks of (2 Mamba2 layers + 1
shared-weight attention+MLP layer) = 81 layers; the attention/MLP params
are a single shared set (the arch's hallmark), as in the JAX package's
config.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    attn_period=3,       # every 3rd layer is the shared attention block
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, conv_width=4, ngroups=1),
)
