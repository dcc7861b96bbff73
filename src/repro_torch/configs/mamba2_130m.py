"""mamba2-130m [ssm] — SSD (state-space duality) — arXiv:2405.21060."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,           # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4, ngroups=1),
)
