"""internlm2-1.8b [dense] — GQA — arXiv:2403.17297 (hf-verified)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,        # GQA
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1000000.0,
)
