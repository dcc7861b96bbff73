"""deepseek-67b [dense, llama-arch] — arXiv:2401.02954 (hf-verified)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,        # GQA
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
)
