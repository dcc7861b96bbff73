"""olmoe-1b-7b [moe] — 64 experts top-8 — arXiv:2409.02060 (hf-verified)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,           # per-expert
    vocab_size=50304,
    moe=MoEConfig(n_experts=64, top_k=8, n_shared=0),
)
