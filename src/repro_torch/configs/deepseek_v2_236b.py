"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6.

arXiv:2405.04434. d_ff=1536 is the *per-expert* FFN width.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,      # MLA: heads share the compressed KV; kept for bookkeeping
    d_ff=1536,           # per-expert
    vocab_size=102400,
    head_dim=128,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2),
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
)
