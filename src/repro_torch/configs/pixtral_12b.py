"""pixtral-12b [vlm] — pixtral-ViT (stub frontend) + mistral-nemo backbone.

hf:mistralai/Pixtral-12B-2409. The vision frontend is a STUB: a batch's
``patch_embeds`` carry precomputed patch embeddings for the first
``n_patches`` positions; the multimodal backbone is modelled in full.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,        # GQA
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1000000000.0,
    n_patches=1024,      # stub vision prefix length
)
