"""vit-small-cifar [vit] — the paper's own demonstration network (Fig. 6).

12 transformer layers, patch 4 on 32x32 -> 64 patches + cls. The paper runs
the linears on the macro (MLP 6b w/CB, attention 4b wo/CB: SAC), reaching
95.8 % against 96.8 % ideal on CIFAR-10.
"""

from repro_torch.configs.base import CIMModelConfig, ModelConfig

CONFIG = ModelConfig(
    name="vit-small-cifar",
    family="vit",
    n_layers=12,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=0,
    image_size=32,
    patch_size=4,
    n_classes=10,
    use_rope=False,
    cim=CIMModelConfig(mode="qat", policy="paper_sac"),
)
