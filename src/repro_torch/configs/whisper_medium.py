"""whisper-medium [audio] — enc-dec, conv frontend STUB — arXiv:2212.04356.

24 encoder + 24 decoder layers. The conv/mel frontend is a stub: a batch's
``frames`` carry precomputed frame embeddings (B, n_frames, d_model) as
the encoder input.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,          # decoder depth
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    n_frames=1500,
    use_rope=False,
)
