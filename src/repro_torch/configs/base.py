"""Config schema of the port (a copy of the JAX package's
``configs/base.py``; the port imports nothing of that package).

One ``ModelConfig`` describes an architecture; ``reduced()`` builds the
same-family tiny config the CPU tests use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CIMModelConfig:
    """How the macro executes the model's linears (off = ideal digital)."""

    mode: str = "off"            # "off" | "qat" (training) | "sim"
    policy: str = "paper_sac"    # SAC policy name (core/sac.py)
    act_clip_sigmas: float = 4.0  # activation scale = clip at k*rms
    use_kernel: bool = False      # deployed sim-mode matmuls through the
                                  # fused-act-quant CIM kernel; the port's
                                  # only sim path, so sim requires True


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    n_shared: int = 0            # always-on shared experts (deepseek-v2: 2)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block shape (arXiv:2405.21060)."""

    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    ngroups: int = 1
    chunk: int = 256             # SSD chunk; prefill pads to a multiple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (deepseek-v2, arXiv:2405.04434)."""

    q_lora: int = 1536
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|encdec|vlm|vit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # hybrid (zamba2): repeating super-block of (attn_period-1) mamba layers
    # + 1 *shared-weight* attention layer
    attn_period: int = 0
    # encoder-decoder (whisper): n_layers is the decoder depth
    n_enc_layers: int = 0
    n_frames: int = 1500         # encoder memory length (stub frontend)
    # vlm (pixtral): the first n_patches positions come from the (stub)
    # vision frontend as precomputed patch embeddings
    n_patches: int = 0
    # vit (the paper's CIFAR demo)
    image_size: int = 32
    patch_size: int = 4
    n_classes: int = 10
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    attn_impl: str = "einsum"    # "einsum" (dense masked-softmax reference)
                                 # | "kernel" (decode + flash GQA kernels)
    kv_cache_int8: bool = False  # int8 GQA cache, per (token, kv head) scale
    fuse_layer: bool = False      # decode-shaped dense blocks run as ONE
                                  # kernel launch per layer (megakernel:
                                  # QKV + rope + length-aware attention +
                                  # O + SwiGLU, kernels/fused_step.py);
                                  # requires mode off, or sim with deployed
                                  # planes (in-kernel cim_matmul_fused math)
    cim: CIMModelConfig = CIMModelConfig()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), the
        reference's formula. For hybrid and encdec it is not the size of
        the params tree: hybrid counts a ``3*d*f`` MLP per mamba layer that
        the tree does not have, encdec an untied head and an approximate
        cross-attention term (zamba2-7b: 12.97 B here, 4.53 B in the tree;
        whisper-medium 1.11 B, 0.758 B)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid":
            s = self.ssm
            di = s.expand * d
            mamba = (d * (2 * di + 2 * s.ngroups * s.d_state
                          + di // s.headdim) + di * d + 3 * d * f)
            n_mamba = self.n_layers - self.n_layers // self.attn_period
            qkv = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                   + self.n_heads * hd * d)
            return emb + n_mamba * mamba + qkv + 3 * d * f  # attn once
        if self.family == "ssm":
            s = self.ssm
            di = s.expand * d
            per_layer = (d * (2 * di + 2 * s.ngroups * s.d_state
                              + di // s.headdim) + di * d)
        elif self.family == "moe":
            m, a, h = self.moe, self.mla, self.n_heads
            if a is not None:
                qkv = (d * a.q_lora
                       + a.q_lora * h * (a.nope_head_dim + a.rope_head_dim)
                       + d * (a.kv_lora + a.rope_head_dim)
                       + a.kv_lora * h * (a.nope_head_dim + a.v_head_dim)
                       + h * a.v_head_dim * d)
            else:
                qkv = (d * hd * (h + 2 * self.n_kv_heads)
                       + h * hd * d)
            per_layer = (qkv + 3 * d * f * (m.n_experts + m.n_shared)
                         + d * m.n_experts)
        elif self.family == "vit":
            per_layer = 4 * d * d + 2 * d * f
        else:                    # dense, vlm, encdec
            qkv = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                   + self.n_heads * hd * d)
            per_layer = qkv + 3 * d * f
            if self.family == "encdec":
                per_layer += qkv     # cross attention (approx)
        n = self.n_layers + (self.n_enc_layers if self.family == "encdec"
                             else 0)
        return emb + n * per_layer

    def reduced(self) -> "ModelConfig":
        """Same-family tiny config for CPU tests (the JAX package's values)."""
        small = dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.attn_period == 0
                         else 2 * max(self.attn_period, 1)),
            d_model=256,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            head_dim=64,
            d_ff=512,
            vocab_size=512,
            max_seq_len=128,
            dtype="float32",
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=32,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
        )
        if self.moe is not None:
            small = dataclasses.replace(
                small, d_ff=128,
                moe=dataclasses.replace(self.moe,
                                        n_experts=min(self.moe.n_experts, 8),
                                        top_k=min(self.moe.top_k, 2)))
        if self.ssm is not None:
            small = dataclasses.replace(
                small, ssm=dataclasses.replace(self.ssm, d_state=16,
                                               headdim=32, chunk=32))
        if self.mla is not None:
            small = dataclasses.replace(
                small, mla=MLAConfig(q_lora=64, kv_lora=64, rope_head_dim=16,
                                     nope_head_dim=32, v_head_dim=32))
        if self.attn_period:
            small = dataclasses.replace(
                small, attn_period=min(self.attn_period, 3), n_layers=6)
        return small
