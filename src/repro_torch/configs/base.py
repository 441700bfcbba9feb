"""Model configuration dataclasses for the PyTorch port.

The port keeps its own copy of the fields its serving paths read
(``repro.configs.base`` is the reference); field names, defaults and the
derived properties are the reference's, so a config built on either side
describes the same model.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"                 # mha | mqa | gqa
    num_heads: int = 32
    num_kv_heads: int = 8             # ==num_heads -> MHA, ==1 -> MQA
    head_dim: int = 128
    rope_theta: float = 500_000.0
    qkv_bias: bool = False            # qwen2 uses bias on QKV
    causal: bool = True
    window: Optional[int] = None      # sliding-window attention
    # Pad query heads up to a multiple; pad heads are zero in wq and wo
    # (exact semantics).  1 = off (published config).
    head_pad_multiple: int = 1

    @property
    def heads_padded(self) -> int:
        m = self.head_pad_multiple
        h = ((self.num_heads + m - 1) // m) * m
        # keep the GQA group structure intact
        kvh = self.kv_heads_effective()
        if h % kvh:
            h = ((h + kvh - 1) // kvh) * kvh
        return h

    def kv_heads_effective(self) -> int:
        if self.kind == "mha":
            return self.num_heads
        if self.kind == "mqa":
            return 1
        return self.num_kv_heads


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"               # rwkv6 | mamba
    d_state: int = 16                 # mamba state dim
    d_conv: int = 4                   # mamba conv width
    expand: int = 2                   # mamba expansion
    head_dim: int = 64                # rwkv6 head size
    dt_rank: int = 0                  # 0 -> d_model//16


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"             # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int = 16
    d_model: int = 2048
    d_ff: int = 8192                  # dense-MLP hidden (SwiGLU)
    vocab_size: int = 128_256
    attention: Optional[AttentionConfig] = field(
        default_factory=AttentionConfig)   # None for attention-free models
    ssm: Optional[SSMConfig] = None
    # Layer pattern within a repeating group: "attn" | "rwkv6" blocks
    # ("mamba" is not ported).
    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # Pad the embedding/head vocab dim up to a multiple; pad logits are
    # masked to -1e30.  1 = off (the published config).
    vocab_pad_multiple: int = 1
    tie_embeddings: bool = False
    mlp_bias: bool = False
    dtype: str = "bfloat16"
    # CPU only: prefill attention through the flash op's plain version
    # instead of the plain sdpa (the reference's Pallas switch).  CUDA
    # tensors always take the hand-written kernels, whatever it says.
    use_kernels: bool = False
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 | fp8 (paged pools)
    kv_cache_style: str = "full"      # full | gqa | mqa
    quant: str = "bf16"               # bf16 | fp8 | int8 | int4  (weights)
    # quantized-weight matmuls of the forwards: on the CPU "fused" runs the
    # plain versions of the CUDA kernels and "ref" the oracles; CUDA
    # tensors always take the kernels, whatever it says
    quant_matmul_impl: str = "fused"  # fused | ref

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def blocks_per_group(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        if self.num_layers % self.blocks_per_group:
            raise ValueError(
                f"num_layers={self.num_layers} not divisible by "
                f"pattern of {self.blocks_per_group}")
        return self.num_layers // self.blocks_per_group
