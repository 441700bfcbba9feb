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
    kind: str = "gqa"                 # mha | mqa | gqa | mla
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
    # MLA latent compression dims (data for the cost model; no model
    # runs MLA yet)
    q_lora_rank: int = 0              # 0 -> no q compression
    kv_lora_rank: int = 512
    rope_head_dim: int = 64           # decoupled RoPE dims for MLA

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
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff: int = 2048                  # per-expert hidden
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    num_shared_experts: int = 0       # always-on experts (llama4-style)
    shared_d_ff: int = 0
    # Pad the expert count up to a multiple; pad experts are never routed
    expert_pad_multiple: int = 1

    @property
    def padded_experts(self) -> int:
        m = self.expert_pad_multiple
        return ((self.num_experts + m - 1) // m) * m


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"               # rwkv6 | mamba
    d_state: int = 16                 # mamba state dim
    d_conv: int = 4                   # mamba conv width
    expand: int = 2                   # mamba expansion
    head_dim: int = 64                # rwkv6 head size
    dt_rank: int = 0                  # 0 -> d_model//16


@dataclass(frozen=True)
class EncoderConfig:
    num_layers: int = 6
    max_source_len: int = 1500        # precomputed frame embeddings


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
    # MoE blocks are served (models/moe.py); the encoder and
    # cross-attention run through LM.prefill(modality_input=); the ssm
    # field configures RWKV-6 or Mamba blocks (eager Engine only)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # Layer pattern within a repeating group: "attn" | "mamba" | "rwkv6"
    # blocks.
    block_pattern: Tuple[str, ...] = ("attn",)
    moe_every: int = 1                # MoE MLP on every n-th block
    cross_attn_every: int = 0         # VLM cross-attention every n blocks
    num_image_tokens: int = 1024      # stub patch-embedding count
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # Pad the embedding/head vocab dim up to a multiple; pad logits are
    # masked to -1e30.  1 = off (the published config).
    vocab_pad_multiple: int = 1
    tie_embeddings: bool = False
    mlp_bias: bool = False
    max_seq_len: int = 32_768
    dtype: str = "bfloat16"
    # training (LM.loss and the train/ loop): the remat policy of each
    # group under train=True (full | dots | none); scan_layers is the
    # reference's group-stacked layout, applied here only where it decides
    # a result (remat, and which leaves weight decay reaches: a leaf
    # stacked on the reference's group axis has one more dimension);
    # ce_chunk is the chunked cross-entropy's segment length
    remat_policy: str = "full"
    scan_layers: bool = True
    # attention impl: auto = chunked (online softmax over kv blocks) when
    # seq >= attn_chunk_min, else the plain grouped sdpa.  On the CPU only:
    # CUDA tensors always take the flash kernel, the same online softmax
    attn_impl: str = "auto"           # auto | eager | chunked
    attn_q_block: int = 1024
    attn_kv_block: int = 1024
    attn_chunk_min: int = 2048
    # CPU only: prefill attention through the flash op's plain version
    # instead of the plain sdpa (the reference's Pallas switch).  CUDA
    # tensors always take the hand-written kernels, whatever it says.
    use_kernels: bool = False
    # MoE dispatch: tokens are routed in groups of moe_group_size (a
    # token's expert capacity depends on its group); einsum (GShard) |
    # gather (sort / scatter)
    moe_group_size: int = 512
    moe_impl: str = "einsum"
    ce_chunk: int = 1024
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 | fp8
    kv_cache_style: str = "full"      # full | gqa | mqa
    quant: str = "bf16"               # bf16 | fp8 | int8 | int4  (weights)
    quant_method: str = "none"        # none | gptq | awq | smoothquant
    # quantized-weight matmuls of the forwards: on the CPU "fused" runs the
    # plain versions of the CUDA kernels and "ref" the oracles; CUDA
    # tensors always take the kernels, whatever it says
    quant_matmul_impl: str = "fused"  # fused | ref
    # the speculative-decoding arm the cost model prices (AE-LLM c_inf
    # "spec"); the engines take theirs as arguments
    spec_decode: str = "none"         # none | ngram | draft
    spec_draft_k: int = 4             # max draft tokens per verify round
    # serving mesh: size of the "model" axis the paged engines serve over
    # (their mesh=, launch.serve --model-parallel; repro_torch.sharding).
    # 1 = one rank, exactly the unsharded path
    model_parallel: int = 1
    # paged attention under a model axis: "kv_shard" keeps each rank's kv
    # heads local (no KV crosses between ranks); "gather" is the naive
    # baseline that all-gathers q and the pools into every rank each step
    # (collective-byte A/B only)
    tp_attn_impl: str = "kv_shard"    # kv_shard | gather
    # contiguous-cache decode under a mesh: "eager" (a rank's kv heads) |
    # "cp" (context parallel: the cache's sequence split over the model
    # axis, partial softmax stats combined across ranks;
    # serve/decode_attn.py) | "paged_pallas" (the paged cache, which the
    # dry-run's decode cell allocates; the engines pick their layout
    # themselves, so this names the reference's value only)
    decode_attn_impl: str = "eager"

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

    def param_count(self) -> int:
        """Analytic parameter count (the cost model's), the reference's
        formula: a norm counts its scale only and an RWKV-6 mixer six
        d x d projections, so it exceeds the built model's tree for
        layernorm and RWKV-6 configs."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                   # lm head
        for li in range(self.num_layers):
            kind = self.block_pattern[li % self.blocks_per_group]
            n += d  # pre-norm scale
            if kind == "attn":
                n += self._attn_params()
            elif kind == "rwkv6":
                n += self._rwkv6_params()
            elif kind == "mamba":
                n += self._mamba_params()
            # MLP / MoE
            n += d  # post-norm scale
            if self.moe is not None and (li % self.moe_every == 0):
                m = self.moe
                n += d * m.num_experts                 # router
                n += m.num_experts * 3 * d * m.d_ff    # swiglu experts
                if m.num_shared_experts:
                    n += m.num_shared_experts * 3 * d * m.shared_d_ff
            else:
                n += 3 * d * self.d_ff                 # swiglu
            if self.cross_attn_every and \
                    ((li + 1) % self.cross_attn_every == 0):
                n += self._attn_params() + d
        n += d                                          # final norm
        if self.encoder is not None:
            for _ in range(self.encoder.num_layers):
                n += self._attn_params() + 3 * d * self.d_ff + 2 * d
        return n

    def _attn_params(self) -> int:
        a = self.attention
        d = self.d_model
        if a is None:
            return 0
        if a.kind == "mla":
            rr = a.rope_head_dim
            n = d * (a.kv_lora_rank + rr)                 # kv down + k_rope
            n += a.kv_lora_rank * a.num_heads * (a.head_dim * 2)  # k/v up
            if a.q_lora_rank:
                n += d * a.q_lora_rank \
                    + a.q_lora_rank * a.num_heads * (a.head_dim + rr)
            else:
                n += d * a.num_heads * (a.head_dim + rr)
            n += a.num_heads * a.head_dim * d             # out proj
            return n
        kvh = a.kv_heads_effective()
        n = d * a.num_heads * a.head_dim                  # Q
        n += 2 * d * kvh * a.head_dim                     # K,V
        n += a.num_heads * a.head_dim * d                 # O
        if a.qkv_bias:
            n += (a.num_heads + 2 * kvh) * a.head_dim
        return n

    def _rwkv6_params(self) -> int:
        d = self.d_model
        # r,k,v,g,w projections + out + time-mix lora + decay lora + u
        return 6 * d * d + 5 * d * 32 * 2 + d * 64 * 2 + 2 * d

    def _mamba_params(self) -> int:
        d = self.d_model
        s = self.ssm or SSMConfig(kind="mamba")
        di = s.expand * d
        dtr = s.dt_rank or max(1, d // 16)
        n = d * 2 * di                       # in proj (x, z)
        n += di * s.d_conv                   # conv
        n += di * (dtr + 2 * s.d_state)      # x -> dt,B,C
        n += dtr * di + di                   # dt proj
        n += di * s.d_state + di             # A_log, D
        n += di * d                          # out proj
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n = self.param_count()
        moe_layers = len([i for i in range(self.num_layers)
                          if i % self.moe_every == 0])
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model * m.d_ff
        return n - moe_layers * inactive


# ---------------------------------------------------------------------------
# Input shapes (the reference's assigned shape grid)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
