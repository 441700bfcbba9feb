"""The paper's own evaluation models (Table 2 scales).

AE-LLM's experiments span Small (0.5B-2B) / Medium (7B-14B) /
Large (30B-70B); the table drivers (``repro_torch.tables``) tune these
configs.  The assigned-architecture grid lives in the sibling
``<arch>.py`` modules.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

# LLaMA-2 7B (the paper's main ablation model, Table 3)
def llama2_7b() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense", num_layers=32, d_model=4096,
        d_ff=11_008, vocab_size=32_000,
        attention=AttentionConfig(kind="mha", num_heads=32, num_kv_heads=32,
                                  head_dim=128, rope_theta=10_000.0))


def mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="mistral-7b", family="dense", num_layers=32, d_model=4096,
        d_ff=14_336, vocab_size=32_000,
        attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8,
                                  head_dim=128, rope_theta=10_000.0,
                                  window=4096))


def llama2_1b() -> ModelConfig:
    # "LLaMA-2-1B" of the paper's Small tier (TinyLlama-style dims)
    return ModelConfig(
        name="llama2-1b", family="dense", num_layers=22, d_model=2048,
        d_ff=5632, vocab_size=32_000,
        attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=4,
                                  head_dim=64, rope_theta=10_000.0))


def llama2_70b() -> ModelConfig:
    return ModelConfig(
        name="llama2-70b", family="dense", num_layers=80, d_model=8192,
        d_ff=28_672, vocab_size=32_000,
        attention=AttentionConfig(kind="gqa", num_heads=64, num_kv_heads=8,
                                  head_dim=128, rope_theta=10_000.0))


def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
        d_ff=14_336, vocab_size=32_000,
        attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8,
                                  head_dim=128, rope_theta=1_000_000.0),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=14_336))


def llava_1_5_7b() -> ModelConfig:
    # Table 4 VLM: LLaVA-1.5 = CLIP tower (stub) + Vicuna-7B backbone,
    # image patches prepended via cross-attn blocks in our substrate.
    return ModelConfig(
        name="llava-1.5-7b", family="vlm", num_layers=32, d_model=4096,
        d_ff=11_008, vocab_size=32_000,
        attention=AttentionConfig(kind="mha", num_heads=32, num_kv_heads=32,
                                  head_dim=128, rope_theta=10_000.0),
        block_pattern=("attn",) * 4, cross_attn_every=4,
        num_image_tokens=576)


PAPER_MODELS = {
    "llama2-1b": llama2_1b,
    "llama2-7b": llama2_7b,
    "mistral-7b": mistral_7b,
    "llama2-70b": llama2_70b,
    "mixtral-8x7b": mixtral_8x7b,
    "llava-1.5-7b": llava_1_5_7b,
}
