"""Model features φ(M) and task features ψ(T) for the surrogates (Eq. 5).

The port's copy of ``repro/core/features.py``."""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig

TASK_DOMAINS = ["understanding", "generation", "long_context", "multi_turn",
                "vision"]


@dataclass(frozen=True)
class TaskSpec:
    name: str
    domain: str                 # one of TASK_DOMAINS
    difficulty: float           # 0..1
    seq_len: int = 512
    numeric: bool = False       # GSM8K-style sensitivity to quantization


# The paper's 10 tasks (+3 VLM tasks for §4.4)
TASKS = {
    "mmlu": TaskSpec("mmlu", "understanding", 0.7, 1024),
    "hellaswag": TaskSpec("hellaswag", "understanding", 0.45, 512),
    "arc_easy": TaskSpec("arc_easy", "understanding", 0.3, 512),
    "gsm8k": TaskSpec("gsm8k", "generation", 0.8, 1024, numeric=True),
    "humaneval": TaskSpec("humaneval", "generation", 0.85, 1024, numeric=True),
    "alpacaeval": TaskSpec("alpacaeval", "generation", 0.5, 1024),
    "longbench": TaskSpec("longbench", "long_context", 0.75, 8192),
    "needle": TaskSpec("needle", "long_context", 0.6, 16384),
    "mtbench": TaskSpec("mtbench", "multi_turn", 0.7, 2048),
    "vicuna": TaskSpec("vicuna", "multi_turn", 0.5, 2048),
    "vqav2": TaskSpec("vqav2", "vision", 0.6, 1024),
    "coco_caption": TaskSpec("coco_caption", "vision", 0.5, 1024),
    "textvqa": TaskSpec("textvqa", "vision", 0.7, 1024),
}


def encode_model(cfg: ModelConfig) -> list:
    n = cfg.param_count()
    a = cfg.attention
    return [
        math.log10(max(n, 1)),
        float(cfg.num_layers),
        float(cfg.d_model) / 1024.0,
        float(cfg.d_ff) / 4096.0,
        math.log10(max(cfg.vocab_size, 1)),
        float(a.num_heads if a else 0),
        float(a.kv_heads_effective() if a else 0),
        1.0 if cfg.moe is not None else 0.0,
        float(cfg.moe.num_experts if cfg.moe else 0),
        1.0 if "mamba" in cfg.block_pattern or "rwkv6" in cfg.block_pattern
        else 0.0,
    ]


def encode_task(t: TaskSpec) -> list:
    dom = [1.0 if t.domain == d else 0.0 for d in TASK_DOMAINS]
    return dom + [t.difficulty, math.log2(max(t.seq_len, 1)) / 20.0,
                  1.0 if t.numeric else 0.0]
