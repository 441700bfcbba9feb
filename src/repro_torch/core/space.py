"""AE-LLM configuration space  c = (c_arch, c_ft, c_inf)   [paper Table 1].

The port's copy of ``repro/core/space.py`` (numpy only).  Stage options:
  c_arch: attention {mha,mqa,gqa,mla} × moe {dense, 2/4/8 experts} × routing
          {top-1, top-2}
  c_ft:   method {full,lora,qlora,dora,rslora} × rank {8..128} × α {r,2r,4r}
  c_inf:  quant {bf16,fp8,int8,int4} × method {gptq,awq,smoothquant}
          × kv-cache {full,gqa,mqa} × speculation {none,ngram,draft} × k

("FP16" of the paper is BF16 here.)  Some arms are inapplicable per
architecture family (rwkv6: attention & kv arms) — ``space_for_family``
masks them.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import List

import numpy as np

ATTENTION_KINDS = ["mha", "mqa", "gqa", "mla"]
MOE_EXPERTS = [0, 2, 4, 8]            # 0 = dense
MOE_TOPK = [1, 2]
FT_METHODS = ["full", "lora", "qlora", "dora", "rslora"]
FT_RANKS = [8, 16, 32, 64, 128]
FT_ALPHA_MULT = [1, 2, 4]
QUANTS = ["bf16", "fp8", "int8", "int4"]
QUANT_METHODS = ["gptq", "awq", "smoothquant"]
KV_STYLES = ["full", "gqa", "mqa"]
# speculative decoding (repro_torch.spec): drafter arm × max draft length.
# Acceptance rate is workload-dependent (the very thing the adaptive
# search navigates) — the cost model carries per-arm priors.
SPEC_ARMS = ["none", "ngram", "draft"]
SPEC_DRAFT_KS = [2, 4, 8]


@dataclass(frozen=True)
class ArchChoice:
    attention: str = "gqa"
    moe_experts: int = 0
    moe_top_k: int = 1


@dataclass(frozen=True)
class FtChoice:
    method: str = "lora"
    rank: int = 16
    alpha_mult: int = 2


@dataclass(frozen=True)
class InfChoice:
    quant: str = "bf16"
    quant_method: str = "gptq"        # ignored when quant == bf16
    kv_style: str = "full"
    spec: str = "none"                # none | ngram | draft (repro_torch.spec)
    draft_k: int = 4                  # ignored when spec == "none"


@dataclass(frozen=True)
class EfficiencyConfig:
    arch: ArchChoice = ArchChoice()
    ft: FtChoice = FtChoice()
    inf: InfChoice = InfChoice()

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def default(cls):
        """The paper's 'Default' baseline: stock model, full FT, bf16."""
        return cls(ArchChoice("gqa", 0, 1), FtChoice("full", 0, 1),
                   InfChoice("bf16", "gptq", "full"))


@dataclass(frozen=True)
class SpaceMask:
    """Per-architecture applicability."""
    attention_arms: bool = True        # rwkv6: False
    kv_arms: bool = True               # rwkv6: False
    moe_arms: bool = True


def space_for_family(family: str) -> SpaceMask:
    if family == "ssm":
        return SpaceMask(attention_arms=False, kv_arms=False)
    return SpaceMask()


def enumerate_space(mask: SpaceMask = SpaceMask()) -> List[EfficiencyConfig]:
    attns = ATTENTION_KINDS if mask.attention_arms else ["gqa"]
    moes = MOE_EXPERTS if mask.moe_arms else [0]
    kvs = KV_STYLES if mask.kv_arms else ["full"]
    out = []
    for a, e, k in itertools.product(attns, moes, MOE_TOPK):
        if e == 0 and k != 1:
            continue
        if e > 0 and k > e:
            continue
        arch = ArchChoice(a, e, k)
        fts = [FtChoice("full", 0, 1)] + [
            FtChoice(m, r, am) for m, r, am in itertools.product(
                FT_METHODS[1:], FT_RANKS, FT_ALPHA_MULT)]
        for ft in fts:
            # spec rides the paged (attention) serving path — masked out
            # with the kv arms for families without one (ssm)
            specs = [("none", SPEC_DRAFT_KS[1])]
            if mask.kv_arms:
                specs += [(s, k) for s, k in itertools.product(
                    SPEC_ARMS[1:], SPEC_DRAFT_KS)]
            infs = [InfChoice("bf16", "gptq", kv, sp, dk)
                    for kv in kvs for sp, dk in specs] + [
                InfChoice(q, qm, kv, sp, dk)
                for q, qm, kv in itertools.product(
                    QUANTS[1:], QUANT_METHODS, kvs)
                for sp, dk in specs]
            for inf in infs:
                out.append(EfficiencyConfig(arch, ft, inf))
    return out


def space_size(mask: SpaceMask = SpaceMask()) -> int:
    # cheap closed form (matches enumerate_space)
    attns = len(ATTENTION_KINDS) if mask.attention_arms else 1
    moe = 1 + (len(MOE_EXPERTS) - 1) * len(MOE_TOPK) if mask.moe_arms else 1
    ft = 1 + (len(FT_METHODS) - 1) * len(FT_RANKS) * len(FT_ALPHA_MULT)
    kv = len(KV_STYLES) if mask.kv_arms else 1
    spec = 1 + (len(SPEC_ARMS) - 1) * len(SPEC_DRAFT_KS) \
        if mask.kv_arms else 1
    inf = kv * spec * (1 + (len(QUANTS) - 1) * len(QUANT_METHODS))
    return attns * moe * ft * inf


def sample_config(rng: np.random.Generator,
                  mask: SpaceMask = SpaceMask()) -> EfficiencyConfig:
    attns = ATTENTION_KINDS if mask.attention_arms else ["gqa"]
    kvs = KV_STYLES if mask.kv_arms else ["full"]
    e = int(rng.choice(MOE_EXPERTS if mask.moe_arms else [0]))
    arch = ArchChoice(str(rng.choice(attns)), e,
                      1 if e == 0 else int(rng.choice(MOE_TOPK)))
    m = str(rng.choice(FT_METHODS))
    ft = FtChoice(m, 0 if m == "full" else int(rng.choice(FT_RANKS)),
                  1 if m == "full" else int(rng.choice(FT_ALPHA_MULT)))
    q = str(rng.choice(QUANTS))
    sp = str(rng.choice(SPEC_ARMS)) if mask.kv_arms else "none"
    inf = InfChoice(q, str(rng.choice(QUANT_METHODS)), str(rng.choice(kvs)),
                    sp, SPEC_DRAFT_KS[1] if sp == "none"
                    else int(rng.choice(SPEC_DRAFT_KS)))
    return EfficiencyConfig(arch, ft, inf)


# ---------------------------------------------------------------------------
# Feature encoding for the surrogates: φ(config) ⊕ φ(M) ⊕ ψ(T)


def _onehot(val, options):
    v = [0.0] * len(options)
    v[options.index(val)] = 1.0
    return v


def encode_config(c: EfficiencyConfig) -> list:
    f = []
    f += _onehot(c.arch.attention, ATTENTION_KINDS)
    f += [float(c.arch.moe_experts), float(c.arch.moe_top_k)]
    f += _onehot(c.ft.method, FT_METHODS)
    f += [float(c.ft.rank), float(c.ft.alpha_mult)]
    f += _onehot(c.inf.quant, QUANTS)
    f += _onehot(c.inf.quant_method, QUANT_METHODS)
    f += _onehot(c.inf.kv_style, KV_STYLES)
    f += _onehot(c.inf.spec, SPEC_ARMS)
    f += [float(c.inf.draft_k) if c.inf.spec != "none" else 0.0]
    return f


FEATURE_DIM_CONFIG = len(encode_config(EfficiencyConfig()))
