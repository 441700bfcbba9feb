"""Port parity: the whole ``LM`` of the MoE configs (granite-moe-3b-a800m,
llama4-scout-17b-a16e, mixtral-8x7b narrowed to smoke width) and of
deepseek-coder-33b against ``repro.models``.  Both sides use the
reference's ``LM.init`` pytree bridged to torch and the same numpy
tokens.  Held: the logits of ``prefill(lengths=)``, the contiguous
``decode_step``, ``prefill_paged`` and ``verify_paged`` (the paged two
where the config has no window), at the configs' own capacity and with
capacity forced down to 0.5 so that tokens drop (float32); float32 to
1e-4, bfloat16 to 2e-2 relative L2 per row (see ``_Close``).  Also, on the port alone, decode against
full-context logits with eval made dropless, as ``test_archs.py`` does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402

torch.manual_seed(0)

ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e", "mixtral-8x7b",
         "deepseek-coder-33b"]


def _smoke(configs, base, arch):
    """The arch's smoke config; mixtral (a paper model, with no smoke
    config) narrowed the same way on both sides."""
    if arch != "mixtral-8x7b":
        return configs.get_smoke_config(arch)
    return configs.get_config(arch).with_(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=base.AttentionConfig(kind="gqa", num_heads=4,
                                       num_kv_heads=2, head_dim=16,
                                       rope_theta=1_000_000.0),
        moe=base.MoEConfig(num_experts=8, top_k=2, d_ff=64))


def _cfg(configs, base, arch, dtype, drop):
    cfg = _smoke(configs, base, arch).with_(dtype=dtype)
    if drop and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                eval_capacity_factor=0.5))
    return cfg


_pairs = {}


def _pair(arch, dtype, drop=False):
    key = (arch, dtype, drop)
    if key not in _pairs:
        jcfg = _cfg(jconfigs, jbase, arch, dtype, drop)
        tcfg = _cfg(tconfigs, tbase, arch, dtype, drop)
        jlm = JLM(jcfg)
        jp = jlm.init(jax.random.PRNGKey(0))
        tlm = TLM(tcfg, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
        _pairs[key] = (jlm, jp, tlm, tp)
    return _pairs[key]


class _Close:
    """float32: every logit to 1e-4.  bfloat16: relative L2 per row of
    logits, to 2e-2 in all rows but one in ten (or one), median 1e-2: a
    bf16 ulp in a router input (the two sides round attention in
    different orders) can flip a near-tied top-k choice, which moves
    that token's row by more than the bar; it is counted, not hidden."""

    def __init__(self, dtype):
        self.dtype, self.rows = dtype, []

    def __call__(self, t, j):
        t = t.float().numpy() if isinstance(t, torch.Tensor) else t
        j = np.asarray(j, np.float32)
        if self.dtype == "float32":
            np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4)
            return
        t, j = t.reshape(-1, t.shape[-1]), j.reshape(-1, j.shape[-1])
        self.rows += list(np.linalg.norm(t - j, axis=-1)
                          / np.linalg.norm(j, axis=-1))

    def done(self):
        if self.dtype == "float32":
            return
        rows = np.asarray(self.rows)
        assert np.sum(rows > 2e-2) <= max(1, len(rows) // 10), rows
        assert np.median(rows) <= 1e-2, rows


def test_moe_blocks_and_router_dtype():
    """Every block of granite / llama4 is MoE (moe_every 1); the router
    stays fp32 in a bf16 model, through the bridge and ``LM.init``."""
    jlm, jp, tlm, tp = _pair("llama4-scout-17b-a16e", "bfloat16")
    for params in (tp, tlm.init(0)):
        blk = params["layers"][0]["blk0"]
        assert "mlp" not in blk and set(blk["moe"]) == {
            "router", "gate_e", "up_e", "down_e", "shared"}
        assert blk["moe"]["router"]["w"].dtype == torch.float32
        assert blk["moe"]["gate_e"].dtype == torch.bfloat16
        assert tuple(blk["moe"]["gate_e"].shape) == (4, 64, 128)
        assert tuple(blk["moe"]["down_e"].shape) == (4, 128, 64)


#: (arch, dtype, forced drops): drops are forced in float32, where a
#: routing choice cannot flip on rounding (a flip in bf16 would move the
#: capacity slots of every later token of its group); the dense deepseek
#: has no capacity to force; the paged paths run in float32 (their bf16
#: attention is held in test_torch_model.py / test_torch_spec.py)
CASES = [(a, dt, drop) for a in ARCHS for dt in ("float32", "bfloat16")
         for drop in (False, True)
         if not (drop and (dt == "bfloat16" or a == "deepseek-coder-33b"))]
PAGED_CASES = [c for c in CASES if c[0] != "llama4-scout-17b-a16e"
               and c[1] == "float32"]


@pytest.mark.parametrize("arch,dtype,drop", CASES)
def test_lm_prefill_and_contiguous_decode_match(arch, dtype, drop):
    """Ragged batched prefill (lengths 13, 6, 16 right-padded to 16),
    then two decode steps at per-row positions over the contiguous
    cache; llama4's prompts cross its window of 32 on the decode side."""
    jlm, jp, tlm, tp = _pair(arch, dtype, drop)
    close = _Close(dtype)
    rng = np.random.default_rng(0)
    v = tlm.cfg.vocab_size
    plens = np.asarray([13, 6, 16], np.int32)
    tokens = np.zeros((3, 16), np.int32)
    for i, n in enumerate(plens):
        tokens[i, :n] = rng.integers(0, v, (n,))
    jc = jlm.init_cache(3, 48)
    jl, jc = jlm.prefill(jp, jnp.asarray(tokens), jc,
                         lengths=jnp.asarray(plens))
    tc = tlm.init_cache(3, 48)
    tl, tc = tlm.prefill(tp, torch.from_numpy(tokens).long(), tc,
                         lengths=torch.from_numpy(plens))
    close(tl, jl)
    pos = plens.copy()
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(2):
        jl, jc = jlm.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = tlm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                                 torch.from_numpy(pos))
        close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos += 1
    close.done()


def _paged(jlm, tlm, n_slots=3, page=8, pps=4):
    table = np.arange(1, 1 + n_slots * pps).reshape(n_slots, pps).astype(
        np.int32)
    n = 1 + n_slots * pps
    jc = jlm.init_paged_cache(n_slots, n, pps, page_size=page)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(jnp.asarray(table), x.shape)
                      if x.dtype == jnp.int32 else x, jc)
    tc = tlm.init_paged_cache(n_slots, n, pps, page_size=page)
    tc[0]["blk0"]["kv"]["block_table"].copy_(torch.from_numpy(table))
    return jc, tc


@pytest.mark.parametrize("arch,dtype,drop", PAGED_CASES)
def test_lm_prefill_paged_and_verify_paged_match(arch, dtype, drop):
    """Two chunks of ``prefill_paged`` (the second over the first's
    pages), then one ``verify_paged`` of widths 5 / 3 / 1 over them."""
    jlm, jp, tlm, tp = _pair(arch, dtype, drop)
    close = _Close(dtype)
    jc, tc = _paged(jlm, tlm)
    rng = np.random.default_rng(1)
    v = tlm.cfg.vocab_size
    slots = np.arange(3, dtype=np.int32)
    starts = np.zeros(3, np.int32)
    for lens in (np.asarray([8, 5, 8], np.int32),
                 np.asarray([6, 0, 8], np.int32)):
        toks = rng.integers(0, v, (3, 8)).astype(np.int32)
        args = (slots, starts, lens)
        jl, jc = jlm.prefill_paged(jp, jnp.asarray(toks), jc,
                                   *[jnp.asarray(a) for a in args])
        tl, tc = tlm.prefill_paged(tp, torch.from_numpy(toks).long(), tc,
                                   *[torch.from_numpy(a) for a in args])
        live = lens > 0
        close(tl[torch.from_numpy(live)], np.asarray(jl)[live])
        starts = starts + lens
    widths = np.asarray([5, 3, 1], np.int32)
    fed = rng.integers(0, v, (3, 5)).astype(np.int32)
    jl, _ = jlm.verify_paged(jp, jnp.asarray(fed), jc,
                             jlm.init_cache(3, 5, kv_dtype="bfloat16"),
                             jnp.asarray(starts), jnp.asarray(widths))
    tl, _ = tlm.verify_paged(tp, torch.from_numpy(fed).long(), tc,
                             tlm.init_cache(3, 5, kv_dtype="bfloat16"),
                             torch.from_numpy(starts),
                             torch.from_numpy(widths))
    for s, w in enumerate(widths):
        close(tl[s, :w], np.asarray(jl)[s, :w])
    close.done()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e", "mixtral-8x7b"])
def test_decode_matches_prefill_when_dropless(arch):
    """Teacher-forced decode logits equal full-context logits once eval
    is dropless (capacity E), to ``test_archs.py``'s 2e-2 (decode reads
    the bf16 cache): capacity groups differ between the two, so with
    drops they would not agree."""
    cfg = _smoke(tconfigs, tbase, arch).with_(dtype="float32")
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, eval_capacity_factor=float(cfg.moe.num_experts)))
    lm = TLM(cfg, device="cpu")
    params = lm.init(1)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 16)))
    full = lm.logits(params, toks)
    cache = lm.init_cache(1, 32)
    logits, cache = lm.prefill(params, toks[:, :8], cache)
    np.testing.assert_allclose(logits.numpy(), full[:, 7].numpy(),
                               atol=2e-2, rtol=2e-2)
    for i in range(8, 16):
        logits, cache = lm.decode_step(params, toks[:, i], cache,
                                       torch.tensor([i]))
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                   atol=2e-2, rtol=2e-2)
