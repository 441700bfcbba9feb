"""Port parity: layers, attention prefill / paged decode, and the whole
``LM`` (``prefill(lengths=)`` and ``decode_step`` against paged pools)
against ``repro.models`` on the smoke configs of qwen2-1.5b, llama3.2-1b
and stablelm-1.6b.  Both sides use the reference's ``LM.init`` pytree,
bridged to torch (both ``scan_layers`` layouts), and the same numpy
tokens.  float32: atol/rtol 1e-4.  bfloat16: 3e-2 on logits of magnitude
~0.3 — both sides round every activation to bf16, in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve.paged import PageAllocator as JAlloc  # noqa: E402
from repro.serve.paged import scatter_prefill_cache as j_scatter  # noqa: E402
from repro.serve.paged import set_block_table_rows as j_set_rows  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve.paged import (scatter_prefill_cache,  # noqa: E402
                                     set_block_table_rows)

torch.manual_seed(0)

ARCHS = ["qwen2-1.5b", "llama3.2-1b", "stablelm-1.6b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match(dtype):
    rng = np.random.default_rng(0)
    jd, td = jl.dtype_of(dtype), tl.dtype_of(dtype)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        _np(tl.rmsnorm_apply({"scale": torch.from_numpy(scale)}, tx)),
        _np(jl.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx)),
        atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(tl.layernorm_apply({"scale": torch.from_numpy(scale),
                                "bias": torch.from_numpy(bias)}, tx)),
        _np(jl.layernorm_apply({"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}, jx)),
        atol=tol, rtol=tol)
    # rope on (B, S, H, D) at ragged positions
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    np.testing.assert_allclose(
        _np(tl.apply_rope(torch.from_numpy(q).to(td), torch.from_numpy(pos),
                          1e6)),
        _np(jl.apply_rope(jnp.asarray(q, jd), jnp.asarray(pos), 1e6)),
        atol=tol, rtol=tol)
    # SwiGLU MLP and biased linear in (d_in, d_out) layout
    mlp = {n: {"w": rng.normal(size=s).astype(np.float32) * 0.2,
               "b": rng.normal(size=s[1:]).astype(np.float32) * 0.1}
           for n, s in (("gate", (32, 48)), ("up", (32, 48)),
                        ("down", (48, 32)))}
    jm = jax.tree.map(lambda a: jnp.asarray(a, jd), mlp)
    tm = {n: {k: torch.from_numpy(v).to(td) for k, v in p.items()}
          for n, p in mlp.items()}
    np.testing.assert_allclose(_np(tl.mlp_apply(tm, tx)),
                               _np(jl.mlp_apply(jm, jx)), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# LM


def _pair(arch, dtype, scan_layers, use_kernels=False):
    jcfg = jconfigs.get_smoke_config(arch).with_(
        dtype=dtype, scan_layers=scan_layers, use_kernels=use_kernels)
    tcfg = tconfigs.get_smoke_config(arch).with_(dtype=dtype,
                                                 use_kernels=use_kernels)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = TLM(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jlm, jparams, tlm, tparams


def _staging_nodes_jax(cache, cfg):
    """Per-layer {k, v} nodes of a JAX contiguous cache (either layout)."""
    if "g0" in cache:
        return [cache[f"g{i}"]["blk0"]["kv"] for i in range(cfg.num_groups)]
    kv = cache["blk0"]["kv"]
    return [{n: kv[n][i] for n in kv} for i in range(cfg.num_groups)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan_layers", [True, False])
def test_lm_prefill_and_paged_decode_match(arch, dtype, scan_layers):
    jlm, jparams, tlm, tparams = _pair(arch, dtype, scan_layers)
    cfg = tlm.cfg
    rng = np.random.default_rng(0)
    plens = np.asarray([13, 6, 16], np.int32)
    tokens = np.zeros((3, 16), np.int32)
    for i, n in enumerate(plens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, (n,))
    tol = TOL[dtype]

    jcache = jlm.init_cache(3, 16, kv_dtype="bfloat16")
    jlog, jcache = jlm.prefill(jparams, jnp.asarray(tokens), jcache,
                               lengths=jnp.asarray(plens))
    tcache = tlm.init_cache(3, 16, kv_dtype="bfloat16")
    tlog, tcache = tlm.prefill(tparams, torch.from_numpy(tokens).long(),
                               tcache, lengths=torch.from_numpy(plens))
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=tol, rtol=tol)
    # the bf16 staging caches agree too (K after rope, V)
    for jn, tg in zip(_staging_nodes_jax(jcache, jlm.cfg), tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tg["blk0"]["kv"][name]),
                                       _np(jn[name]), atol=2e-2, rtol=2e-2)

    # scatter into paged pools (slots 2, 0, 3 of 4; page 8) and decode
    n_slots, page, max_len = 4, 8, 32
    pps = max_len // page
    alloc = JAlloc(n_slots * pps + 1, pps, n_slots)
    slot_ids = np.asarray([2, 0, 3], np.int32)
    for s, n in zip(slot_ids, plens):
        alloc.alloc(int(s), alloc.pages_needed(int(n) + 4, page))
    jp = jlm.init_paged_cache(n_slots, n_slots * pps + 1, pps,
                              page_size=page)
    jp = j_set_rows(jp, slot_ids, alloc.table[slot_ids])
    jp = j_scatter(jp, jcache, jnp.asarray(slot_ids), jnp.asarray(plens))
    tp = tlm.init_paged_cache(n_slots, n_slots * pps + 1, pps,
                              page_size=page)
    set_block_table_rows(tp, slot_ids, alloc.table[slot_ids])
    scatter_prefill_cache(tp, tcache, torch.from_numpy(slot_ids).long(),
                          torch.from_numpy(plens))
    lengths = np.zeros((n_slots,), np.int32)
    lengths[slot_ids] = plens
    tok = np.asarray(rng.integers(0, cfg.vocab_size, (n_slots,)), np.int32)
    for _ in range(2):
        jl_, jp = jlm.decode_step(jparams, jnp.asarray(tok), jp,
                                  jnp.asarray(lengths))
        tl_, tp = tlm.decode_step(tparams, torch.from_numpy(tok), tp,
                                  torch.from_numpy(lengths))
        live = slot_ids                      # slot 1 is free: garbage
        np.testing.assert_allclose(_np(tl_)[live], _np(jl_)[live], atol=tol,
                                   rtol=tol)
        tok = np.array(jnp.argmax(jl_, -1), np.int32)
        lengths[slot_ids] += 1


def test_lm_prefill_with_flash_kernel_path_matches():
    """``use_kernels`` routes prefill attention through the flash op on
    both sides (JAX: the Pallas kernel in interpret mode; port on the
    CPU: its plain version)."""
    jlm, jparams, tlm, tparams = _pair("qwen2-1.5b", "float32", True,
                                       use_kernels=True)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    plens = np.asarray([16, 9], np.int32)
    jlog, _ = jlm.prefill(jparams, jnp.asarray(tokens),
                          jlm.init_cache(2, 16, kv_dtype="bfloat16"),
                          lengths=jnp.asarray(plens))
    tlog, _ = tlm.prefill(tparams, torch.from_numpy(tokens).long(),
                          tlm.init_cache(2, 16, kv_dtype="bfloat16"),
                          lengths=torch.from_numpy(plens))
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)


def test_vocab_padding_and_prepared_head():
    """Padded vocab columns are masked to -1e30 and the once-made fp32
    head (``LM.prepare``) gives the same logits as the on-the-fly one."""
    cfg = tconfigs.get_smoke_config("stablelm-1.6b").with_(
        dtype="float32", vocab_pad_multiple=96)
    lm = TLM(cfg, device="cpu")
    params = lm.init(0)
    assert params["lm_head"]["w"].shape == (cfg.d_model, cfg.padded_vocab)
    toks = torch.arange(6)[None]
    a = lm.logits(params, toks)
    b = lm.logits(lm.prepare(params), toks)
    assert torch.equal(a, b)
    assert (a[..., cfg.vocab_size:] == -1e30).all()


def test_bridge_bf16_crosses_bit_for_bit():
    x = jnp.asarray(np.random.default_rng(4).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
