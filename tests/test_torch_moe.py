"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe`` on
the same numpy inputs and the reference's ``init_moe`` weights.

* ``moe_apply`` (einsum dispatch) and ``moe_apply_gather`` (sort /
  scatter) for both ``train`` values, group sizes 8 / 32 / 64 over 50
  tokens in float32 and 32 in bf16 (groups that split and pad the
  tokens), 5 experts padded to 8
  (``expert_pad_multiple`` 4), a shared expert, and capacity factors
  low enough to drop (0.5 in training, 0.75 in eval).  Outputs within
  1e-5 in float32 and 2e-2 relative L2 in bf16, ``moe_dropped_frac``
  exactly equal, the losses within 1e-6 relative; the gather dispatch's
  combine order bit for bit in bf16 at top-3 and top-4.
* ``_capacity`` against the reference's on serving shapes.
* ``quantize_tree`` on a MoE layer: the shared expert's linears are
  quantized bit for bit as JAX's, the expert stacks and the router are
  not targets.
* A config with a MoE layer on every second block (``moe_every`` 2):
  the blocks' kinds and the ``LM`` logits against JAX's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.models.transformer import block_kinds  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402

torch.manual_seed(0)

MOE = dict(num_experts=5, top_k=2, d_ff=16, expert_pad_multiple=4,
           capacity_factor=0.5, eval_capacity_factor=0.75,
           num_shared_experts=1, shared_d_ff=24)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(tree):
    return jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a)), tree)


_weights = {}


def _moe(dtype):
    if dtype not in _weights:
        _weights[dtype] = jmoe.init_moe(jax.random.PRNGKey(0), 32,
                                        JMoE(**MOE), dtype=DTYPES[dtype][0])
    return _weights[dtype]


#: (dtype, group size): float32 at every group size, bf16 at one
APPLY_CASES = [("float32", gs) for gs in (8, 32, 64)] + [("bfloat16", 32)]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("dtype,group_size", APPLY_CASES)
def test_moe_apply_matches_jax(dtype, group_size, impl, train):
    jp = _moe(dtype)
    x = np.random.default_rng(1).standard_normal((2, 25, 32)).astype(
        np.float32)
    jx = jnp.asarray(x, DTYPES[dtype][0])
    jo, jaux = jmoe.moe_apply(jp, jx, JMoE(**MOE), train=train,
                              group_size=group_size, impl=impl)
    to, taux = tmoe.moe_apply(_to_torch(jp), tensor_from_numpy(
        np.asarray(jx)), TMoE(**MOE), train=train, group_size=group_size,
        impl=impl)
    assert to.dtype == DTYPES[dtype][1] and tuple(to.shape) == (2, 25, 32)
    jo, to = np.asarray(jo, np.float32), to.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)
    else:
        assert np.linalg.norm(to - jo) <= 2e-2 * np.linalg.norm(jo)
    dropped = float(taux["moe_dropped_frac"])
    assert dropped == float(jaux["moe_dropped_frac"])
    assert dropped > 0.1                       # the capacity drops tokens
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("tokens,train", [(8, False), (512, False),
                                          (4, True), (50, True)])
@pytest.mark.parametrize("moe", [
    dict(num_experts=40, top_k=8, d_ff=512),              # granite
    dict(num_experts=16, top_k=1, d_ff=8192),             # llama4
    dict(num_experts=5, top_k=2, d_ff=16, capacity_factor=0.3,
         eval_capacity_factor=0.75)])
def test_capacity_matches_jax(moe, tokens, train):
    assert tmoe._capacity(tokens, TMoE(**moe), train) == \
        jmoe._capacity(tokens, JMoE(**moe), train)


def test_decode_capacity_of_the_served_configs():
    """At 8 decode slots llama4-scout keeps one token per expert (two
    slots on one expert drop the later one's routed output) and granite
    eight; prefill groups of 512 give granite 205."""
    scout = TMoE(num_experts=16, top_k=1, d_ff=8192)
    granite = TMoE(num_experts=40, top_k=8, d_ff=512)
    assert tmoe._capacity(8, scout, False) == 1
    assert tmoe._capacity(8, granite, False) == 8
    assert tmoe._capacity(512, granite, False) == 205


@pytest.mark.parametrize("quant", ["int8", "int4", "fp8"])
def test_quantize_tree_moe_targets_match_jax(quant):
    """llama4's smoke MoE layers: ``shared/{gate,up,down}`` quantized
    bit for bit as JAX's (stacked on its side, per group here); router
    and expert stacks left as they are."""
    jcfg = j_smoke("llama4-scout-17b-a16e").with_(dtype="float32")
    tcfg = t_smoke("llama4-scout-17b-a16e").with_(dtype="float32")
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    jq = jax.tree.map(np.asarray, j_quantize_tree(jp, quant=quant))
    tq = quantize_tree(params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu"), quant=quant)
    for gi, group in enumerate(tq["layers"]):
        moe = group["blk0"]["moe"]
        jm = jq["layers"]["blk0"]["moe"]
        for name in ("gate", "up", "down"):
            lin = moe["shared"][name]
            assert set(lin) == {"qw", "scale"}
            for k in ("qw", "scale"):
                ref = tensor_from_numpy(jm["shared"][name][k][gi])
                assert lin[k].dtype == ref.dtype
                assert torch.equal(lin[k].view(torch.uint8)
                                   if lin[k].element_size() == 1
                                   else lin[k], ref.view(torch.uint8)
                                   if ref.element_size() == 1 else ref)
        assert set(moe["router"]) == {"w"}
        assert moe["router"]["w"].dtype == torch.float32
        for name in ("gate_e", "up_e", "down_e"):
            assert torch.equal(moe[name], tensor_from_numpy(jm[name][gi]))


def test_moe_every_second_block_matches_jax():
    """Blocks 0 and 2 of a four-block group MoE, 1 and 3 dense, in
    float32: the kinds, the parameter layout and the logits."""
    over = dict(dtype="float32", num_layers=4,
                block_pattern=("attn",) * 4, moe_every=2)
    jcfg = j_smoke("granite-moe-3b-a800m").with_(**over)
    tcfg = t_smoke("granite-moe-3b-a800m").with_(**over)
    assert [b["moe"] for b in block_kinds(tcfg)] == [True, False, True,
                                                     False]
    jlm = JLM(jcfg)
    jp = jlm.init(jax.random.PRNGKey(2))
    tlm = TLM(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert [("moe" in tp["layers"][0][f"blk{i}"]) for i in range(4)] == \
        [True, False, True, False]
    toks = np.random.default_rng(5).integers(0, 512, (2, 12))
    np.testing.assert_allclose(
        tlm.logits(tp, torch.from_numpy(toks)).numpy(),
        np.asarray(jlm.logits(jp, jnp.asarray(toks, jnp.int32))),
        atol=1e-4, rtol=1e-4)


def test_unknown_moe_impl_raises():
    p = _to_torch(_moe("float32"))
    with pytest.raises(ValueError, match="MoE impl"):
        tmoe.moe_apply(p, torch.zeros((1, 4, 32)), TMoE(**MOE),
                       impl="dense")


@pytest.mark.parametrize("top_k", [3, 4])
def test_gather_combine_order_is_the_references(top_k):
    """bf16, top-3 / top-4 of 5 experts (with two terms, either order
    rounds alike): the gather dispatch's output equals JAX's bit for bit,
    a token's contributions summed in ascending expert order with a bf16
    rounding after each add, as the reference's scatter-add does on the
    CPU."""
    moe = {**MOE, "top_k": top_k}
    jp = jmoe.init_moe(jax.random.PRNGKey(3), 32, JMoE(**moe),
                       dtype=jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((2, 20, 32)),
                    jnp.bfloat16)
    jo, _ = jmoe.moe_apply(jp, x, JMoE(**moe), train=False, group_size=16,
                           impl="gather")
    to, _ = tmoe.moe_apply(_to_torch(jp), tensor_from_numpy(np.asarray(x)),
                           TMoE(**moe), train=False, group_size=16,
                           impl="gather")
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo, np.float32))


def test_gather_sums_in_a_fixed_order():
    """Two calls of the gather dispatch are bit-equal (no atomic
    scatter-add in its combine), and its ties go to the lower expert as
    ``jax.lax.top_k``'s do."""
    p = _to_torch(_moe("bfloat16"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 40, 32)).astype(np.float32)).to(torch.bfloat16)
    a, _ = tmoe.moe_apply_gather(p, x, TMoE(**MOE), train=False)
    b, _ = tmoe.moe_apply_gather(p, x, TMoE(**MOE), train=False)
    assert torch.equal(a, b)
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]])
    vals, idx = tmoe._top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1, 3]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_dataclass_fields_match_the_reference():
    """The port's MoE config and its two serving knobs carry the
    reference's defaults."""
    assert dataclasses.asdict(TMoE()) == dataclasses.asdict(JMoE())
    t, j = t_smoke("granite-moe-3b-a800m"), j_smoke("granite-moe-3b-a800m")
    assert (t.moe_group_size, t.moe_impl) == (j.moe_group_size, j.moe_impl)


def test_profile_families_split_a_moe_forward():
    """``profile_serve``'s split of device time: the port's attention and
    RMSNorm kernels, cuBLAS / the quantized kernels as matrix products,
    and the rest (the router's top-k loop, elementwise work)."""
    from repro_torch.launch.profile_serve import families
    kernels = {"void repro::tc_step::paged_decode_tc<bf16>": 2.0,
               "repro::flash_fwd_tc": 1.0, "repro::rmsnorm_warp": 0.5,
               "nvjet_tst_256x8_64x6_2x1_v_bz_NNT": 4.0,
               "sm90_xmma_gemm_bf16bf16": 1.5, "w8a8_decode_tc": 0.25,
               "at::native::reduce_kernel ArgMaxOps": 0.75}
    split = families(kernels, sum(kernels.values()) + 1.0)
    assert split == {"attention_ms": 3.0, "rmsnorm_ms": 0.5,
                     "matmul_ms": 5.75, "other_ms": 1.75}
