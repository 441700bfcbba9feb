"""Port parity of PEFT (``repro_torch.peft.lora`` and the PEFT half of
``core/apply.py``): for lora, qlora (int4 base), dora and rslora on the
llama3.2-1b smoke config, the adapter trees (structure, shapes, dtypes,
zero ``b``, ``scaling``, DoRA's column norms, the int4 base), the
trainable mask and counts against the reference's ``apply_to_params``;
``merge_lora``; and serving logits with the adapters unmerged.

The reference draws ``a`` from ``jax.random``, which torch cannot
reproduce: ``a`` is held by its shape and its std (0.01); the value
checks bridge the reference's own adapters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import flat, pair, rel_l2, to_torch  # noqa: E402
from repro.core import apply as japply  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.core import apply as tapply  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.peft import lora as tlora  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

METHODS = ["lora", "qlora", "dora", "rslora"]


def _effs(method, rank=8, mult=2):
    return (jspace.EfficiencyConfig(jspace.ArchChoice(),
                                    jspace.FtChoice(method, rank, mult),
                                    jspace.InfChoice()),
            tspace.EfficiencyConfig(tspace.ArchChoice(),
                                    tspace.FtChoice(method, rank, mult),
                                    tspace.InfChoice()))


def _with_b(jtree, scale=0.05, seed=5):
    """The reference tree with every adapter ``b`` drawn non-zero (an
    untrained adapter changes nothing)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = [getattr(k, "key", None) for k in path]
        if "lora" in keys and keys[-1] == "b":
            return jnp.asarray(rng.normal(size=a.shape) * scale, a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, jtree)


def _mask_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_mask_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        return _mask_flat(tree[0], prefix)      # groups share one mask
    return {prefix: bool(tree)}


@pytest.mark.parametrize("method", METHODS)
def test_peft_trees_match_jax(method):
    jlm, tlm, jp, tp = pair("llama3.2-1b")
    jeff, teff = _effs(method)
    jq = japply.apply_to_params(jp, jeff, jax.random.PRNGKey(1))
    tq = tapply.apply_to_params(tp, teff, 1)
    got, want = flat(params_to_numpy(tq, tlm.cfg)), flat(jq)
    assert got.keys() == want.keys()
    a_vals = []
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k.endswith("/lora/a"):
            a_vals.append(got[k].ravel())
        elif "/lora/" in k:              # b (zeros), scaling, DoRA's m
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:                            # the base, int4 bit for bit
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert any(k.endswith("/lora/m") for k in want) == (method == "dora")
    assert any(k.endswith("/qw") for k in want) == (method == "qlora")
    std = float(np.concatenate(a_vals).std())
    assert abs(std - 0.01) < 5e-4, std
    jmask = jlora.trainable_mask(jq, jeff.ft.method)
    tmask = tlora.trainable_mask(tq, teff.ft.method)
    assert _mask_flat(tmask) == {k: v for k, v in _mask_flat(jmask).items()}
    assert tlora.count_trainable(tq, tmask) == \
        jlora.count_trainable(jq, jmask)


def test_peft_full_and_the_calib_refusal():
    """"full" keeps the tree as it is and trains every leaf; ``calib=``
    (AWQ / SmoothQuant scales; it raised, naming A7, before
    ``quant/calibrate.py`` was ported) leaves a bf16 tree as it is, as in
    the reference: there is no quantization to fold them into."""
    _, _, _, tp = pair("llama3.2-1b")
    _, teff = _effs("full", 0, 1)
    assert tapply.apply_to_params(tp, teff, 1) is tp
    mask = tlora.trainable_mask(tp, "full")
    n, total = tlora.count_trainable(tp, mask)
    assert n == total == sum(t.numel() for _, t in leaves_with_path(tp))
    assert tapply.apply_to_params(tp, teff, 1, calib={"/x": None}) is tp


@pytest.mark.parametrize("method", ["lora", "dora"])
def test_merge_lora_matches_jax(method):
    """Folding the bridged adapters (``b`` non-zero) into the weights."""
    jlm, tlm, jp, _ = pair("llama3.2-1b")
    jeff, _ = _effs(method)
    jq = _with_b(japply.apply_to_params(jp, jeff, jax.random.PRNGKey(1)))
    tq = to_torch(jq, tlm.cfg)
    got = flat(params_to_numpy(tlora.merge_lora(tq), tlm.cfg))
    want = flat(jlora.merge_lora(jq))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("method", METHODS)
def test_serving_logits_with_unmerged_adapters_match_jax(method):
    """``linear_apply`` adds the adapter's update in serving forwards:
    logits of the bridged tree (``b`` non-zero) equal the reference's,
    and for a dense base the merged tree's logits equal the unmerged."""
    jlm, tlm, jp, _ = pair("llama3.2-1b")
    jeff, _ = _effs(method)
    jq = _with_b(japply.apply_to_params(jp, jeff, jax.random.PRNGKey(1)))
    tq = to_torch(jq, tlm.cfg)
    toks = np.random.default_rng(0).integers(0, 512, (2, 24))
    want = np.asarray(jlm.logits(jq, jnp.asarray(toks)))
    got = tlm.logits(tq, torch.from_numpy(toks)).numpy()
    assert rel_l2(got, want) <= 1e-5
    base = tlm.logits(to_torch(jp, tlm.cfg), torch.from_numpy(toks)).numpy()
    assert rel_l2(got, base) > 1e-3            # the adapters do act
    if method != "qlora":
        merged = tlm.logits(tlora.merge_lora(tq),
                            torch.from_numpy(toks)).numpy()
        assert rel_l2(merged, got) <= 1e-5
