"""Port parity of calibration (``quant/calibrate.py``) and of the trees
``quantize_tree(calib=)`` / ``apply_to_params(calib=)`` build, against
``repro.quant.calibrate`` on the same numpy inputs.

* ``_rtn`` bit-equal; ``hessian_from_inputs`` equal; GPTQ to 1e-12
  (float64 on both sides, blocks smaller than K so the error crosses
  blocks); SmoothQuant to 1e-6; AWQ picks the reference's grid point.
* ``collect_linear_inputs`` on the smoke qwen2 (``scan_layers=False``):
  R8, the reference captures only the MLP's ``gate`` (its hook misses the
  ``wq`` that ``attention.py`` imported by name); the port captures
  ``wq`` and ``gate`` of every group, and the shared keys hold the same
  activations.
* Calibrated int8 trees bit-equal to the reference's (the fold is the
  same for every weight arm; ``test_torch_quant`` holds the int4 / fp8
  quantizers), and ``apply_to_params(calib=)`` gives
  ``quantize_tree(calib=)``'s; R9: a calibrated linear computes
  x·Q(diag(s)·W), not x·W.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import one_intraop_thread  # noqa: E402,F401
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant import calibrate as jcal  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import apply as tapply  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.models.layers import linear_apply  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.quant import calibrate as tcal  # noqa: E402
from repro_torch.quant import quantize_tree as t_quantize  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402


pytestmark = pytest.mark.usefixtures("one_intraop_thread")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _mats(k=48, n=24, rows=40, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
    x = rng.normal(0, 1.0, (rows, k)).astype(np.float32)
    x[:, 3] *= 20.0                             # an outlier channel
    return w, x


@pytest.mark.parametrize("bits", [4, 8])
def test_rtn_gptq_hessian_match_jax(bits):
    w, x = _mats()
    jq, js = jcal._rtn(jnp.asarray(w), bits)
    tq, ts = tcal._rtn(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    h = jcal.hessian_from_inputs(x)
    np.testing.assert_array_equal(tcal.hessian_from_inputs(
        torch.from_numpy(x)), h)
    h[5, :] = h[:, 5] = 0.0                     # a dead input channel
    jw, jsc = jcal.gptq_quantize_matrix(w, h, bits=bits, block=16)
    tw, tsc = tcal.gptq_quantize_matrix(torch.from_numpy(w), h, bits=bits,
                                        block=16)
    np.testing.assert_allclose(tw, jw, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-12, atol=1e-12)
    assert not tw[5].any()


def test_smoothquant_and_awq_match_jax():
    w, x = _mats()
    amax = np.abs(x).max(axis=0)
    for alpha in (0.5, 0.8):
        np.testing.assert_allclose(
            tcal.smoothquant_scales(torch.from_numpy(amax),
                                    torch.from_numpy(w), alpha).numpy(),
            np.asarray(jcal.smoothquant_scales(jnp.asarray(amax),
                                               jnp.asarray(w), alpha)),
            rtol=1e-6)
    for bits in (4, 8):
        js = np.asarray(jcal.awq_search_scales(jnp.asarray(w),
                                               jnp.asarray(x), bits=bits))
        ts = tcal.awq_search_scales(torch.from_numpy(w), torch.from_numpy(x),
                                    bits=bits).numpy()
        np.testing.assert_allclose(ts, js, rtol=1e-5)
        # a grid point past 0: the search moved off the identity
        assert not np.allclose(js, 1.0)


def _qwen_pair():
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32", scan_layers=False)
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32", scan_layers=False)
    jlm, tlm = JLM(jcfg), TLM(tcfg, device="cpu")
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jlm, tlm, jp, tp


def test_collect_linear_inputs_r8_and_calibrated_trees_r9():
    """R8, then SmoothQuant scales over the port's captures folded into
    an int8 tree (and ``apply_to_params(calib=)``) bit-equal
    to the reference's; R9 on one calibrated linear."""
    jlm, tlm, jp, tp = _qwen_pair()
    toks = np.random.default_rng(1).integers(0, jlm.cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    jcap = jcal.collect_linear_inputs(jlm, jp, jnp.asarray(toks))
    tcap = tcal.collect_linear_inputs(tlm, tp, torch.from_numpy(toks).long())
    n = jlm.cfg.num_groups
    assert set(jcap) == {f"/layers/g{i}/blk0/mlp/gate" for i in range(n)}
    assert set(tcap) == set(jcap) | {f"/layers/g{i}/blk0/attn/wq"
                                     for i in range(n)}
    for k in jcap:
        np.testing.assert_allclose(_np(tcap[k]), jcap[k], rtol=1e-5,
                                   atol=1e-6)
    assert tuple(tcap["/layers/g0/blk0/attn/wq"].shape) == (24, 64)
    calib = {}
    for path, acts in tcap.items():
        g, rest = path.split("/")[2], path.split("/")[3:]
        node = tp["layers"][int(g[1:])]
        for key in rest:
            node = node[key]
        calib[path] = tcal.smoothquant_scales(acts.abs().amax(dim=0),
                                              node["w"]).numpy()
    jcalib = {k: jnp.asarray(v) for k, v in calib.items()}
    for quant in ("int8",):
        got = params_to_numpy(t_quantize(tp, quant=quant, calib=calib),
                              tlm.cfg)
        want = jax.tree.map(np.asarray, j_quantize(jp, quant=quant,
                                                   calib=jcalib))
        for (pt, a), (pj, b) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            assert jax.tree_util.keystr(pt) == jax.tree_util.keystr(pj)
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32),
                                          err_msg=jax.tree_util.keystr(pt))
    eff = tspace.EfficiencyConfig(tspace.ArchChoice("gqa", 0, 1),
                                  tspace.FtChoice("full", 0, 1),
                                  tspace.InfChoice("int8", "smoothquant",
                                                   "full"))
    # apply_to_params(calib=) hands its scales to quantize_tree, as the
    # reference's does (whose trees the loop above holds bit for bit)
    got = tapply.apply_to_params(tp, eff, 0, calib=calib)
    want = t_quantize(tp, quant="int8", calib=calib)
    for (pa, a), (pb, b) in zip(leaves_with_path(got),
                                leaves_with_path(want)):
        assert pa == pb and torch.equal(a, b), pa
    # R9: the fold multiplies W by s and nothing divides x by it
    dense = tp["layers"][0]["blk0"]["mlp"]["gate"]
    x = tcap["/layers/g0/blk0/mlp/gate"]
    s = np.full((x.shape[1],), 2.0, np.float32)
    scaled = t_quantize({"gate": dense}, quant="int8",
                        calib={"/gate": s})["gate"]
    plain = t_quantize({"gate": dense}, quant="int8")["gate"]
    y, ys, yp = (linear_apply(dense, x), linear_apply(scaled, x),
                 linear_apply(plain, x))
    assert torch.allclose(ys, 2.0 * yp, rtol=1e-2, atol=1e-4)
    assert (ys - y).norm() > 0.5 * y.norm()
