"""The dry-run of the port (``launch/steps.py``, ``launch/roofline.py``,
``launch/dryrun.py``, ``configs/specs.py``) held to the reference's on
the CPU.

* Placements: the port's ``param_shardings`` / ``cache_shardings`` /
  ``batch_shardings`` equal the reference's specs leaf by leaf on its
  production meshes (16 x 16, 2 x 16 x 16; the reference's over a
  ``jax.sharding.AbstractMesh``, the port's over ``abstract_mesh``), the
  reference's stacked group dim mapped onto each group of the port's
  list.
* The reference's pure functions (``auto_fsdp``, ``cell_supported``,
  ``model_flops_for``, ``analytic_hbm_bytes``, ``extrapolate_terms``)
  over every arch and shape.
* FLOP counts of a traced cell against a hand count, and the
  reference's two-group extrapolation against a full-depth trace.
* One step of the train cell against the reference's ``build_cell``
  step function run eagerly, and the CLI."""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from _train_pairs import (assert_trees_close, batch, jbatch,  # noqa: E402
                          one_intraop_thread, pair, tbatch)
from repro import configs as jconfigs  # noqa: E402
from repro.configs import specs as jspecs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.optim.adamw import init_adamw as j_init_adamw  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import specs as tspecs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh, make_host_mesh  # noqa: E402
from repro_torch.optim.adamw import init_adamw  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
#: (arch, decode_attn_impl) whose placements are held
PLACED = [("qwen2-1.5b", "cp"), ("qwen2-1.5b", "paged_pallas"),
          ("llama3.2-1b", "eager"), ("granite-moe-3b-a800m", "eager"),
          ("jamba-1.5-large-398b", "eager"),
          ("llama4-scout-17b-a16e", "cp")]
#: leaves whose rule tests ``shape[0]``: the reference's fault R12
SHAPE0_LEAVES = ("/moe/gate_e", "/moe/up_e", "/moe/down_e",
                 "/mamba/conv_w", "/mamba/conv_b", "/mamba/A_log",
                 "/mamba/D", "/mamba/dt_bias")


def _jmesh(shape: dict):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _jflat(shardings) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda s: hasattr(s, "spec"))[0]
    return {jrules._keystr(path): tuple(s.spec) for path, s in flat}


def _tflat(specs) -> dict:
    return {path: spec for path, spec in leaves_with_path(specs)
            if isinstance(spec, tuple)}


def _unstack(jflat: dict, groups: int, stacked_prefix: str) -> dict:
    """The reference's placements in the port's list layout: a leaf of
    the stacked layer stack (``layers/...`` for parameters, every leaf of
    a cache) becomes one leaf a group, without the stacked group dim."""
    out = {}
    for path, spec in jflat.items():
        if stacked_prefix is None or path.startswith(stacked_prefix):
            rest = path[len(stacked_prefix or ""):]
            head = stacked_prefix.rstrip("/") + "/" if stacked_prefix \
                else ""
            for g in range(groups):
                out[f"{head}{g}/{rest}"] = spec[1:]
        else:
            out[path] = spec
    return out


def _configs(arch: str, impl: str):
    return (jconfigs.get_config(arch).with_(decode_attn_impl=impl),
            tconfigs.get_config(arch).with_(decode_attn_impl=impl))


@functools.lru_cache(maxsize=None)
def _j_params(arch: str):
    return jax.eval_shape(JLM(jconfigs.get_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _t_params(arch: str):
    return tsteps.abstract_params(tconfigs.get_config(arch))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch,impl", PLACED)
def test_placements_match_reference(arch, impl, shape_name, mesh_name):
    """Every parameter, cache and batch leaf of the cell gets the
    reference's spec at the production mesh (FSDP by ``auto_fsdp``, equal
    on both sides)."""
    jcfg, tcfg = _configs(arch, impl)
    shape_j, shape_t = jconfigs.SHAPES[shape_name], \
        tconfigs.SHAPES[shape_name]
    jm, tm = _jmesh(MESHES[mesh_name]), abstract_mesh(MESHES[mesh_name])
    fsdp = jsteps.auto_fsdp(jcfg, jm, shape_j.mode)
    assert tsteps.auto_fsdp(tcfg, tm, shape_t.mode) == fsdp
    g = tcfg.num_groups
    want = _unstack(_jflat(jsteps.param_shardings(_j_params(arch), jm,
                                                  fsdp=fsdp)), g, "layers/")
    got = _tflat(tsteps.param_shardings(_t_params(arch), tm, fsdp=fsdp,
                                        stacked_groups=g))
    assert got.keys() == want.keys()
    # the expert stacks and Mamba's channel leaves differ by the
    # reference's fault R12 (below)
    differ = {k for k in got if got[k] != want[k]}
    assert all(k.endswith(SHAPE0_LEAVES) for k in differ), differ
    jspec, tspec = jspecs.input_specs(jcfg, shape_j), \
        tspecs.input_specs(tcfg, shape_t)
    if shape_name == "train_4k":
        assert _tflat(tsteps.batch_shardings(tspec["batch"], tm)) == \
            _jflat(jsteps.batch_shardings(jspec["batch"], jm))
        return
    vec = {"token": tspec["token"], "pos": tspec["pos"]}
    assert _tflat(tsteps.batch_shardings(vec, tm)) == _jflat(
        jsteps.batch_shardings({"token": jspec["token"],
                                "pos": jspec["pos"]}, jm))
    want = _unstack(_jflat(jsteps.cache_shardings(jspec["cache"], jm, jcfg,
                                                  shape_j)), g, "")
    got = _tflat(tsteps.cache_shardings(tspec["cache"], tm, tcfg, shape_t))
    assert got == want, {k: (got.get(k), want.get(k))
                         for k in set(got) | set(want)
                         if got.get(k) != want.get(k)}
    if impl == "cp":
        assert got["0/blk0/kv/k"][1] == "model"        # the sequence


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b"])
def test_reference_fault_r12_rules_read_the_group_dim(arch):
    """R12: the reference's rules that test ``shape[0]`` (the expert
    stacks' ``_expert_spec`` and ``down_e`` rule, and Mamba's per-channel
    ``conv_w`` / ``conv_b`` / ``A_log`` / ``D`` / ``dt_bias`` rule,
    ``repro/sharding/rules.py:33-64,78-80``) mean the expert count or the
    channel count, but in its scanned tree ``shape[0]`` is the stacked
    group dim.  So its dry-run places granite's 40 experts (32 groups,
    which 16 divides) by the EP branch and then drops the split that 40
    does not take: every expert weight whole on every rank; and jamba's
    16 experts (9 groups) by the TP fallback and its 16,384 Mamba
    channels whole, where the same rules on one group's leaves give EP
    and a channel split.  The port applies the rules to a group's leaf,
    which is what they compute for the reference's unstacked tree."""
    jm = _jmesh(MESHES["16x16"])
    cfg = jconfigs.get_config(arch)
    g = cfg.num_groups
    stacked = _unstack(_jflat(jsteps.param_shardings(
        _j_params(arch), jm, fsdp=False)), g, "layers/")
    one_group = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape[1:],
                                                            l.dtype),
                             _j_params(arch)["layers"])
    per_group = _jflat(jsteps.param_shardings({"layers": one_group}, jm,
                                              fsdp=False))
    got = _tflat(tsteps.param_shardings(_t_params(arch), abstract_mesh(
        MESHES["16x16"]), fsdp=False, stacked_groups=g))
    n = 0
    for path, spec in got.items():
        if not path.endswith(SHAPE0_LEAVES):
            continue
        assert spec == per_group["layers/" + path.split("/", 2)[2]]
        assert stacked[path] != spec, path
        n += 1
    moe = sum(1 for i in range(cfg.blocks_per_group)
              if i % cfg.moe_every == 0)
    mamba = cfg.block_pattern.count("mamba")
    assert n == g * (3 * moe + 5 * mamba)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_decode_cache_source_kv_placed_as_reference(arch, mesh_name):
    """A cross-attention model's decode cell (the context-parallel decode,
    as the dry-run picks it at 8 kv heads on 16) carries the source K / V
    of each cross-attention block, placed as the reference's
    ``cache_shardings`` places them: the batch over the data axes, no
    model split (every other cache leaf too)."""
    jcfg, tcfg = _configs(arch, "cp")
    shape_j, shape_t = jconfigs.SHAPES["decode_32k"], \
        tconfigs.SHAPES["decode_32k"]
    jm, tm = _jmesh(MESHES[mesh_name]), abstract_mesh(MESHES[mesh_name])
    want = _unstack(_jflat(jsteps.cache_shardings(
        jspecs.input_specs(jcfg, shape_j)["cache"], jm, jcfg, shape_j)),
        tcfg.num_groups, "")
    got = _tflat(tsteps.cache_shardings(
        tspecs.input_specs(tcfg, shape_t)["cache"], tm, tcfg, shape_t))
    assert got == want
    source = {k: v for k, v in got.items() if k.endswith(("/xk", "/xv"))}
    assert source and all("model" not in str(v) and v[0] is not None
                          for v in source.values())


def test_abstract_inputs_match_reference_shapes():
    """``input_specs`` on meta has the reference's shapes and dtypes at
    every arch and shape (the caches in the port's list layout; a decode
    cache carries the cross-attention source K / V as the reference's
    does, an empty prefill cache leaves them to the prefill)."""
    for arch in jconfigs.ARCH_IDS:
        for name in jconfigs.SHAPES:
            jcfg, tcfg = jconfigs.get_config(arch), \
                tconfigs.get_config(arch)
            j = jspecs.input_specs(jcfg, jconfigs.SHAPES[name])
            t = tspecs.input_specs(tcfg, tconfigs.SHAPES[name])
            assert set(j) == set(t), (arch, name)
            for key in j:
                if key == "cache":
                    jl = jax.tree_util.tree_flatten_with_path(j[key])[0]
                    # a cross-attention block's source K / V join the
                    # port's prefill cache at prefill (none is held before
                    # there is a source); the reference allocates them,
                    # and the decode cell reads them
                    source = () if jconfigs.SHAPES[name].mode == "decode" \
                        else ("/xk", "/xv")
                    want = {jrules._keystr(p): (tuple(l.shape[1:]),
                                                str(l.dtype)) for p, l in jl
                            if not (source and jrules._keystr(p)
                                    .endswith(source))}
                    got = {p.split("/", 1)[1]: (tuple(l.shape),
                                                str(l.dtype)[6:])
                           for p, l in leaves_with_path(t[key])}
                    assert got == want, (arch, name)
                    assert len(t[key]) == tcfg.num_groups
                    continue
                jl = jax.tree_util.tree_flatten_with_path(j[key])[0]
                tl = leaves_with_path(t[key])
                assert {jrules._keystr(p): (tuple(l.shape), str(l.dtype))
                        for p, l in jl} == \
                    {p: (tuple(l.shape), str(l.dtype)[6:]) for p, l in tl}, \
                    (arch, name, key)
                assert all(l.device.type == "meta" for _, l in tl)


def test_reference_pure_functions_match_over_every_arch_and_shape():
    """``auto_fsdp`` on both production meshes and every mode,
    ``cell_supported``, ``model_flops_for`` and ``analytic_hbm_bytes``
    equal the reference's for every arch and shape."""
    for arch in jconfigs.ARCH_IDS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for shape in MESHES.values():
            for mode in ("train", "prefill", "decode"):
                assert tsteps.auto_fsdp(tcfg, abstract_mesh(shape), mode) \
                    == jsteps.auto_fsdp(jcfg, _jmesh(shape), mode)
        for name in jconfigs.SHAPES:
            js, ts = jconfigs.SHAPES[name], tconfigs.SHAPES[name]
            assert ts == tconfigs.get_shape(name)
            assert (ts.name, ts.seq_len, ts.global_batch, ts.mode) == \
                (js.name, js.seq_len, js.global_batch, js.mode)
            assert tspecs.cell_supported(tcfg, ts) == \
                jspecs.cell_supported(jcfg, js)
            assert troof.model_flops_for(tcfg, ts) == \
                jroof.model_flops_for(jcfg, js)
            for n, m in ((256, 16), (512, 16), (16, 4)):
                assert troof.analytic_hbm_bytes(tcfg, ts, n_chips=n,
                                                model_axis=m) == \
                    jroof.analytic_hbm_bytes(jcfg, js, n_chips=n,
                                             model_axis=m)
    assert tspecs.SUBQUADRATIC == jspecs.SUBQUADRATIC


def test_auto_fsdp_policy():
    """The reference's ``test_auto_fsdp_policy`` cases."""
    mesh = abstract_mesh({"data": 16, "model": 16})
    get = tconfigs.get_config
    assert tsteps.auto_fsdp(get("jamba-1.5-large-398b"), mesh, "train")
    assert tsteps.auto_fsdp(get("jamba-1.5-large-398b"), mesh, "decode")
    assert not tsteps.auto_fsdp(get("llama3.2-1b"), mesh, "train")
    assert tsteps.auto_fsdp(get("deepseek-coder-33b"), mesh, "train")
    assert not tsteps.auto_fsdp(get("deepseek-coder-33b"), mesh, "decode")


def _terms_pair(seed: int):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(1e9, 1e12, 5)
    colls = {"all-reduce": float(vals[3]), "all-gather": float(vals[4])}
    counts = {"all-reduce": int(seed + 3), "all-gather": 2}
    hw = troof.h100_peaks()
    jhw = {"peak_flops_bf16": hw["peak_flops_bf16"],
           "hbm_bw": hw["hbm_bw"], "ici_bw_per_link": hw["link_bw"]}
    kw = dict(flops=float(vals[0]), hbm_bytes=float(vals[1]),
              collective_bytes=float(vals[3] + vals[4]), t_compute=0.0,
              t_memory=0.0, t_collective=0.0, bottleneck="compute",
              model_flops=1.0, useful_ratio=0.0, collectives=colls,
              collective_counts=counts)
    return troof.RooflineTerms(**kw), jroof.RooflineTerms(**kw), jhw


def test_extrapolate_terms_and_roofline_properties_match_reference():
    """``extrapolate_terms`` from the same A / B terms equals the
    reference's at the same peaks (its ``HW`` dict given the H100's),
    ``t_max`` and ``roofline_fraction`` too, for every arch's group count
    and model FLOPs."""
    ta, ja, jhw = _terms_pair(1)
    tb, jb, _ = _terms_pair(2)
    for arch in jconfigs.ARCH_IDS:
        jcfg = jconfigs.get_config(arch)
        for name, js in jconfigs.SHAPES.items():
            mf = jroof.model_flops_for(jcfg, js)
            t = troof.extrapolate_terms(ta, tb, jcfg.num_groups,
                                        n_chips=256, model_flops=mf)
            j = jroof.extrapolate_terms(ja, jb, jcfg.num_groups,
                                        n_chips=256, model_flops=mf, hw=jhw)
            assert t.to_dict() == j.to_dict(), (arch, name)
            assert (t.t_max, t.roofline_fraction) == \
                (j.t_max, j.roofline_fraction)


def _prefill_hand_flops(cfg, b: int, s: int) -> float:
    """The products of a prefill at (b, s) with the plain attention
    (every (query, key) pair, as the plain sdpa scores them below
    ``attn_chunk_min``) and the last token's logits."""
    a = cfg.attention
    t, d, hd = b * s, cfg.d_model, a.head_dim
    proj = 2 * t * d * (a.num_heads + 2 * a.num_kv_heads) * hd \
        + 2 * t * a.num_heads * hd * d
    mlp = 3 * 2 * t * d * cfg.d_ff
    attn = 2 * 2 * b * a.num_heads * s * s * hd
    return cfg.num_layers * (proj + mlp + attn) + 2 * b * d \
        * cfg.padded_vocab


def test_prefill_cell_flops_equal_a_hand_count():
    """A smoke prefill cell's traced FLOPs are its products counted by
    hand, on one rank and per rank of a model axis of 2 (the heads, MLP
    and vocab split)."""
    cfg = tconfigs.get_smoke_config("qwen2-1.5b")
    shape = tconfigs.ShapeConfig("p", 64, 2, "prefill")
    one = tsteps.build_cell(cfg, shape, abstract_mesh({})).trace()
    assert one.flops == _prefill_hand_flops(cfg, 2, 64)
    two = tsteps.build_cell(cfg, shape, abstract_mesh({"model": 2})).trace()
    assert two.flops == one.flops / 2
    assert two.collective_counts == {"all-reduce/model": 2 * 2 + 1,
                                     "all-gather/model": 1}


def test_extrapolation_from_one_and_two_groups_equals_a_full_trace():
    """The reference's shortcut (1- and 2-group traces extrapolated to G
    groups) gives the full-depth trace's FLOPs, bytes and collectives, on
    a train cell and a cp decode cell over a model axis of 2."""
    base = tconfigs.get_smoke_config("qwen2-1.5b")
    cases = [(base.with_(num_layers=5),
              tconfigs.ShapeConfig("t", 32, 4, "train"),
              {"data": 2, "model": 2}),
             (base.with_(num_layers=5, decode_attn_impl="cp"),
              tconfigs.ShapeConfig("d", 64, 4, "decode"), {"model": 2})]
    for cfg, shape, mesh in cases:
        def trace(n, cfg=cfg, shape=shape, mesh=mesh):
            return tsteps.build_cell(cfg.with_(num_layers=n), shape,
                                     abstract_mesh(mesh)).trace(1.0)
        full = trace(cfg.num_layers)
        ext = troof.extrapolate_terms(trace(1), trace(2), cfg.num_groups,
                                      n_chips=4, model_flops=1.0)
        assert (ext.flops, ext.hbm_bytes, ext.collective_bytes) == \
            (full.flops, full.hbm_bytes, full.collective_bytes)
        assert ext.collective_counts == full.collective_counts
        assert ext.collectives == full.collectives


def test_train_cell_step_matches_reference_cell_fn(one_intraop_thread):
    """One step of the port's train cell on the CPU (a world of one)
    equals the reference's ``build_cell(...).fn`` on a 1 x 1 mesh, run
    eagerly: loss, grad norm and every parameter leaf after the update
    (llama3.2-1b smoke, float32)."""
    jlm, tlm, jp, tp = pair("llama3.2-1b")
    shape = tconfigs.ShapeConfig("train_4k", 64, 4, "train")
    jshape = jconfigs.base.ShapeConfig("train_4k", 64, 4, "train")
    # Auto axes: the cell's gradient constraint refers to its axes
    mesh11 = jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jcell = jsteps.build_cell(jlm.cfg, jshape, mesh11)
    b = batch(jlm.cfg.vocab_size, 4, 64, seed=5, mask=True)
    with mesh11:
        jparams, _, jm = jcell.fn(jp, j_init_adamw(jp), jbatch(b))
    cell = tsteps.build_cell(tlm.cfg, shape, make_host_mesh(device="cpu"))
    tparams, opt, tm = cell.fn(tp, init_adamw(tp), tbatch(b))
    assert opt.step == 1
    for key in ("loss", "grad_norm", "ce_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert_trees_close(tparams, jparams, tlm.cfg, 1e-5, "params")


def test_dryrun_cli_writes_the_cell_and_the_skips(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape
    decode_32k`` on the CPU: exit 0, the reference's one-line summary,
    a JSON cell whose collectives come from the port's collective layer
    (the context-parallel decode's, as the eager one is refused at 2 kv
    heads on 16 ranks) at the H100's peaks; ``long_500k`` on a
    full-attention arch is written as skipped."""
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[dryrun] qwen2-1.5b__decode_32k__pod16x16: OK" in out
    assert "done: 1 ok, 0 skipped, 0 refused, 0 errors" in out
    cell = json.loads((tmp_path / "qwen2-1.5b__decode_32k__pod16x16.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["n_chips"] == 256
    assert cell["decode_attn_impl"] == "cp"
    assert cell["peaks"] == troof.h100_peaks()
    assert cell["peaks"]["peak_flops_bf16"] == 989.4e12
    r = cell["roofline"]
    # 28 layers x (the combine's max / l / o, wo, down) + the embedding;
    # 28 x (q, k, v) + the logits
    assert r["collective_counts"] == {"all-reduce/model": 141,
                                      "all-gather/model": 85}
    assert r["t_collective"] == r["collective_bytes"] / 50e9
    assert cell["memory"]["argument_bytes"] > 0
    assert cell["analytic_hbm_bytes"] > 0
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    skip = json.loads((tmp_path / "qwen2-1.5b__long_500k__pod16x16.json")
                      .read_text())
    assert skip["status"] == "skipped" and "quadratic" in skip["why"]
