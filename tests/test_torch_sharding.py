"""Placement rules of the port (``repro_torch.sharding.rules``) against
the reference's ``PartitionSpec``s, leaf by leaf, and the pieces of the
sharded serving path that need no process group: slicing a tree and
joining it again, the mesh's refusals, the collective accounting and the
collective layer's rules.

JAX's ``make_param_specs`` reads only ``mesh.shape``, so an object with a
``shape`` dict stands in for a mesh of any size on either side.  The
reference's trees come from ``jax.eval_shape`` (no weights are drawn);
the port's are built on the ``meta`` device, so full widths cost
nothing."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.peft.lora import apply_peft as j_apply_peft  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize_tree  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.peft.lora import apply_peft  # noqa: E402
from repro_torch.quant.qops import quantize_tree  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    def __init__(self, model, data=1):
        self.shape = {"data": data, "model": model}


#: (model, data) axis sizes every tree is placed under
MESHES = [(m, d) for m in (1, 2, 4, 16) for d in (1, 16)]


def _jax_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, P))[0]
    return {jrules._keystr(path): tuple(spec) for path, spec in flat}


def _port_flat(specs) -> dict:
    return {path: spec for path, spec in leaves_with_path(specs)
            if isinstance(spec, tuple)}


def _as_structs(tree):
    """A port tree (dicts, lists, tensors) as a pytree of shape structs
    with the same paths (lists stay lists)."""
    if isinstance(tree, dict):
        return {k: _as_structs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_structs(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _assert_same(tree, jtree=None):
    """The port's placements of ``tree`` (a port tree, or the reference's
    shape structs when ``jtree`` is None) equal JAX's at every mesh, with
    FSDP off and on."""
    jtree = _as_structs(tree) if jtree is None else jtree
    n = 0
    for m, d in MESHES:
        for fsdp in (False, True):
            want = _jax_flat(jrules.make_param_specs(jtree, FakeMesh(m, d),
                                                     fsdp=fsdp))
            got = _port_flat(rules.make_param_specs(tree, FakeMesh(m, d),
                                                    fsdp=fsdp))
            assert got == want, (m, d, fsdp, {
                k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)})
            n += len(got)
    assert n > 0


def _port_tree(cfg):
    """The port's parameter tree at ``cfg``'s widths, on ``meta``, two
    groups deep: every group of the port's list holds the same leaves at
    the same shapes, so two cover every path and index form (the
    reference's stacked tree is held at full depth)."""
    cfg = cfg.with_(num_layers=min(cfg.num_layers,
                                   2 * len(cfg.block_pattern)))
    return TLM(cfg, device="meta").init(torch.Generator())


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_rules_match_jax_for_every_leaf(arch, size):
    """Every leaf of the reference's stacked tree and of the port's list
    tree gets JAX's placement, at model 1 / 2 / 4 / 16, data 1 / 16, FSDP
    off and on."""
    get = get_smoke_config if size == "smoke" else get_config
    jcfg = get(arch)
    tget = tconfigs.get_smoke_config if size == "smoke" \
        else tconfigs.get_config
    jtree = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    _assert_same(jtree, jtree)
    _assert_same(_port_tree(tget(arch)))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-1b",
                                  "granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b", "whisper-base"])
def test_rules_match_jax_on_quantized_and_lora_trees(arch):
    """int8 / int4 / fp8 trees and LoRA / DoRA trees, the reference's
    (from ``eval_shape``) and the port's, at smoke shapes."""
    jcfg = get_smoke_config(arch)
    key = jax.random.PRNGKey(0)
    params = TLM(tconfigs.get_smoke_config(arch), device="cpu").init(0)
    for quant in ("int8", "int4", "fp8"):
        jtree = jax.eval_shape(
            lambda k: j_quantize_tree(JLM(jcfg).init(k), quant=quant), key)
        _assert_same(jtree, jtree)
        _assert_same(quantize_tree(params, quant=quant))
    for method in ("lora", "dora"):
        jtree = jax.eval_shape(
            lambda k: j_apply_peft(JLM(jcfg).init(k), k, method=method), key)
        _assert_same(jtree, jtree)
        _assert_same(apply_peft(params, 0, method=method))


#: the trees whose placements A8.3 computes on: granite's 5 experts (the
#: TP fallback over 2 and 4), granite's padded to 6 (EP over 2 with a
#: never-routed pad expert), llama4-scout's 4 with a shared expert (EP),
#: and qwen2's dense tree
A83_TREES = ("granite", "granite_pad2", "llama4", "qwen2")
A83_TRANSFORMS = ("none", "int8", "fp8", "int4", "lora", "dora", "rslora",
                  "qlora")


def _a83_config(get, tree: str):
    import dataclasses
    arch = {"granite": "granite-moe-3b-a800m",
            "granite_pad2": "granite-moe-3b-a800m",
            "llama4": "llama4-scout-17b-a16e", "qwen2": "qwen2-1.5b"}[tree]
    cfg = get(arch)
    if tree == "granite_pad2":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                expert_pad_multiple=2))
    return cfg


@pytest.mark.parametrize("transform", A83_TRANSFORMS)
@pytest.mark.parametrize("tree", A83_TREES)
def test_rules_match_jax_on_moe_quantized_and_adapted_trees(tree,
                                                            transform):
    """The trees A8.3 serves and trains under a model axis, quantized
    (int8 / fp8 / int4) or with adapters (LoRA / DoRA / rsLoRA, and
    QLoRA on an int4 base), the reference's (from ``eval_shape``) and the
    port's, get JAX's placements at model 1 / 2 / 4 / 16 (FSDP off and
    on): the expert stacks on E where the axis divides it, else on the
    experts' hidden width; ``/lora/b`` on its columns under a row-split
    ``wo`` / ``down`` too."""
    jcfg = _a83_config(get_smoke_config, tree)
    tcfg = _a83_config(tconfigs.get_smoke_config, tree)
    quant = {"int8": "int8", "fp8": "fp8", "int4": "int4",
             "qlora": "int4"}.get(transform)
    method = transform if transform in ("lora", "dora", "rslora",
                                        "qlora") else None

    def jtree(k):
        p = JLM(jcfg).init(k)
        if quant:
            p = j_quantize_tree(p, quant=quant)
        return j_apply_peft(p, k, method=method) if method else p
    jt = jax.eval_shape(jtree, jax.random.PRNGKey(0))
    _assert_same(jt, jt)
    params = TLM(tcfg, device="cpu").init(0)
    if quant:
        params = quantize_tree(params, quant=quant)
    if method:
        params = apply_peft(params, 0, method=method)
    _assert_same(params)
    if tcfg.moe is not None and transform == "none":
        for m in (2, 4):
            spec = rules.make_param_specs(params, FakeMesh(m))[
                "layers"][0]["blk0"]["moe"]["gate_e"]
            ep = tcfg.moe.padded_experts % m == 0
            assert spec == (("model", None, None) if ep
                            else (None, None, "model")), (tree, m)
    if method and tree == "qwen2":
        spec = rules.make_param_specs(params, FakeMesh(2))[
            "layers"][0]["blk0"]["mlp"]["down"]
        assert spec["lora"]["b"] == (None, "model")
        assert spec["lora"]["a"] == (None, None)


CTX16 = {"model_size": 16, "data_size": 16}


def test_reference_cases_tp_rules_shard_projections_not_norms():
    """The reference's ``tests/test_sharding.py`` cases."""
    spec = rules.spec_for_path
    assert spec("layers/blk0/attn/wq/w", (64, 256), CTX16) == (None, "model")
    assert spec("layers/blk0/attn/wo/w", (256, 64), CTX16) == ("model", None)
    assert spec("layers/blk0/norm1/scale", (64,), CTX16) == (None,)
    assert spec("embed/w", (4096, 64), CTX16) == ("model", None)
    assert spec("layers/blk0/moe/gate_e", (16, 64, 128), CTX16) \
        == ("model", None, None)
    assert spec("layers/blk0/moe/gate_e", (40, 64, 128), CTX16) \
        == (None, None, "model")
    # the port's list layout: the same placements, no stacked dim
    assert spec("layers/0/blk0/attn/wq/w", (64, 256), CTX16) \
        == (None, "model")
    assert spec("layers/blk0/attn/wq/w", (4, 64, 256), CTX16) \
        == (None, None, "model")


def test_reference_cases_sanitize_and_fsdp():
    s = rules.spec_for_path("embed/w", (49155, 1536), CTX16)
    assert rules._sanitize(s, (49155, 1536), CTX16) == (None, None)
    spec = rules.spec_for_path("layers/blk0/mlp/gate/w", (8192, 32768),
                               CTX16)
    assert "data" in rules._with_fsdp(spec, (8192, 32768), CTX16)
    assert rules._with_fsdp((None,), (64,), CTX16) == (None,)
    for a, b in ((s, (49155, 1536)), (spec, (8192, 32768))):
        assert rules._sanitize(a, b, CTX16) == tuple(
            jrules._sanitize(P(*a), b, CTX16))
        assert rules._with_fsdp(a, b, CTX16) == tuple(
            jrules._with_fsdp(P(*a), b, CTX16))


def test_reference_cases_quantized_and_bias_leaves():
    """The reference's ``tests/test_sharded_serving.py`` partition cases
    for quantized scale and bias leaves."""
    ctx = {"model_size": 2, "data_size": 1}
    cases = {
        "lm_head/qw": (None, "model"), "lm_head/scale": ("model",),
        "unembed/qw": (None, "model"),
        "layers/0/mlp/gate/qw": (None, "model"),
        "layers/0/mlp/gate/scale": ("model",),
        "layers/0/attn/wq/scale": ("model",),
        "layers/0/attn/wo/scale": (None,),
        "layers/0/mlp/down/scale": (None,),
        "layers/0/mlp/up/b": ("model",),
        "layers/0/moe/shared/gate/b": ("model",),
        "layers/0/mlp/down/b": (None,), "layers/0/attn/wo/b": (None,)}
    for path, want in cases.items():
        shape = (64, 128) if path.endswith("qw") else (128,)
        got = rules.spec_for_path(path, shape, ctx)
        assert got == want == tuple(jrules.spec_for_path(path, shape, ctx))


@pytest.mark.parametrize("batch", [1, 4, 16, 32])
def test_batch_spec_and_dp_axes_match_jax(batch):
    for m, d in MESHES:
        mesh = FakeMesh(m, d)
        assert rules.dp_axes(mesh) == jrules.dp_axes(mesh)
        for trailing in (1, 2):
            assert rules.batch_spec(mesh, batch, trailing=trailing) == \
                tuple(jrules.batch_spec(mesh, batch, trailing=trailing))


class RankMesh:
    """The slicing coordinates of one rank (no process group)."""

    def __init__(self, rank, model, data=1):
        self.shape = {"data": data, "model": model}
        self.coords = rules.rank_coords(rank, self.shape)


@pytest.mark.parametrize("model,data,fsdp", [(2, 1, False), (4, 1, False),
                                             (2, 2, True), (4, 4, True)])
def test_shard_params_then_unshard_gives_back_the_tree(model, data, fsdp):
    """Every rank's slice, joined, is the whole tree bit for bit; a
    split leaf's slice is 1/m of it and a whole leaf is the same tensor;
    the column split of ``wq`` takes whole heads in rank order."""
    cfg = tconfigs.get_smoke_config("qwen2-1.5b").with_(d_ff=256)
    params = quantize_tree(TLM(cfg, device="cpu").init(0), quant="int8")
    params["layers"][0]["blk0"]["mlp"]["up"] = \
        TLM(cfg, device="cpu").init(1)["layers"][0]["blk0"]["mlp"]["up"]
    shape = {"data": data, "model": model}
    specs = rules.make_param_specs(params, FakeMesh(model, data), fsdp=fsdp)
    world = model * data
    shards = [rules.shard_params(params, specs, RankMesh(r, model, data))
              for r in range(world)]
    back = rules.unshard(shards, specs, shape)
    for (path, a), (_, b) in zip(leaves_with_path(params),
                                 leaves_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    wq = params["layers"][0]["blk0"]["attn"]["wq"]["qw"]
    w1 = shards[1]["layers"][0]["blk0"]["attn"]["wq"]["qw"]
    cols = wq.shape[1] // model
    assert torch.equal(w1, wq[:, cols:2 * cols])
    norm = params["layers"][0]["blk0"]["norm1"]["scale"]
    assert shards[1]["layers"][0]["blk0"]["norm1"]["scale"] is norm


def test_shard_params_splits_over_axis_tuples_major_to_minor():
    """A dim split over ("data", "model") takes piece data * m + model,
    as a ``PartitionSpec`` tuple entry does; unshard inverts it."""
    t = torch.arange(16 * 6).reshape(16, 6)
    tree = {"a": t, "b": [t.T.contiguous()]}
    specs = {"a": (("data", "model"), None), "b": [(None, "data")]}
    shape = {"data": 2, "model": 4}
    shards = [rules.shard_params(tree, specs, RankMesh(r, 4, 2))
              for r in range(8)]
    assert torch.equal(shards[5]["a"], t[10:12])        # data 1, model 1
    assert torch.equal(shards[5]["b"][0], t.T[:, 8:16])
    back = rules.unshard(shards, specs, shape)
    assert torch.equal(back["a"], t) and torch.equal(back["b"][0], t.T)


def test_make_host_mesh_refusals_name_the_recipe():
    """A model axis the world does not divide, and a model axis below 1,
    are refused with the port's recipe (how to start N ranks)."""
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(ValueError) as exc:
        make_host_mesh(model=2, device="cpu")
    msg = str(exc.value)
    assert "spawn_world" in msg and "--model-parallel" in msg
    assert "model=2" in msg and "1 rank " in msg
    with pytest.raises(ValueError):
        make_host_mesh(model=0, device="cpu")
    mesh = make_host_mesh(model=1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    assert "mesh {'data': 1, 'model': 1} over 1 rank" in mesh.describe()


def test_collective_stats_per_step_breakdown_matches_reference():
    """``CollectiveStats.to_dict`` and its metrics equal the reference's
    on the reference's test numbers."""
    from repro.launch.roofline import CollectiveStats as JStats
    from repro.obs.metrics import MetricsRegistry as JReg
    from repro_torch.launch.roofline import CollectiveStats
    from repro_torch.obs.metrics import MetricsRegistry
    kw = dict(bytes_by_op={"all-gather": 800.0, "all-reduce": 400.0},
              count_by_op={"all-gather": 2, "all-reduce": 1})
    st, js = CollectiveStats(**kw), JStats(**kw)
    for steps in (1, 4):
        assert st.to_dict(steps=steps) == js.to_dict(steps=steps)
    assert "bytes_per_step_by_op" not in st.to_dict()
    assert st.to_dict(steps=4)["total_bytes_per_step"] == 300.0
    tr, jr = MetricsRegistry(), JReg()
    st.register_metrics(tr, steps=4)
    js.register_metrics(jr, steps=4)
    assert tr.snapshot()["gauges"] == jr.snapshot()["gauges"]
    acc = CollectiveStats()
    acc.add("all-reduce", 10.0)
    before = acc.copy()
    acc.add("all-reduce", 6.0)
    acc.add("all-gather", 4.0)
    acc.merge(acc.since(before))
    assert acc.bytes_by_op == {"all-reduce": 22.0, "all-gather": 8.0}
    assert acc.count_by_op == {"all-reduce": 3, "all-gather": 2}


def test_collective_layer_has_no_try_and_no_device_switch():
    """The collective layer calls ``all_reduce`` and ``broadcast`` alone,
    with no ``try`` around them and no branch on the device: the CPU runs
    the route the card runs."""
    path = ROOT / "src" / "repro_torch" / "sharding" / "collectives.py"
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    calls = {ast.unparse(n.func) for n in ast.walk(tree)
             if isinstance(n, ast.Call)}
    assert {"dist.all_reduce", "dist.broadcast"} <= calls
    others = {c for c in calls if c.startswith("dist.")} \
        - {"dist.all_reduce", "dist.broadcast"}
    assert not others
    assert "is_cuda" not in path.read_text() \
        and "device.type" not in path.read_text()
    # the autograd pairs move their data through the same one operator
    pairs = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)
             and any(ast.unparse(b) == "torch.autograd.Function"
                     for b in n.bases)}
    assert set(pairs) == {"_CopyToModel", "_ReduceFromModel", "_Gather"}
    for cls in pairs.values():
        used = {ast.unparse(n.func) for n in ast.walk(cls)
                if isinstance(n, ast.Call)}
        assert used & {"_call", "_reduce_f32"}, cls.name
        assert not {u for u in used if u.startswith("dist.")}, cls.name


def test_fsdp_min_size_is_honoured():
    """``make_param_specs(fsdp=True, fsdp_min_size=)`` splits over "data"
    exactly the leaves of at least that many elements that the rule can
    split (the reference drops the argument: ROADMAP C, reference fault
    11); at the default it places as JAX does (every arch above)."""
    params = _port_tree(tconfigs.get_smoke_config("qwen2-1.5b"))
    mesh = FakeMesh(2, 2)

    def specs(**kw):
        return dict(leaves_with_path(rules.make_param_specs(params, mesh,
                                                            **kw)))
    plain, every = specs(), specs(fsdp=True, fsdp_min_size=1)
    assert sum("data" in s for s in every.values()) > len(every) // 2
    sizes = sorted({t.numel() for _, t in leaves_with_path(params)})
    for min_size in (1, sizes[len(sizes) // 2], 1 << 20):
        got = specs(fsdp=True, fsdp_min_size=min_size)
        for path, t in leaves_with_path(params):
            want = every if t.numel() >= min_size else plain
            assert got[path] == want[path], (min_size, path)
    assert specs(fsdp=True) == specs(fsdp=True, fsdp_min_size=1 << 20) \
        == plain


def test_chip_smoke_drives_the_train_tp_phase():
    """chip_smoke.py has a sharded-training phase that its main runs after
    the tensor-parallel serving phase: ``launch.train --model-parallel``
    on two spawned ranks, a data axis with FSDP through ``Trainer(``, and
    float32 gradients and losses of both meshes against one rank's."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert main_calls.index("phase_train_tp") > main_calls.index("phase_tp")
    reached, todo = set(), ["phase_train_tp"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(a) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call)
                 for a in [c.func] + list(c.args)
                 if ast.unparse(a) in funcs and ast.unparse(a) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("spawn_world", "Trainer(", "fsdp=True", "launch.train",
                   "--model-parallel", "make_host_mesh", "_no_launches",
                   "max_memory_allocated", "step_collectives", "float32"):
        assert needle in body, needle
    assert "[24 train_tp]" in text


def test_chip_smoke_drives_the_moe_quant_and_peft_phases():
    """chip_smoke.py has the two A8.3 phases, run by its main after the
    sharded-training phase: 25 serves granite at full width with EP, the
    gather dispatch, float32 granite, qwen2 with fp8 (every B6 call held)
    and int4 weights and with LoRA adapters on two spawned ranks against
    one rank, after B1 / B3 / B6 are held and timed at the ranks' shapes;
    26 trains LoRA / QLoRA llama3.2-1b and granite's first 8 layers and
    holds float32 first-step gradients, the router's included."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert main_calls.index("phase_tp_moe") > main_calls.index(
        "phase_train_tp")
    assert main_calls.index("phase_train_tp_peft") > main_calls.index(
        "phase_tp_moe")

    def reached(root):
        seen, todo = set(), [root]
        while todo:
            name = todo.pop()
            seen.add(name)
            todo += [ast.unparse(a) for c in ast.walk(funcs[name])
                     if isinstance(c, ast.Call)
                     for a in [c.func] + list(c.args)
                     if ast.unparse(a) in funcs and ast.unparse(a) not in seen]
        return "\n".join(ast.unparse(funcs[n]) for n in sorted(seen))
    body = reached("phase_tp_moe")
    for needle in ("spawn_world", "make_host_mesh", "PagedEngine(",
                   "GRANITE", "moe_impl='gather'", "float32",
                   "quantize_tree", "'fp8'", "'int4'", "apply_peft",
                   "_fp8_calls_vs_plain", "fp8_decode_ref", "_reset_launches",
                   "LOGIT_REL_L2", "max_memory_allocated", "paged_attention",
                   "flash_attention", "fp8_matmul_decode", "bound(",
                   "scaled_dot_product_attention", "decode_collectives"):
        assert needle in body, needle
    body = reached("phase_train_tp_peft")
    for needle in ("spawn_world", "make_host_mesh", "Trainer(",
                   "trainable_mask", "'lora'", "'qlora'", "first_layers",
                   "_no_launches", "max_memory_allocated", "sharded_grads",
                   "gather_leaf", "router", "TRAIN_TP_GRAD_REL_L2"):
        assert needle in body, needle
    assert "[25 tp_moe_quant]" in text and "[26 train_tp_peft]" in text


def test_local_attention_and_refusals():
    """A rank's attention config holds H/m over KVH/m heads; an axis that
    does not divide both is refused naming both counts."""
    from repro_torch.sharding.tp import local_attention
    cfg = tconfigs.get_config("qwen2-1.5b")
    a = local_attention(cfg.with_(model_parallel=2))
    assert (a.num_heads, a.num_kv_heads, a.head_dim) == (6, 1, 128)
    assert local_attention(cfg) is cfg.attention
    with pytest.raises(ValueError, match="12 query heads.*2 kv heads"):
        local_attention(cfg.with_(model_parallel=4))
