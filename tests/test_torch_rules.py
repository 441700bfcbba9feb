"""Rules of the port: it imports nothing of JAX or of the reference
package and carries no TPU constant, its entry points never fall back to
the CPU on their own, and its copied configs agree with the reference's."""
import ast
import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_port_imports_no_msgpack():
    """The card's machine has no ``msgpack``: the port's checkpoints keep
    their manifest in JSON, and no port file imports it."""
    bad = [str(f.relative_to(ROOT)) for f in _port_files()
           if "msgpack" in set(_imported_roots(f))]
    assert not bad
    from repro_torch.checkpoint import manager
    assert manager.MANIFEST.endswith(".json")


def test_scan_covers_the_scheduler_and_every_kernel_module():
    """The import rule above reaches the scheduler, the quantization
    modules, the RWKV-6 mixer, every kernel wrapper and the dry-run,
    context-parallel and pipeline modules."""
    scanned = {str(f.relative_to(ROOT)) for f in _port_files()}
    for rel in ("sched/__init__.py", "sched/policy.py", "sched/prefix.py",
                "sched/scheduler.py", "kernels/paged_attention/ops.py",
                "kernels/paged_attention/ref.py", "kernels/build.py",
                "quant/__init__.py", "quant/qops.py",
                "kernels/int8_matmul/ops.py", "kernels/int8_matmul/ref.py",
                "kvcache/quant.py", "models/ssm.py", "models/moe.py",
                "kernels/wkv6/__init__.py", "kernels/wkv6/ops.py",
                "kernels/wkv6/ref.py", "kernels/rmsnorm/__init__.py",
                "kernels/rmsnorm/ops.py", "kernels/rmsnorm/ref.py",
                "configs/rwkv6_1_6b.py", "spec/__init__.py",
                "spec/engine.py", "spec/drafter.py", "spec/controller.py",
                "spec/rollback.py", "core/costmodel.py",
                "resil/__init__.py", "resil/errors.py", "resil/inject.py",
                "resil/degrade.py", "serve/engine.py", "kvcache/cache.py",
                "models/attention.py", "core/space.py", "core/apply.py",
                "obs/profile.py", "launch/idle_power.py",
                "core/features.py", "core/pareto.py", "core/nsga2.py",
                "core/surrogate.py", "core/evaluator.py", "core/tuner.py",
                "configs/paper_models.py", "configs/whisper_base.py",
                "configs/jamba_1_5_large_398b.py", "tables/__init__.py",
                "tables/common.py", "tables/table2_main.py",
                "tables/table3_ablations.py", "tables/table4_vlm.py",
                "tables/table6_tasks.py", "tables/pareto_front.py",
                "tables/run.py", "tree.py", "optim/__init__.py",
                "optim/adamw.py", "optim/compress.py", "peft/__init__.py",
                "peft/lora.py", "train/__init__.py", "train/loop.py",
                "data/__init__.py", "data/pipeline.py",
                "checkpoint/__init__.py", "checkpoint/manager.py",
                "launch/train.py", "launch/dryrun.py", "launch/steps.py",
                "launch/roofline.py", "launch/mesh.py", "configs/specs.py",
                "serve/decode_attn.py", "sharding/pipeline.py"):
        assert f"src/repro_torch/{rel}" in scanned, rel
    from repro_torch.kernels import build
    for src in build.SOURCES.values():
        assert (build.CSRC / src).is_file(), src
    for name in ("paged_prefix_extend", "int8_matmul", "w8a8_decode",
                 "fp8_decode", "wkv6", "rmsnorm"):
        assert name in build.SOURCES and name in build.SIGNATURES, name


#: each wrapper module -> the plain versions its CPU branch returns
WRAPPERS = {"kernels/int8_matmul/ops.py": ("int8_matmul_ref",
                                           "w8a8_decode_ref",
                                           "fp8_decode_ref"),
            "kernels/paged_attention/ops.py": ("paged_attention_ref",
                                               "paged_prefix_extend_ref"),
            "kernels/flash_attention/ops.py": ("attention_ref",),
            "kernels/wkv6/ops.py": ("wkv6_chunked_ref",),
            "kernels/rmsnorm/ops.py": ("rmsnorm_ref",)}


@pytest.mark.parametrize("rel", sorted(WRAPPERS))
def test_wrappers_dispatch_on_the_device_without_fallback(rel):
    """Every kernel wrapper picks its plain version only on a CPU or a
    meta tensor's device (an ``if <tensor>.device.type in ("cpu",
    "meta")`` branch: a meta tensor has no values and no kernel, and the
    plain version gives a dry-run trace its result's shape and dtype),
    raises for any other device than CUDA, and has no ``try`` anywhere:
    a failed build or launch on the card raises instead of falling
    back."""
    path = ROOT / "src" / "repro_torch" / rel
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel
    plain_returns = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        test = ast.unparse(node.test)
        if test.endswith(".device.type in ('cpu', 'meta')"):
            for stmt in node.body:
                if isinstance(stmt, ast.Return) and \
                        isinstance(stmt.value, ast.Call):
                    plain_returns.add(ast.unparse(stmt.value.func))
    assert set(WRAPPERS[rel]) <= plain_returns, (rel, plain_returns)
    source = path.read_text()
    assert 'device.type != "cuda"' in source and "raise ValueError" in source


def test_wrappers_take_meta_tensors_to_their_plain_versions():
    """Each kernel wrapper called on meta tensors returns meta results of
    the plain version's shape and dtype (and launches nothing)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.int8_matmul.ops import (fp8_matmul_decode,
                                                     int8_matmul,
                                                     w8a8_matmul_decode)
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_prefix_extend_attention)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.wkv6.ops import wkv6

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    before = launch_counts()
    i32 = torch.int32
    outs = {
        "flash": (flash_attention(meta(2, 16, 4, 8), meta(2, 16, 2, 8),
                                  meta(2, 16, 2, 8)), (2, 16, 4, 8)),
        "paged": (paged_attention(meta(2, 4, 8), meta(5, 16, 2, 8),
                                  meta(5, 16, 2, 8),
                                  meta(2, 2, dtype=i32),
                                  meta(2, dtype=i32)), (2, 4, 8)),
        "extend": (paged_prefix_extend_attention(
            meta(2, 3, 4, 8), meta(5, 16, 2, 8), meta(5, 16, 2, 8),
            meta(2, 2, dtype=i32), meta(2, dtype=i32), meta(2, 3, 2, 8),
            meta(2, 3, 2, 8), meta(2, dtype=i32)), (2, 3, 4, 8)),
        "int8": (int8_matmul(meta(4, 32, dtype=torch.int8),
                             meta(32, 16, dtype=torch.int8),
                             meta(4, dtype=torch.float32),
                             meta(16, dtype=torch.float32)), (4, 16)),
        "w8a8": (w8a8_matmul_decode(meta(4, 32),
                                    meta(32, 16, dtype=torch.int8),
                                    meta(16, dtype=torch.float32)),
                 (4, 16)),
        "fp8": (fp8_matmul_decode(meta(4, 32),
                                  meta(32, 16, dtype=torch.float8_e4m3fn),
                                  meta(16, dtype=torch.float32)), (4, 16)),
        "rmsnorm": (rmsnorm(meta(3, 64), meta(64)), (3, 64)),
        "wkv6": (wkv6(*(meta(1, 16, 2, 8) for _ in range(4)), meta(2, 8),
                      meta(1, 2, 8, 8, dtype=torch.float32))[0],
                 (1, 16, 2, 8)),
    }
    for name, (out, shape) in outs.items():
        assert out.device.type == "meta" and tuple(out.shape) == shape, name
    assert launch_counts() == before


def test_abstract_mesh_collectives_count_and_refuse_real_tensors():
    """On an abstract mesh a collective counts its kind and rank-local
    bytes and returns a meta result of its shape; a tensor that is not on
    meta raises (nothing moves between views)."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.sharding import collectives as coll
    mesh = abstract_mesh({"pod": 2, "data": 16, "model": 16},
                         {"pod": 1, "data": 3, "model": 5})
    assert mesh.rank == (1 * 16 + 3) * 16 + 5 and mesh.world == 512
    assert "abstract" in mesh.describe()
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    assert coll.all_gather(x, 1, mesh).shape == (4, 128)
    assert coll.all_reduce(x, "max", mesh, "data").shape == (4, 8)
    assert coll.ppermute(x, mesh, "pod").shape == (4, 8)
    assert mesh.stats.count_by_op == {"all-gather/model": 1,
                                      "all-reduce/data": 1,
                                      "collective-permute/pod": 1}
    assert set(mesh.stats.bytes_by_op.values()) == {64.0}
    for fn in (lambda t: coll.all_reduce(t, "sum", mesh),
               lambda t: coll.all_gather(t, 0, mesh),
               lambda t: coll.ppermute(t, mesh, "data")):
        with pytest.raises(ValueError, match="abstract mesh takes meta"):
            fn(torch.zeros(4, 8))


def test_chip_smoke_drives_the_cells_phase():
    """chip_smoke.py has a phase 27 that its main runs last: (a) the
    dry-run cells of llama3.2-1b on one rank (train_4k, prefill_32k,
    decode_32k over a contiguous and a paged cache) with their meta
    traces, (b) the context-parallel decode cell of qwen2-1.5b on four
    ranks against one rank, (c) a GPipe pipeline of two stages against
    one rank."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert "phase_cells" in main_calls
    assert main_calls.index("phase_cells") > \
        main_calls.index("phase_train_tp_peft")
    # the ranks' and the trace workers' functions are arguments of
    # spawn_world and of the pool, not calls
    reached, todo = set(), ["phase_cells", "_cp_rank", "_pipe_rank",
                            "_cell_trace"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("build_cell", "abstract_mesh", ".trace(",
                   "FlopCounterMode", "train_4k", "prefill_32k",
                   "decode_32k", "paged_pallas", "decode_attn_impl='cp'",
                   "spawn_world", "make_host_mesh(stage=",
                   "pipeline_forward", "CP_PREDICTED", "_reset_launches",
                   "_read_launches", "_swap_plain", "scaled_dot_product",
                   "max_memory_allocated", "isfinite"):
        assert needle in body, needle
    for tag in ("[27 cells] (a)", "[27 cells] (b)", "[27 cells] (c)"):
        assert tag in text, tag


def test_chip_smoke_drives_the_whole_heads_phase():
    """chip_smoke.py has a phase 28 that runs on phase 27 (b)'s four
    ranks and weights: (a) the prefill cell of qwen2-1.5b (kv heads the
    axis does not divide) with its launches, held kernel calls and
    collectives against a prediction, logits against one rank's; (b) the
    train cell's steps against one rank's losses and the float32
    gradient gathered whole against one rank's."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    reached, todo = set(), ["phase_cells", "_cp_rank"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    assert {"_whole_rank", "_whole_one_rank", "_whole_check",
            "_wh_kernel_row", "_wh_held"} <= reached
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("_wh_shape('prefill')", "_wh_shape('train')",
                   "WH_PREDICTED", "WH_LAUNCHES", "sharded_grads",
                   "gather_leaf", "loss_and_grads", "attention_ref",
                   "rmsnorm_ref", "init_adamw", "max_memory_allocated"):
        assert needle in body, needle
    for tag in ("[28 whole_heads] (a)", "[28 whole_heads] (b)"):
        assert tag in text, tag


def test_chip_smoke_drives_the_ssm_tp_phase():
    """chip_smoke.py has a phase 29 that runs on phase 27 (b)'s four
    ranks after phase 28: (a) rwkv6-1.6b's prefill and decode cells over
    the rank's heads, every B8 call held, launches and collectives against
    a prediction, logits against one rank's (and its witness of
    rounding), float32 states; (b) the train cell against one rank's
    losses and the float32 gradient gathered whole against one rank's
    within its summation-order floor; (c) jamba's Mamba mixer over the
    rank's channels against one rank's, with its collectives; and B8's
    row at a rank's shape."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    reached, todo = set(), ["phase_cells", "_cp_rank"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    assert {"_ssm_rank", "_ssm_one_rank", "_ssm_check", "_ssm_serve",
            "_ssm_grads", "_mix_rank", "_ssm_kernel_row", "_wh_train",
            "_wkv6_calls_vs_plain", "_as_one_rank"} <= reached
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("_ssm_shape('prefill')", "_ssm_shape('decode')",
                   "SSM_PREDICTED", "SSM_LAUNCHES", "MIX_PREDICTED",
                   "wkv6_chunked_ref", "sharded_grads", "gather_leaf",
                   "loss_and_grads", "mamba_forward", "mamba_decode",
                   "tensor_parallel", "init_mamba_state", "_check_rms"):
        assert needle in body, needle
    for tag in ("[29 ssm_tp] (a)", "[29 ssm_tp] (b)", "[29 ssm_tp] (c)"):
        assert tag in text, tag


def test_model_axis_gather_counts_its_reduce_scatter():
    """The whole-heads arm's gather over the model axis is counted by the
    collective layer: an all-gather forward, and its backward one
    reduce-scatter of the whole gradient (on an abstract mesh, meta
    tensors under autograd)."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.sharding.collectives import gather_from
    mesh = abstract_mesh({"model": 4})
    x = torch.empty((2, 8), device="meta", requires_grad=True)
    y = gather_from(x, 1, mesh)
    assert y.shape == (2, 32)
    y.sum().backward()
    assert x.grad.shape == (2, 8)
    assert mesh.stats.count_by_op == {"all-gather/model": 1,
                                      "reduce-scatter/model": 1}
    assert mesh.stats.bytes_by_op == {"all-gather/model": 64.0,
                                      "reduce-scatter/model": 256.0}


def test_whole_heads_modules_import_neither_jax_nor_the_reference():
    """The modules of the whole-heads arm and its test drive import
    neither ``jax`` nor ``repro``."""
    for rel in ("src/repro_torch/models/attention.py",
                "src/repro_torch/models/transformer.py",
                "src/repro_torch/sharding/tp.py",
                "src/repro_torch/sharding/collectives.py",
                "src/repro_torch/launch/steps.py",
                "tests/_whole_heads_arms.py"):
        assert not set(_imported_roots(ROOT / rel)) & FORBIDDEN, rel


def test_ssm_tp_modules_import_neither_jax_nor_the_reference():
    """The modules of the RWKV-6 / Mamba split and its test drive import
    neither ``jax`` nor ``repro``."""
    for rel in ("src/repro_torch/models/ssm.py",
                "src/repro_torch/models/layers.py",
                "tests/_ssm_tp_arms.py"):
        assert not set(_imported_roots(ROOT / rel)) & FORBIDDEN, rel


def test_chip_smoke_drives_the_clock_phase():
    """chip_smoke.py has a phase 30 inside phase 23's ranks
    (``_tp_rank``): rank 1's host clock skewed, (a) the SchedEngine at
    full width under EDF with admission control, the ladder and
    deadlines, open loop, with its launches and the shared clock's
    readings by site; (b) the n-gram SpecEngine under EDF with
    ``spec_slack_s`` and chaos; (c) a float32 drive with chaos that one
    rank replays on rank 0's readings."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def reach(*roots):
        reached, todo = set(), list(roots)
        while todo:
            name = todo.pop()
            reached.add(name)
            todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                     if isinstance(c, ast.Call)
                     and ast.unparse(c.func) in funcs
                     and ast.unparse(c.func) not in reached]
        return reached
    line = {ast.unparse(c.func): c.lineno
            for c in ast.walk(funcs["_tp_rank"]) if isinstance(c, ast.Call)}
    assert {"_clk_rank", "_clk_f32"} <= set(line)
    # after phase 23 (c), before (e)
    assert line["_tp_sched_drive"] < line["_clk_rank"] < line[
        "_read_launches"]
    assert {"_clk_replay", "_clk_check"} <= reach("phase_tp")
    reached = reach("_tp_rank")
    assert {"_clk_clock", "_clk_sched", "_clk_open_loop", "_clk_spec"} \
        <= reached
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(
        reached | reach("phase_tp")))
    for needle in ("CLK_SKEW_S", "CLK_SKEW_RATE", "rank == 0",
                   "host_clock", "run_open_loop", "policy='edf'",
                   "admission_control=True", "ladder=True", "max_request_s",
                   "spec_slack_s", "CLK_SPEC_CHAOS", "CLK_F32_CHAOS",
                   "broadcast/clock", "_reset_launches", "_read_launches",
                   "TP_F32_LAYERS", "edf_reorder", "admission_drop",
                   "rung_above_0", "timeout_or_preemption"):
        assert needle in body, needle
    for tag in ("[30 clock] (a)", "[30 clock] (b)", "[30 clock] (c)"):
        assert tag in text, tag


def test_the_wall_clock_refusal_is_gone():
    """No sharded engine refuses a decision that reads the clock: the
    refusal's helper ``same_decisions`` and its label ``A87`` are gone
    from the port and from ``chip_smoke.py``."""
    for f in _port_files():
        text = f.read_text()
        for word in ("same_decisions", "A87", "A8.7"):
            assert word not in text, (str(f.relative_to(ROOT)), word)
    from repro_torch.serve import engine
    from repro_torch.sharding import tp
    assert not hasattr(engine, "same_decisions") and not hasattr(tp, "A87")
    assert callable(engine.shared_clock) and callable(engine.host_clock)


def test_clock_modules_import_neither_jax_nor_the_reference():
    """The modules of the shared clock and its test drive import neither
    ``jax`` nor ``repro``."""
    for rel in ("src/repro_torch/serve/engine.py",
                "src/repro_torch/sched/scheduler.py",
                "src/repro_torch/spec/engine.py",
                "src/repro_torch/sharding/collectives.py",
                "src/repro_torch/launch/mesh.py",
                "src/repro_torch/launch/serve.py",
                "tests/_host_decision_arms.py"):
        assert not set(_imported_roots(ROOT / rel)) & FORBIDDEN, rel


def test_chip_smoke_drives_the_spec_path():
    """chip_smoke.py has a speculative-decoding phase that its main runs:
    it serves through the port's SpecEngine (n-gram and draft arms), holds
    a verify round's logits to the plain versions and the float32 streams
    to the plain scheduler's, and checks B2's launches on verify rounds."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "phase_spec" in funcs
    main_calls = {ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)}
    assert "phase_spec" in main_calls
    # the phase and the helpers it calls
    called = {ast.unparse(c.func) for c in ast.walk(funcs["phase_spec"])
              if isinstance(c, ast.Call)}
    body = "\n".join(ast.unparse(funcs[n]) for n in
                     sorted(called & set(funcs)) + ["phase_spec"])
    for needle in ("SpecEngine", "spec='ngram'", "spec='draft'",
                   "draft_config_of", "verify_paged", "_swap_plain",
                   "_attention_calls_vs_plain", "paged_prefix_extend",
                   "acceptance_rate"):
        assert needle in body, needle
    assert "[14 spec]" in text


def test_chip_smoke_drives_the_eager_and_resil_paths():
    """chip_smoke.py has an eager phase and a resilience phase that its
    main runs: the first serves through the port's Engine (bf16, int8 and
    fp8 contiguous caches, a windowed config, logits against chunked
    attention on the plain side, streams equal to the PagedEngine's), the
    second through the resilient SchedEngine and SpecEngine under chaos."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = {ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)}
    assert {"phase_eager", "phase_resil"} <= main_calls
    for phase, needles in (
            ("phase_eager", ("Engine", "PagedEngine", "kv_cache_dtype",
                             "window", "chunked", "_swap_plain",
                             "_reset_launches", "sync_count")),
            ("phase_resil", ("SchedEngine", "SpecEngine", "FaultInjector",
                             "ladder", "max_request_s", "retry_after_s",
                             "timed_out", "_reset_launches"))):
        called = {ast.unparse(c.func) for c in ast.walk(funcs[phase])
                  if isinstance(c, ast.Call)}
        body = "\n".join(ast.unparse(funcs[n]) for n in
                         sorted(called & set(funcs)) + [phase])
        for needle in needles:
            assert needle in body, (phase, needle)
    assert "[15 eager]" in text and "[16 resil]" in text


def test_port_carries_no_tpu_constant():
    """The port prices on its own H100 tier: no file of the port or
    chip_smoke.py names a TPU tier or the reference's TPU peaks."""
    bad = {}
    for f in _port_files():
        text = f.read_text()
        hits = [w for w in ("v5e", "197e12", "394e12", "819e9",
                            "16 * 2**30", "mesh.HW", "ici_bw_per_link")
                if w in text]
        if hits:
            bad[str(f.relative_to(ROOT))] = hits
    assert not bad


def test_profiler_records_read_only_host_values():
    """Every ``DispatchProfiler.record`` call of the engines passes host
    numbers only: no argument reads the device (``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``), so profiling adds no sync."""
    calls = 0
    for rel in ("serve/engine.py", "sched/scheduler.py", "spec/engine.py"):
        tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    ast.unparse(node.func) == "prof.record":
                calls += 1
                args = " ".join(ast.unparse(a) for a in
                                node.args + [k.value for k in node.keywords])
                for bad in (".item(", ".cpu(", ".tolist(", ".numpy("):
                    assert bad not in args, (rel, args)
    # eager admit / decode, paged admit / decode, chunk, draft, verify
    assert calls == 7


def test_chip_smoke_drives_the_cost_phase():
    """chip_smoke.py has a cost-model phase that its main runs last: SJF
    with the profiler on and off (equal streams, syncs and launches), EDF
    with admission control, and the serving CLI with the profiler, the
    calibration and the metrics files."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert "phase_cost" in main_calls
    called = {ast.unparse(c.func) for c in ast.walk(funcs["phase_cost"])
              if isinstance(c, ast.Call)}
    body = "\n".join(ast.unparse(funcs[n]) for n in
                     sorted(called & set(funcs)) + ["phase_cost"])
    for needle in ("DispatchProfiler", "'sjf'", "'edf'",
                   "admission_control", "slo_rejected", "fit_profile",
                   "dispatch_estimate", "DISPATCH_KINDS", "_reset_launches",
                   "repro_torch.launch.serve", "--calibration-in",
                   "--calibration-out", "--profile", "--metrics",
                   "--trace-out", "--arrival-rate",
                   "profile_dispatch_seconds_total",
                   "costmodel_drift_ratio"):
        assert needle in body, needle
    assert "[17 cost]" in text


def test_chip_smoke_names_every_ported_kernel():
    """chip_smoke.py's kernel records name all eight ported kernels, each
    with the TPU kernel it replaces and its source in the repository."""
    text = (ROOT / "chip_smoke.py").read_text()
    for name, src, tpu in (
            ("paged_attention", "csrc/paged_attention.cu",
             "paged_attention.py:270"),
            ("paged_prefix_extend", "csrc/paged_prefix_extend.cu",
             "paged_attention.py:209"),
            ("flash_attention", "csrc/flash_attention.cu",
             "flash_attention.py:94"),
            ("int8_matmul", "csrc/int8_matmul.cu", "int8_matmul.py:68"),
            ("w8a8_decode_matmul", "csrc/w8a8_decode.cu",
             "int8_matmul.py:186"),
            ("fp8_decode_matmul", "csrc/fp8_decode.cu",
             "int8_matmul.py:248"),
            ("wkv6", "csrc/wkv6.cu", "wkv6/wkv6.py:70"),
            ("rmsnorm", "csrc/rmsnorm.cu", "rmsnorm/rmsnorm.py:24")):
        assert f'"{name}"' in text, name
        assert src in text and tpu in text, name
        assert (ROOT / "src" / "repro_torch" / src).is_file(), src


def _with_includes(path: Path) -> str:
    """A CUDA source and, recursively, the local headers it includes."""
    text = path.read_text()
    for inc in re.findall(r'#include "([^"]+)"', text):
        text += _with_includes(path.parent / inc)
    return text


@pytest.mark.parametrize("src", ["flash_attention.cu",
                                 "paged_prefix_extend.cu"])
def test_attention_kernels_use_tensor_cores_and_async_copies(src):
    """B3 and B2 (with the headers they include) run a tensor-core product
    and fill their tiles with asynchronous copies."""
    text = _with_includes(ROOT / "src" / "repro_torch" / "csrc" / src)
    assert ("wgmma.mma_async" in text
            or "mma.sync.aligned.m16n8k16" in text), src
    assert "cp.async" in text, src


@pytest.mark.parametrize("src", ["paged_attention.cu", "fp8_decode.cu"])
def test_decode_kernels_use_tensor_cores_and_async_copies(src):
    """B1 and B6 (with the headers they include) run a tensor-core
    product and fill their rings with asynchronous copies."""
    text = _with_includes(ROOT / "src" / "repro_torch" / "csrc" / src)
    assert "mma.sync.aligned.m16n8k16" in text, src
    assert "cp.async" in text, src


def test_tiled_w8a8_runs_wgmma_from_an_async_ring():
    """B4's tensor-core step runs Hopper's warpgroup product on s8
    operands, its tiles landing by asynchronous copies."""
    text = _with_includes(ROOT / "src" / "repro_torch" / "csrc" /
                          "int8_matmul.cu")
    assert re.search(r"wgmma\.mma_async[\w.]*\.s8", text)
    assert "cp.async" in text
    assert "mbarrier" in text


def test_w8a8_decode_runs_int8_mma_from_an_async_ring_in_a_cluster():
    """B5's tensor-core step (with the headers it includes) runs int8
    mma.sync m16n8k32 products, fills its ring with asynchronous copies
    and combines its k-ranges across a thread block cluster."""
    text = _with_includes(ROOT / "src" / "repro_torch" / "csrc" /
                          "w8a8_decode.cu")
    assert re.search(r"mma\.sync\.aligned\.m16n8k32[\w.]*\.s8", text)
    assert "cp.async" in text
    assert "this_cluster()" in text and "map_shared_rank" in text
    assert re.search(r"(cl|cluster)\.sync\(\)", text)


def test_rmsnorm_has_a_warp_per_row_step_reduced_by_shuffles():
    """B7 has a warp-per-row register step (``warp_step::rmsnorm_warp``)
    whose reduction is a warp shuffle, with no block barrier in it."""
    text = (ROOT / "src" / "repro_torch" / "csrc" / "rmsnorm.cu").read_text()
    start = text.index("namespace warp_step {")
    body = text[start:text.index("}  // namespace warp_step")]
    assert "rmsnorm_warp(" in body and "__shfl_xor_sync" in body
    assert "__syncthreads" not in body and "atomic" not in body


def test_wkv6_runs_its_products_on_the_tensor_cores():
    """B8 runs its products as tensor-core mma (not fp32 FMAs alone)."""
    text = _with_includes(ROOT / "src" / "repro_torch" / "csrc" / "wkv6.cu")
    assert re.search(r"mma\.sync\.aligned\.m16n8k(8|16)", text) or \
        "wgmma.mma_async" in text
    assert "cp.async" in text


def test_paged_decode_takes_any_group():
    """Neither B1's source nor its wrapper caps the query heads a kv head
    serves: the kernel cuts any group into row groups."""
    cu = (ROOT / "src" / "repro_torch" / "csrc" /
          "paged_attention.cu").read_text()
    ops = (ROOT / "src" / "repro_torch" / "kernels" / "paged_attention" /
           "ops.py").read_text()
    assert "kMaxG" not in cu and "_MAX_GROUP" not in ops
    assert not re.search(r"h\s*//\s*kh\s*<=", ops)
    assert not re.search(r"H\s*/\s*KH\s*>", cu)


def test_port_calls_no_library_attention():
    """No module or CUDA source of the port calls PyTorch's fused
    attention: SDPA is only chip_smoke.py's yardstick."""
    pkg = ROOT / "src" / "repro_torch"
    files = [f for f in pkg.rglob("*")
             if f.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 20
    assert not [str(f.relative_to(ROOT)) for f in files
                if "scaled_dot_product_attention" in f.read_text()]


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a GPU and without device='cpu', LM, the engines (through
    their LM) and launch.serve raise instead of running on the CPU,
    the eager Engine's path without --paged included."""
    from repro_torch.launch.serve import main
    from repro_torch.models.model import LM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(tconfigs.get_smoke_config("rwkv6-1.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--paged", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--policy", "fcfs", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "rwkv6-1.6b", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--spec", "ngram", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--requests", "1"])
    lm = LM(cfg, device="cpu")            # an explicit request is honoured
    assert lm.device.type == "cpu"


def test_launch_serve_requires_paged(capsys):
    """An attention arch without --paged, --policy or --spec serves
    through the eager Engine over a contiguous cache (bf16 and int8);
    the chaos flags still need a paged or scheduler engine."""
    from repro_torch.launch.serve import main
    for extra in ([], ["--kv-dtype", "int8"]):
        assert main(["--smoke", "--device", "cpu", "--requests", "3",
                     "--prompt-len", "20", "--max-new", "4"] + extra) == 0
        out = capsys.readouterr().out
        assert "eager" in out and "3 requests, 12 tokens" in out
        assert "'ok': 3" in out
    with pytest.raises(SystemExit):
        main(["--smoke", "--device", "cpu", "--chaos", "fault=0.1"])
    with pytest.raises(SystemExit):
        main(["--smoke", "--device", "cpu", "--paged", "--degrade"])


def test_engine_refuses_non_attention_decoders():
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import PagedEngine
    cfg = tconfigs.get_smoke_config("qwen2-1.5b")
    lm = LM(cfg.with_(attention=dataclasses.replace(cfg.attention,
                                                    window=8)), device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        PagedEngine(lm, {}, n_slots=1, max_len=16)


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS)
                         + sorted(tconfigs.PAPER_MODELS))
def test_copied_configs_agree_with_reference(arch):
    """Every field of the port's config equals the reference's; the
    attention, MoE, SSM and encoder sub-configs (each a class of its own
    side) field by field, either may be None.  The ten assigned archs at
    full and smoke width, the paper's six models (full width only, on
    both sides)."""
    getters = ("get_config", "get_smoke_config") \
        if arch in tconfigs.ARCH_IDS else ("get_config",)
    for getter in getters:
        t = getattr(tconfigs, getter)(arch)
        j = getattr(jconfigs, getter)(arch)
        for f in dataclasses.fields(t):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if f.name in ("attention", "moe", "ssm", "encoder") \
                    and tv is not None:
                assert jv is not None, (arch, f.name)
                for g in dataclasses.fields(tv):
                    assert getattr(tv, g.name) == getattr(jv, g.name), \
                        (arch, f.name, g.name)
            else:
                assert tv == jv, (arch, f.name)
        assert t.padded_vocab == j.padded_vocab
        assert t.num_groups == j.num_groups
        if t.attention is not None:
            assert t.attention.heads_padded == j.attention.heads_padded
        if t.moe is not None:
            assert t.moe.padded_experts == j.moe.padded_experts
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch,served", [
    ("granite-moe-3b-a800m", True), ("llama4-scout-17b-a16e", True),
    ("jamba-1.5-large-398b", True), ("whisper-base", False),
    ("llama-3.2-vision-11b", False), ("mixtral-8x7b", True),
    ("llava-1.5-7b", False), ("qwen2-1.5b-mla", True)])
def test_engines_refuse_unported_blocks_naming_a6(arch, served):
    """(Kept name: Mamba configs were refused, naming A6.3, before the
    Mamba mixer was ported.)  jamba's hybrid groups build, give finite
    logits and are served by the eager ``Engine``; ``PagedEngine`` (so
    the scheduler and ``SpecEngine`` too) refuses them with a message,
    as the reference's asserts; a block kind that exists in neither
    package is refused.  The encoder and cross-attention configs (whisper-base,
    llama-3.2-vision-11b, llava-1.5-7b) build and give finite logits with
    a ``modality_input``, and both engines refuse them with a message,
    as the reference's do.  The MoE configs are served: ``LM.init`` builds
    them, their logits are finite, and ``Engine`` and (without a window)
    ``PagedEngine`` take them.  The search's MLA arm on qwen2-1.5b is
    served by ``Engine`` and refused by ``PagedEngine``."""
    from repro_torch.configs.specs import modality_spec
    from repro_torch.core.apply import apply_efficiency_config
    from repro_torch.core.space import (ArchChoice, EfficiencyConfig,
                                        FtChoice, InfChoice)
    from repro_torch.models.model import LM
    from repro_torch.models.transformer import block_kinds
    from repro_torch.serve.engine import Engine, PagedEngine
    if arch == "qwen2-1.5b-mla":
        cfg = apply_efficiency_config(
            tconfigs.get_smoke_config("qwen2-1.5b"),
            EfficiencyConfig(ArchChoice("mla", 0, 1), FtChoice("full", 0, 1),
                             InfChoice("bf16", "none", "full")))
    elif arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_smoke_config(arch)
    else:
        cfg = tconfigs.get_config(arch).with_(num_layers=4, d_model=64,
                                              d_ff=128, vocab_size=512)
    if cfg.moe is not None and arch not in tconfigs.ARCH_IDS:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, d_ff=128))
    if cfg.family == "vlm" and arch not in tconfigs.ARCH_IDS:
        cfg = cfg.with_(num_image_tokens=8, attention=dataclasses.replace(
            cfg.attention, num_heads=4, num_kv_heads=4, head_dim=16))
    lm = LM(cfg, device="cpu")
    if served:
        params = lm.init(0)
        if cfg.moe is not None:
            kinds = block_kinds(cfg)
            assert all(("moe" in blk) == k["moe"] for group in params["layers"]
                       for blk, k in zip(group.values(), kinds))
        assert torch.isfinite(lm.logits(params, torch.arange(6)[None])).all()
        Engine(lm, params, n_slots=1, max_len=16)
        if cfg.attention.kind == "mla":
            with pytest.raises(ValueError, match="MLA"):
                PagedEngine(lm, params, n_slots=1, max_len=16)
        elif "mamba" in cfg.block_pattern:
            with pytest.raises(ValueError, match="Mamba"):
                PagedEngine(lm, params, n_slots=1, max_len=16)
            bad = cfg.with_(block_pattern=("mamba", "retnet"))
            with pytest.raises(NotImplementedError, match="retnet"):
                LM(bad, device="cpu").init(0)
        elif cfg.attention.window is None:
            PagedEngine(lm, params, n_slots=1, max_len=16)
        return
    spec = modality_spec(cfg, 1)
    params = lm.init(0)
    src = torch.randn(spec.shape).to(spec.dtype)
    assert torch.isfinite(lm.logits(params, torch.arange(6)[None],
                                    modality_input=src)).all()
    with pytest.raises(ValueError, match="modality_input"):
        Engine(lm, params, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="cross-attention"):
        PagedEngine(lm, params, n_slots=1, max_len=16)


def test_chip_smoke_drives_the_search_phase():
    """chip_smoke.py has a search → serve phase that its main runs after
    the cost phase: the port's AutoTuner at h100-1 on the whole space
    (the attention arms too: an MLA c* goes through the eager Engine),
    recalibrated from the cost phase's profiled drive, then Default and
    the recommended configuration served with their weights quantized by
    apply_to_params, each checked for full streams, freed pages and
    launches that match the dispatches."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert "phase_search" in main_calls
    assert main_calls.index("phase_search") > main_calls.index("phase_cost")
    # the phase and every helper it reaches
    reached, todo = set(), ["phase_search"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    assert "moe_arms=False" not in body      # the MoE arms are served
    assert "attention_arms=False" not in body    # and the attention arms
    for needle in ("AutoTuner", "h100-1", "SpaceMask()", "Engine(",
                   "_search_eager_drive",
                   "recommend_efficient", "recalibrate",
                   "CalibratedCostModel", "apply_efficiency_config",
                   "apply_to_params", "SchedEngine", "SpecEngine",
                   "layout='paged'", "_reset_launches", "max_memory_allocated",
                   "n_pages"):
        assert needle in body, needle
    assert "[18 search]" in text


def test_chip_smoke_drives_the_moe_phase():
    """chip_smoke.py has a MoE phase that its main runs after the search
    phase: granite-moe-3b-a800m at full width through the scheduler, the
    paged engine with int8 weights and the n-gram SpecEngine,
    llama4-scout-17b-a16e at 8 layers through the eager Engine past its
    window, deepseek-coder-33b at full depth with int8 weights built a
    group at a time through the paged engine (its kernel shapes held
    first), and moe_apply on the card against the CPU, each arm checked
    for full streams, freed pages and launches derived from the
    config."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert "phase_moe" in main_calls
    assert main_calls.index("phase_moe") > main_calls.index("phase_search")
    reached, todo = set(), ["phase_moe"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("granite-moe-3b-a800m", "llama4-scout-17b-a16e",
                   "deepseek-coder-33b", "SchedEngine", "PagedEngine",
                   "SpecEngine", "Engine(", "init_group", "quantize_tree",
                   "moe_apply", "'gather'", "_reset_launches",
                   "max_memory_allocated", "n_pages", "isfinite"):
        assert needle in body, needle
    assert "[19 moe]" in text


def test_chip_smoke_drives_the_train_phase():
    """chip_smoke.py has a training phase that its main runs after the MoE
    phase: the training CLI for llama3.2-1b at full width with
    checkpoints, gradients on the card against the CPU and every leaf's
    gradient at full width, LoRA / QLoRA / DoRA at full width with frozen
    leaves held, the resume from the CLI's checkpoint, the LoRA model
    served merged and unmerged through PagedEngine, granite-moe and
    rwkv6 training, and the proxy evaluator; every training arm holds
    the eight kernels' counters at 0."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert "phase_train" in main_calls
    assert main_calls.index("phase_train") > main_calls.index("phase_moe")
    reached, todo = set(), ["phase_train"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("train_cli.main", "'--ckpt-dir'", "loss_and_grads",
                   "allow_unused=True", "apply_to_params", "count_trainable",
                   "init_or_resume", "merge_lora", "PagedEngine",
                   "rwkv6-1.6b", "mode='proxy'", "_no_launches",
                   "_reset_launches", "max_memory_allocated"):
        assert needle in body, needle
    assert "PEFT_METHODS" in body
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id == "PEFT_METHODS"}
    assert set(consts["PEFT_METHODS"]) == {"lora", "qlora", "dora"}
    assert "[20 train]" in text


def test_chip_smoke_drives_the_encdec_phase():
    """chip_smoke.py has a phase 21 that its main runs after the training
    phase: B3 without a causal mask held element by element at whisper's
    and the vision model's shapes and timed beside SDPA; whisper-base and
    llama-3.2-vision-11b at full width and depth through
    LM.prefill(modality_input=) and decode_step with launches from the
    config; qwen2-1.5b's MLA arm through the eager Engine in bf16 and
    int8; and calibration (capture, SmoothQuant, AWQ, the calibrated int8
    model served, GPTQ timed)."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert "phase_encdec" in main_calls
    assert main_calls.index("phase_encdec") > main_calls.index("phase_train")
    reached, todo = set(), ["phase_encdec"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("causal=False", "attention_ref", "scaled_dot_product",
                   "modality_input=src", "decode_step", "modality_spec",
                   "'mla'", "Engine(", "collect_linear_inputs",
                   "smoothquant_scales", "awq_search_scales",
                   "gptq_quantize_matrix", "calib=", "kv_bytes_per_token",
                   "_reset_launches", "_read_launches", "_swap_plain",
                   "max_memory_allocated", "isfinite"):
        assert needle in body, needle
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in ("WHISPER", "VISION")}
    assert consts == {"WHISPER": "whisper-base",
                      "VISION": "llama-3.2-vision-11b"}
    assert "[21 encdec]" in text


def test_chip_smoke_drives_the_jamba_phase():
    """chip_smoke.py has a phase 22 that its main runs after the encoder
    phase: B3 / B4 / B5 / B7 held and timed at jamba's shapes; one Mamba
    layer's scan against the sequential recurrence; the smoke jamba's
    gradients card vs CPU; jamba-1.5-large-398b's first five layers at
    full width through the eager Engine in bf16 and int8, with every
    B4 / B5 call of an admission and a decode step held to its plain
    version."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert "phase_jamba" in main_calls
    assert main_calls.index("phase_jamba") > main_calls.index("phase_encdec")
    reached, todo = set(), ["phase_jamba"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(c.func) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call) and ast.unparse(c.func) in funcs
                 and ast.unparse(c.func) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("mamba_scan_ref", "mamba_scan(", "mamba_forward",
                   "mamba_decode", "first_layers", "Engine(",
                   "quantize_tree", "int8_matmul_ref", "w8a8_decode_ref",
                   "attention_ref", "rmsnorm_ref", "scaled_dot_product",
                   "_int_mm", "F.rms_norm", "_reset_launches",
                   "_read_launches", "_swap_plain", "loss_and_grads",
                   "max_memory_allocated", "isfinite"):
        assert needle in body, needle
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in ("JAMBA",
                                                      "JAMBA_LAYERS")}
    assert consts == {"JAMBA": "jamba-1.5-large-398b", "JAMBA_LAYERS": 5}
    assert "[22 jamba]" in text
