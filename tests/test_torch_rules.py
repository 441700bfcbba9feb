"""Rules of the port: it imports nothing of JAX or of the reference
package, its entry points never fall back to the CPU on their own, and
its copied configs agree with the reference's."""
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


def test_scan_covers_the_scheduler_and_every_kernel_module():
    """The import rule above reaches the scheduler, the quantization
    modules, the RWKV-6 mixer and every kernel wrapper."""
    scanned = {str(f.relative_to(ROOT)) for f in _port_files()}
    for rel in ("sched/__init__.py", "sched/policy.py", "sched/prefix.py",
                "sched/scheduler.py", "kernels/paged_attention/ops.py",
                "kernels/paged_attention/ref.py", "kernels/build.py",
                "quant/__init__.py", "quant/qops.py",
                "kernels/int8_matmul/ops.py", "kernels/int8_matmul/ref.py",
                "kvcache/quant.py", "models/ssm.py",
                "kernels/wkv6/__init__.py", "kernels/wkv6/ops.py",
                "kernels/wkv6/ref.py", "kernels/rmsnorm/__init__.py",
                "kernels/rmsnorm/ops.py", "kernels/rmsnorm/ref.py",
                "configs/rwkv6_1_6b.py", "spec/__init__.py",
                "spec/engine.py", "spec/drafter.py", "spec/controller.py",
                "spec/rollback.py", "core/costmodel.py",
                "resil/__init__.py", "resil/errors.py", "resil/inject.py",
                "resil/degrade.py", "serve/engine.py", "kvcache/cache.py",
                "models/attention.py"):
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
    """Every kernel wrapper picks its plain version only on a CPU tensor's
    device (an ``if <tensor>.device.type == "cpu"`` branch), raises for
    any other device than CUDA, and has no ``try`` anywhere: a failed
    build or launch on the card raises instead of falling back."""
    path = ROOT / "src" / "repro_torch" / rel
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel
    plain_returns = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        test = ast.unparse(node.test)
        if test.endswith('.device.type == "cpu"') or \
                test.endswith(".device.type == 'cpu'"):
            for stmt in node.body:
                if isinstance(stmt, ast.Return) and \
                        isinstance(stmt.value, ast.Call):
                    plain_returns.add(ast.unparse(stmt.value.func))
    assert set(WRAPPERS[rel]) <= plain_returns, (rel, plain_returns)
    source = path.read_text()
    assert 'device.type != "cuda"' in source and "raise ValueError" in source


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


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS))
def test_copied_configs_agree_with_reference(arch):
    """Every field of the port's config equals the reference's; the
    attention and SSM sub-configs field by field (either may be None)."""
    for getter in ("get_config", "get_smoke_config"):
        t = getattr(tconfigs, getter)(arch)
        j = getattr(jconfigs, getter)(arch)
        for f in dataclasses.fields(t):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if f.name in ("attention", "ssm") and tv is not None:
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
