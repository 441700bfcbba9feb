"""Tensor-parallel serving of the port over gloo worlds on the CPU: the
reference's sharded-serving identities (``tests/test_sharded_serving.py``
:168-250, which skip on a single device) held on every run.

A 2-rank world and a 4-rank world are started once for the module; each
rank serves every arm (``_sharded_arms.py``) under its mesh, and the test
process serves the same arms on one rank.  Greedy streams, host syncs and
engine counters must equal the single rank's, every rank's streams must
be equal, the float32 arm must equal JAX's single-device ``PagedEngine``,
and the kv-head-sharded attention must move at least 4x fewer
all-gather bytes a decode step than the gather baseline."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _sharded_arms as arms  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve.engine import PagedEngine as JPaged  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn_world  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

#: arms of the 2-rank world: the three engines on bf16 and int8 pools,
#: fp8 pools, int8 fused weights, float32 (held to JAX), the gather
#: baseline and self-speculation with the draft LM sharded too
ARMS2 = {f"{eng}-{kv}": {"engine": eng, "cfg": {"kv_cache_dtype": kv}}
         for eng in arms.ENGINES for kv in ("bfloat16", "int8")}
ARMS2.update({
    "paged-fp8": {"engine": "paged", "cfg": {"kv_cache_dtype": "fp8"}},
    "paged-int8-weights": {"engine": "paged", "quant": "int8",
                           "cfg": {"quant": "int8",
                                   "quant_matmul_impl": "fused"}},
    "paged-gather": {"engine": "paged", "cfg": {"tp_attn_impl": "gather"}},
    "spec-self-draft": {"engine": "spec", "draft": "self"},
})
#: arms of the 4-rank world (8 heads over 4 kv heads)
ARMS4 = {f"{eng}-widened": {"engine": eng, "widened": True}
         for eng in arms.ENGINES}


def _jax_f32_paged(jcfg, jparams) -> dict:
    """JAX's single-device PagedEngine streams and syncs."""
    eng = JPaged(JLM(jcfg), jparams, n_slots=2, max_len=64, seed=0,
                 page_size=8, decode_block=4)
    ids = [eng.submit(p, max_new_tokens=8)
           for p in arms.prompts(jcfg.vocab_size)]
    done = eng.run_to_completion()
    return {"streams": [list(done[i].out_tokens) for i in ids],
            "syncs": eng.sync_count}


@pytest.fixture(scope="module")
def runs():
    """Both worlds, started together in the background, while this
    process serves JAX's float32 arm (on JAX's weights, which the ranks
    and the port's single rank load as numpy) and every arm on one
    rank."""
    from concurrent.futures import ThreadPoolExecutor
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    arms2 = dict(ARMS2, **{"paged-f32": {
        "engine": "paged", "cfg": {"dtype": "float32"},
        "weights": jax.tree.map(np.asarray, jparams)}})
    with ThreadPoolExecutor(3) as pool:
        w2 = pool.submit(spawn_world, arms.world_arms, 2, arms2, 2,
                         device="cpu", threads=1)
        w4 = pool.submit(spawn_world, arms.world_arms, 4, ARMS4, 4,
                         device="cpu", threads=1)
        cli = pool.submit(_cli_runs)
        jax_f32 = _jax_f32_paged(jcfg, jparams)
        single = {name: arms.drive(arm)
                  for name, arm in dict(arms2, **ARMS4).items()}
        return {"world2": w2.result(), "world4": w4.result(),
                "cli": cli.result(), "single": single, "jax_f32": jax_f32}


#: the serving CLI's drive: ``--paged`` on one rank, then two ranks
CLI = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--requests",
       "3", "--max-new", "5"]


def _cli_runs() -> list:
    """(exit code, stdout) of ``launch.serve`` with ``--paged`` and with
    ``--model-parallel 2`` (nothing else in this process prints while
    they run)."""
    import contextlib
    import io
    from repro_torch.launch.serve import main
    out = []
    for extra in (["--paged"], ["--model-parallel", "2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(CLI + extra)
        out.append((rc, buf.getvalue()))
    return out


def _same_as_single(ranks, single, name):
    base = single[name]
    assert all(len(s) == 8 for s in base["streams"])
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["streams"] == base["streams"], (name, r)
        assert got["syncs"] == base["syncs"], (name, r)
        assert got["counters"] == base["counters"], (name, r)


@pytest.mark.parametrize("name", sorted(ARMS2))
def test_two_ranks_equal_one_rank(runs, name):
    """2-rank greedy streams, host syncs and engine counters equal the
    single rank's, on every rank (so every rank's streams are equal)."""
    _same_as_single(runs["world2"], runs["single"], name)


@pytest.mark.parametrize("name", sorted(ARMS4))
def test_four_ranks_equal_one_rank_on_widened_smoke(runs, name):
    _same_as_single(runs["world4"], runs["single"], name)
    assert runs["world4"][0]["_mesh"]["shape"] == {"data": 1, "model": 4}


def test_two_rank_float32_paged_equals_jax(runs):
    """The float32 arm's 2-rank streams equal JAX's single-device
    PagedEngine on the same weights, and so do its syncs."""
    want = runs["jax_f32"]
    for res in runs["world2"]:
        assert res["paged-f32"]["streams"] == want["streams"]
        assert res["paged-f32"]["syncs"] == want["syncs"]
    assert runs["single"]["paged-f32"]["streams"] == want["streams"]


def test_kv_shard_moves_4x_fewer_all_gather_bytes_than_gather(runs):
    """Per decode step, the kv-head-sharded arm all-gathers only the
    vocab-split logits; the gather baseline gathers q and every layer's
    pools too (the reference's
    ``test_sharded_decode_collectives_beat_gather_baseline``)."""
    per = {name: runs["world2"][0][name]["decode_collectives"]
           ["bytes_per_step_by_op"] for name in ("paged-bfloat16",
                                                  "paged-gather")}
    kv, gather = (per[n]["all-gather/model"] for n in ("paged-bfloat16",
                                                       "paged-gather"))
    assert gather >= 4 * kv > 0, per
    # the logits: 2 slots x 256 of the 512 vocab rows, fp32
    assert kv == 2 * 256 * 4
    # wo and down all-reduce per layer, plus the embedding: fp32 rows
    cfg = get_smoke_config("qwen2-1.5b")
    assert per["paged-bfloat16"]["all-reduce/model"] == \
        (2 * cfg.num_layers + 1) * 2 * cfg.d_model * 4


def _mesh2():
    return Mesh(shape={"data": 1, "model": 2},
                coords={"data": 0, "model": 0}, device=torch.device("cpu"))


def _build(cfg, params=None, cls=None, **kw):
    lm = LM(cfg, device="cpu")
    cls = cls or arms.PagedEngine
    return cls(lm, lm.init(0) if params is None else params, n_slots=2,
               max_len=32, page_size=8, mesh=_mesh2(), **kw)


def test_refusals_under_a_model_axis():
    """What the port still does not shard under a model axis is refused
    with a message naming its ROADMAP item, and none names A8.3 (MoE,
    fp8 / int4 weights and PEFT adapters are served since): heads the
    axis does not divide (both counts named) and MLA, expert counts and
    widths it divides neither, an int4 K/m that splits a packed pair, a
    narrowed KV-head style (A8.8); none needs a process group to be
    refused.  (The host decisions that read the clock are served since:
    ``test_torch_host_decisions.py``.)"""
    import dataclasses
    from repro_torch.quant import quantize_tree
    from repro_torch.sharding.tp import check_servable
    cfg = get_smoke_config("qwen2-1.5b")
    odd = cfg.with_(attention=dataclasses.replace(
        cfg.attention, num_heads=6, num_kv_heads=3))
    with pytest.raises(ValueError, match="6 query heads.*3 kv heads.*A8.8"):
        _build(odd)
    mla = cfg.with_(model_parallel=2, attention=dataclasses.replace(
        cfg.attention, kind="mla"))
    with pytest.raises(ValueError, match="mla attention.*A8.8"):
        check_servable(mla, {})
    granite = get_smoke_config("granite-moe-3b-a800m")
    narrow = granite.with_(moe=dataclasses.replace(granite.moe, d_ff=63))
    with pytest.raises(ValueError,
                       match="5 \\(padded\\) experts.*width 63.*A8.8"):
        _build(narrow)
    k6 = cfg.with_(d_ff=6)
    with pytest.raises(ValueError, match="K/m even.*A8.8"):
        _build(k6, quantize_tree(LM(k6, device="cpu").init(0),
                                 quant="int4"))
    with pytest.raises(ValueError, match="kv_cache_style 'mqa'.*A8.8"):
        _build(cfg.with_(kv_cache_style="mqa"))
    with pytest.raises(ValueError, match="model_parallel"):
        LM(cfg, device="cpu", mesh=_mesh2())


def test_serve_cli_model_parallel_prints_the_paged_streams(runs):
    """``launch.serve --model-parallel 2 --device cpu`` starts two gloo
    ranks, exits 0 and prints rank 0's mesh line and the single-rank
    ``--paged`` streams."""
    (rc1, paged), (rc2, out) = runs["cli"]
    assert rc1 == rc2 == 0
    want = [ln for ln in paged.splitlines() if ln.strip().startswith("req ")]
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in out
    assert [ln for ln in out.splitlines()
            if ln.strip().startswith("req ")] == want and len(want) == 3
    assert "every rank's streams equal" in out


def test_chip_smoke_drives_the_tp_phase():
    """chip_smoke.py has a tensor-parallel phase that its main runs after
    the jamba phase: two spawned ranks that load the built kernels and
    serve qwen2-1.5b with a mesh through PagedEngine (logits against one
    rank's, float32 streams equal), SchedEngine and SpecEngine, int8
    weights with every B4 / B5 call held bit for bit, and the gather arm
    against the kv_shard arm's all-gather bytes."""
    import ast
    from pathlib import Path
    text = (Path(__file__).resolve().parents[1] / "chip_smoke.py"
            ).read_text()
    tree = ast.parse(text)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main_calls = [ast.unparse(c.func) for c in ast.walk(funcs["main"])
                  if isinstance(c, ast.Call)]
    assert main_calls.index("phase_tp") > main_calls.index("phase_jamba")
    reached, todo = set(), ["phase_tp"]
    while todo:
        name = todo.pop()
        reached.add(name)
        todo += [ast.unparse(a) for c in ast.walk(funcs[name])
                 if isinstance(c, ast.Call)
                 for a in [c.func] + list(c.args)
                 if ast.unparse(a) in funcs and ast.unparse(a) not in reached]
    body = "\n".join(ast.unparse(funcs[n]) for n in sorted(reached))
    for needle in ("spawn_world", "make_host_mesh", "PagedEngine(",
                   "SchedEngine", "SpecEngine", "tp_attn_impl='gather'",
                   "_qmm_calls_vs_plain", "_reset_launches", "lib_path",
                   "LOGIT_REL_L2", "TP_GATHER_MIN_RATIO", "float32",
                   "max_memory_allocated", "all_reduce", "all_gather"):
        assert needle in body, needle
    assert "[23 tp]" in text
