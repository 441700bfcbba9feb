"""Every dry-run cell's verdict on both production meshes (16 x 16 and
2 x 16 x 16), as ``python -m repro_torch.launch.dryrun --all`` reaches
it: traced ("ok") or skipped by the reference's long_500k policy, and
never refused or an exception.

* Every supported cell of the 10 archs x 4 shapes is built without a
  trace (``run_cell(trace=False)``: the ``sharding.tp`` checks, the
  abstract inputs and the placements), each arch's abstract parameters
  made once; rwkv6-1.6b's four cells and the train cells of whisper,
  vision and jamba among them (ROADMAP A8.6).
* Every decode cell is traced on both meshes (the faults C.2 and C.4
  were decode cells: llama4-scout's FSDP leaves, whisper's and vision's
  source K / V; rwkv6's decode_32k and long_500k run its heads over the
  model axis); the FSDP decode cell gathers exactly the leaves FSDP
  splits, one all-gather over "data" each.  jamba's decode cells count
  each of its 63 Mamba layers' gather and two all-reduces over "model"
  (ROADMAP C.5), rwkv6's each layer's ``wout`` and MLP sums and no
  gather but the logits' (its ``x_prev`` is whole on every rank).
* qwen2-1.5b's prefill_32k and train_4k on 16 x 16 trace through the
  whole-heads arm (12 query heads and 2 kv heads on a model axis of
  16), with a rank's collectives counted.
The heavy prefill and train cells of the other archs are traced by the
CLI on the host (PERF.md §6).  The file's budget is 160 s of worker time
(decode traces take 1-8 s; qwen2's prefill and train cells 12 and 20 s).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.specs import SUBQUADRATIC, input_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

MESHES = {"16x16": False, "2x16x16": True}
DECODE_CELLS = [(arch, shape) for arch in ARCH_IDS
                for shape in ("decode_32k", "long_500k")
                if shape != "long_500k" or arch in SUBQUADRATIC]


@pytest.fixture(scope="module", autouse=True)
def params_once():
    """Each arch's abstract parameters made once for the module (a cell
    reads them; they never change)."""
    orig = steps.abstract_params
    steps.abstract_params = functools.lru_cache(maxsize=None)(orig)
    yield
    steps.abstract_params = orig


def _run(arch, shape, multi_pod, tmp_path, **kw):
    return dryrun.run_cell(arch, shape, multi_pod=multi_pod, overrides={},
                           fsdp="auto", tag="", out_dir=tmp_path,
                           quiet=True, **kw)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_builds_or_is_refused_with_a_roadmap_label(arch, mesh,
                                                               tmp_path):
    """Each shape of ``arch`` builds (checks, abstract inputs and
    placements) or is skipped by the reference's long_500k policy: no
    supported cell is refused any more (the RWKV-6 cells and the train
    cells of Mamba, cross-attention and encoder models were, with A8.6's
    label) and none errs."""
    for shape in SHAPES:
        r = _run(arch, shape, MESHES[mesh], tmp_path, trace=False)
        if r["status"] == "skipped":
            assert shape == "long_500k" and "quadratic" in r["why"]
            continue
        assert r["status"] == "built", (shape, r.get("error"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_cell_traces(arch, shape, mesh, tmp_path):
    """Every decode cell that is not refused traces to finite roofline
    terms; where FSDP splits the parameters (llama4-scout, jamba) the
    step gathers each split leaf it reads once over "data"; a
    cross-attention model's cache carries the source K / V."""
    multi = MESHES[mesh]
    r = _run(arch, shape, multi, tmp_path)
    assert r["status"] == "ok", r.get("traceback", r.get("why"))
    roof = r["roofline"]
    assert roof["flops"] > 0 and r["t_max_s"] > 0
    counts = roof["collective_counts"]
    if r["fsdp"]:
        cfg = get_config(arch).with_(decode_attn_impl=r["decode_attn_impl"])
        cell = steps.build_cell(cfg, SHAPES[shape],
                                dryrun.production_mesh(multi), fsdp=True)
        split = [p for p, s in leaves_with_path(cell.in_shardings[0])
                 if isinstance(s, tuple) and "data" in s
                 and not p.startswith("encoder")]
        assert split and counts["all-gather/data"] == len(split)
    else:
        assert "all-gather/data" not in counts
    if arch in ("whisper-base", "llama-3.2-vision-11b"):
        cache = input_specs(get_config(arch), SHAPES[shape])["cache"]
        assert any(p.endswith("/xk") for p, _ in leaves_with_path(cache))
    cfg = get_config(arch)
    kinds = cfg.block_pattern * cfg.num_groups
    if arch == "jamba-1.5-large-398b":
        # the cp decode of its 9 attention layers (q / k / v gathered;
        # the combine's max, l and o and wo summed), a Mamba layer's
        # in_proj gather and x_proj / out_proj sums, every layer's MoE
        # or MLP sum, the embedding's sum and the logits' gather
        attn, mamba = kinds.count("attn"), kinds.count("mamba")
        assert mamba == 63
        assert counts["all-gather/model"] == 3 * attn + mamba + 1
        assert counts["all-reduce/model"] == 4 * attn + 2 * mamba \
            + cfg.num_layers + 1
    if arch == "rwkv6-1.6b":
        # a layer's wout and MLP sums (x_prev is whole on every rank); the
        # embedding's sum and the logits' gather
        assert counts == {"all-gather/model": 1,
                          "all-reduce/model": 2 * cfg.num_layers + 1}


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_qwen2_cells_trace_over_every_head(shape, tmp_path):
    """qwen2-1.5b's prefill_32k and train_4k cells on 16 x 16: 16 divides
    neither its 12 query heads nor its 2 kv heads, so every rank
    computes every head from gathered projections.  A prefill makes 3
    model gathers a layer and the logits' one, and 2 model all-reduces a
    layer (``wo``, ``down``) and the embedding's; a training step adds a
    reduce-scatter for each gather its backward reaches."""
    r = _run("qwen2-1.5b", shape, False, tmp_path)
    assert r["status"] == "ok", r.get("traceback")
    counts = r["roofline"]["collective_counts"]
    layers = get_config("qwen2-1.5b").num_layers
    if shape == "prefill_32k":
        assert counts == {"all-gather/model": 3 * layers + 1,
                          "all-reduce/model": 2 * layers + 1}
    else:
        assert counts["reduce-scatter/model"] == 3 * layers
        assert counts["all-gather/model"] >= 3 * layers
