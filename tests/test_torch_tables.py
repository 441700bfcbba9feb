"""Port parity: the paper's Table 2 driver (``repro_torch.tables``) against
the reference's ``benchmarks/``, and the port's H100 tiers.

With the port's tier aliases pointed at the reference's tiers (built as
port tiers from its ``HW``) and both sides' searches at the smallest
budget (``_search_pairs.small_tables``), the port's baselines, AE-LLM
selection, Table-2 rows, summary and JSON artifact equal the reference's.
The H100 tiers themselves carry the data sheet's fields, and the paper's
tier names map onto 1, 8 and 256 cards."""
import pytest

torch = pytest.importorskip("torch")

from _search_pairs import same_dump, small_tables  # noqa: E402,F401
from repro_torch.core import costmodel as tcm  # noqa: E402

TASKS = ["mmlu", "gsm8k"]


def test_h100_tiers_carry_the_data_sheet_and_the_aliases_map():
    """1, 8 and 256 H100 SXM cards at the data sheet's dense rates, 80 GB,
    700 W each (the power budget scales with the cards), the measured idle
    draw, NVLink 4's 18 links of 50 GB/s; consumer / datacenter /
    high_perf are the 1-, 8- and 256-card tiers."""
    for name, chips in (("h100-1", 1), ("h100-8", 8), ("h100-256", 256)):
        t = tcm.TIERS[name]
        assert (t.name, t.chips) == (name, chips)
        assert (t.mem_cap, t.power_budget, t.tdp_watts) == \
            (80e9, 700.0 * chips, 700.0)
        assert (t.peak_flops_bf16, t.peak_flops_int8, t.hbm_bw) == \
            (989.4e12, 1978.9e12, 3.35e12)
        assert (t.link_bw, t.links) == (50e9, 18)
        assert t.idle_watts == tcm.H100_IDLE_WATTS
    for alias, name in (("consumer", "h100-1"), ("datacenter", "h100-8"),
                        ("high_perf", "h100-256")):
        assert tcm.TIERS[alias] is tcm.TIERS[name]


def test_table2_matches_reference(small_tables):
    """Table 2 for one small model over two tasks: the five methods'
    configurations and rows (accuracy, latency, memory, energy,
    Efficiency Score), the paper-claim summary and the artifact; the
    manual baseline's other scenarios and the tier each size takes."""
    j, t = small_tables["jax"], small_tables["torch"]
    for scenario in ("balanced", "memory", "latency", "accuracy"):
        assert str(t["common"].manual_selection("llama2-70b", scenario)) == \
            str(j["common"].manual_selection("llama2-70b", scenario))
    assert [t["common"].tier_for(m) for m in ("llama2-1b", "mistral-7b",
                                              "llama2-70b")] == \
        ["datacenter", "datacenter", "high_perf"]
    tp = t["table2"].run(["llama2-1b"], TASKS)
    jp = j["table2"].run(["llama2-1b"], TASKS)
    assert tp == jp
    assert set(tp["rows"]["llama2-1b"]) == {
        "Default", "Best Single-Stage", "Manual Selection",
        "EfficientLLM Rec.", "AdaptiveEfficientLLM"}
    same_dump(small_tables["out"], "table2_main")
