"""Port parity: the paper's Table 4 (VLMs), Table 6 (per task) and Pareto
front / configuration-distribution drivers (``repro_torch.tables``)
against the reference's ``benchmarks/``, each at its smallest arguments
(one model, one or two tasks) and the smallest search budget
(``_search_pairs.small_tables``): the rows, summaries, checks and
artifacts equal the reference's."""
import pytest

torch = pytest.importorskip("torch")

from _search_pairs import same_dump, small_tables  # noqa: E402,F401


def test_table4_matches_reference(small_tables, monkeypatch):
    j, t = small_tables["jax"], small_tables["torch"]
    for side in (j, t):
        monkeypatch.setattr(side["table4"], "MODELS", ["llava-1.5-7b"])
        monkeypatch.setattr(side["table4"], "VLM_TASKS", ["textvqa"])
    tp, jp = t["table4"].run(), j["table4"].run()
    assert tp == jp
    same_dump(small_tables["out"], "table4_vlm")


def test_table6_matches_reference(small_tables, monkeypatch):
    j, t = small_tables["jax"], small_tables["torch"]
    for side in (j, t):
        monkeypatch.setattr(side["table6"], "MODELS", ["mistral-7b"])
        monkeypatch.setattr(side["table6"], "LM_TASKS", ["gsm8k", "needle"])
    tp, jp = t["table6"].run(), j["table6"].run()
    assert tp == jp
    same_dump(small_tables["out"], "table6_tasks")


def test_pareto_fronts_and_distribution_match_reference(small_tables,
                                                        monkeypatch):
    """One model's front, then the configuration distribution over three
    tasks × the three tier aliases."""
    j, t = small_tables["jax"], small_tables["torch"]
    for side in (j, t):
        monkeypatch.setattr(side["pareto"], "MODELS", ["llama2-7b"])
    tp, jp = t["pareto"].run(), j["pareto"].run()
    assert tp == jp
    assert sum(tp["config_distribution"]["quant"].values()) == 9
    same_dump(small_tables["out"], "pareto_fronts")
