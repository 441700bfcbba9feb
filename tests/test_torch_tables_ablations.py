"""Port parity: the paper's Table 3 ablations (``repro_torch.tables.
table3_ablations``) against the reference's ``benchmarks/``: every search
component and configuration-space ablation and the refinement sweep, at
the smallest search budget (``_search_pairs.small_tables``), give the
reference's Efficiency Scores, checks and artifact."""
import pytest

torch = pytest.importorskip("torch")

from _search_pairs import same_dump, small_tables  # noqa: E402,F401


def test_table3_matches_reference(small_tables, monkeypatch):
    j, t = small_tables["jax"], small_tables["torch"]
    for side in (j, t):
        monkeypatch.setattr(side["table3"], "TASKS",
                            side["common"].LM_TASKS[:2])
    tp, jp = t["table3"].run(), j["table3"].run()
    assert tp == jp
    assert len(tp["rows"]) == 12
    same_dump(small_tables["out"], "table3_ablations")
