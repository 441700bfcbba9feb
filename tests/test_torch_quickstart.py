"""The port's quickstart (``python -m repro_torch.launch.quickstart``, the
flow of ``examples/quickstart.py``): at the tiny budget its search gives
the reference's c* at the same tier (built from the reference's, as the
search tests build theirs), and the whole flow (search at ``h100-8``,
c* applied to the smoke llama3.2-1b, training) runs on the CPU with a
finite, falling loss."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _search_pairs import configs, jeff, tier  # noqa: E402
from _train_pairs import one_intraop_thread  # noqa: E402,F401
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import evaluator as jev  # noqa: E402
from repro.core import features as jfeat  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro_torch.core.features import TASKS  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402


pytestmark = pytest.mark.usefixtures("one_intraop_thread")


def test_tiny_search_gives_the_reference_cstar(monkeypatch):
    # the reference's tier with its peaks, in place of the port's h100-8
    monkeypatch.setattr(quickstart, "TIER", tier("datacenter"))
    jcfg, tcfg = configs("llama2-7b")
    assert quickstart.MODEL == tcfg and quickstart.TASK == TASKS["gsm8k"]
    eff, obj, base, report = quickstart.search(budget="tiny")
    ev = jev.Evaluator(jcfg, jfeat.TASKS["gsm8k"], jcm.TIERS["datacenter"],
                       seed=0)
    tuner = jtuner.AutoTuner(ev, mask=jspace.space_for_family(jcfg.family),
                             seed=0, **quickstart.BUDGETS["tiny"])
    jreport = tuner.run()
    jbase = ev.evaluate(jspace.EfficiencyConfig.default())
    jstar, jobj = jtuner.recommend_efficient(jreport.archive, jbase)
    assert jeff(eff) == jstar
    np.testing.assert_array_equal(obj, jobj)
    np.testing.assert_array_equal(base, jbase)
    assert report.n_real_evals == jreport.n_real_evals


def test_quickstart_main_trains_cstar(capsys):
    assert quickstart.main(["--budget", "tiny", "--steps", "12",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selected config: EfficiencyConfig(" in out
    line = [ln for ln in out.splitlines() if ln.startswith("trained 12")][0]
    first, last = (float(v) for v in line.split("loss ")[1].split(" -> "))
    assert np.isfinite([first, last]).all() and last < first
