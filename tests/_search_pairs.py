"""Helpers of the search parity tests (``test_torch_search_*``,
``test_torch_tables*``): the reference's tiers as port tiers, the
reference's configs of the search's roster, and the same efficiency
configuration on both sides.

The port names no TPU tier, so the tests build the tiers they compare at
from the reference's ``HW`` and ``TIERS``; the port's code then has to
give exactly (``==``) what the reference gives at the same tier."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.paper_models import PAPER_MODELS
from repro.core import costmodel as jcm
from repro.core import space as jspace
from repro.launch.mesh import HW
from repro_torch import configs as tconfigs
from repro_torch.core import costmodel as tcm

# the reference's table drivers (``benchmarks/``) import from the repo root
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the ten assigned archs and the paper's six models
ROSTER = tuple(jconfigs.ARCH_IDS) + tuple(PAPER_MODELS)


def tier(name: str) -> tcm.HwTier:
    """The reference's tier ``name`` with the reference's ``HW`` peaks, as
    a port ``HwTier``."""
    jt = jcm.TIERS[name]
    return tcm.HwTier(jt.name, jt.chips, jt.mem_cap, jt.power_budget,
                      peak_flops_bf16=HW["peak_flops_bf16"],
                      peak_flops_int8=HW["peak_flops_int8"],
                      hbm_bw=HW["hbm_bw"], link_bw=HW["ici_bw_per_link"],
                      links=HW["ici_links"], tdp_watts=HW["tdp_watts"],
                      idle_watts=HW["idle_watts"])


def configs(name: str):
    """(JAX config, port config) of a roster entry."""
    return jconfigs.get_config(name), tconfigs.get_config(name)


def jeff(eff):
    """The port's efficiency configuration as the reference's."""
    return jspace.EfficiencyConfig(
        jspace.ArchChoice(**dataclasses.asdict(eff.arch)),
        jspace.FtChoice(**dataclasses.asdict(eff.ft)),
        jspace.InfChoice(**dataclasses.asdict(eff.inf)))


def assert_same_front(j_archive, t_archive):
    """Two Pareto archives hold the same configurations with the same
    objectives, in the same order."""
    jf, tf = j_archive.front(), t_archive.front()
    assert [str(c) for c, _ in tf] == [str(c) for c, _ in jf]
    for (_, jo), (_, to) in zip(jf, tf):
        np.testing.assert_array_equal(to, jo)


def tiny_tuner(cls):
    """``cls`` (an ``AutoTuner``) at the smallest budget that still runs
    every step of Algorithm 1: the table drivers' own budgets take minutes
    on the CPU.  The refinement count stays the caller's."""
    def make(ev, **kw):
        kw.update(n0=8, k_per_iter=2, pop_size=6, generations=2,
                  ensemble_k=1)
        return cls(ev, **kw)
    return make


@pytest.fixture
def small_tables(monkeypatch, tmp_path):
    """The reference's table drivers and the port's, side by side, at the
    smallest budget: the port's ``consumer`` / ``datacenter`` /
    ``high_perf`` aliases point at the reference's 1-, 8- and 256-chip
    tiers built as port tiers, every driver's ``AutoTuner`` is
    :func:`tiny_tuner`'s, each boosted surrogate has 20 trees instead of
    120 (both sides), and each side dumps its JSON into its own temporary
    directory.  Returns {"jax": modules, "torch": modules}."""
    import benchmarks.common as jcommon
    import benchmarks.pareto_front as jpareto
    import benchmarks.table2_main as jt2
    import benchmarks.table3_ablations as jt3
    import benchmarks.table4_vlm as jt4
    import benchmarks.table6_tasks as jt6
    from repro.core import surrogate as jsur
    from repro_torch.core import surrogate as tsur
    from repro_torch.tables import common as tcommon
    from repro_torch.tables import pareto_front as tpareto
    from repro_torch.tables import table2_main as tt2
    from repro_torch.tables import table3_ablations as tt3
    from repro_torch.tables import table4_vlm as tt4
    from repro_torch.tables import table6_tasks as tt6

    for alias, name in (("consumer", "v5e-1"), ("datacenter", "v5e-8"),
                        ("high_perf", "v5e-256")):
        monkeypatch.setitem(tcm.TIERS, alias, tier(name))
    for mod in (jcommon, tcommon, jt3, tt3, jpareto, tpareto):
        monkeypatch.setattr(mod, "AutoTuner", tiny_tuner(mod.AutoTuner))
    for sur in (jsur, tsur):
        init = sur.GradientBoostedTrees.__init__
        monkeypatch.setattr(init, "__defaults__",
                            (20,) + init.__defaults__[1:])
    monkeypatch.setattr(jcommon, "OUT_DIR", tmp_path / "jax")
    monkeypatch.setattr(tcommon, "OUT_DIR", tmp_path / "torch")
    names = ("common", "table2", "table3", "table4", "table6", "pareto")
    return {"jax": dict(zip(names, (jcommon, jt2, jt3, jt4, jt6, jpareto))),
            "torch": dict(zip(names, (tcommon, tt2, tt3, tt4, tt6,
                                      tpareto))),
            "out": tmp_path}


def same_dump(out, name):
    """Both sides wrote the same artifact ``name``."""
    import json
    j = json.loads((out / "jax" / f"{name}.json").read_text())
    t = json.loads((out / "torch" / f"{name}.json").read_text())
    assert t == j
