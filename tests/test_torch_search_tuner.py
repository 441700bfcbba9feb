"""Port parity: Algorithm 1 (``repro_torch.core.tuner.AutoTuner``) against
the reference's, end to end, on the same seeds and tiers.

A whole ``run`` at a small budget returns exactly the reference's archive
front (configurations and objective vectors), real-evaluation count,
surrogate R², history, and ``recommend`` / ``recommend_efficient`` picks;
``recalibrate`` pushes the same log-space shifts into the same surrogates
(mirroring the reference's own tests of it in ``tests/test_profile.py``),
and a calibration handed to the constructor reaches the evaluator."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _search_pairs import assert_same_front, configs, jeff, tier  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import evaluator as jev  # noqa: E402
from repro.core import features as jfeat  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import evaluator as tev  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import tuner as ttuner  # noqa: E402

BUDGET = dict(n0=16, refine_iters=1, k_per_iter=4, pop_size=12,
              generations=4, ensemble_k=2)
MMLU = ("mmlu", "understanding", 0.7, 512)


def _pair(name, tier_name, mask=None, **kw):
    """(JAX tuner, port tuner) on the same config, task and tier."""
    jc, tc = configs(name)
    je = jev.Evaluator(jc, jfeat.TaskSpec(*MMLU), jcm.TIERS[tier_name])
    te = tev.Evaluator(tc, tfeat.TaskSpec(*MMLU), tier(tier_name))
    jm = None if mask is None else jspace.SpaceMask(**mask)
    tm = None if mask is None else tspace.SpaceMask(**mask)
    return (jtuner.AutoTuner(je, mask=jm, **kw),
            ttuner.AutoTuner(te, mask=tm, **kw))


@pytest.mark.parametrize("case", [
    ("llama2-7b", "v5e-8", None, 0, BUDGET),
    ("qwen2-1.5b", "v5e-1", dict(attention_arms=False, moe_arms=False), 3,
     dict(BUDGET, n0=12, pop_size=10, generations=3))],
    ids=["llama2-7b-8chips", "qwen2-served-mask"])
def test_autotuner_run_matches_jax(case):
    """The reference's test budget scaled down; the second case is the
    search the card's phase 18 runs (the arms the port serves), at one
    chip, at a smaller budget still."""
    name, tier_name, mask, seed, budget = case
    jt, tt = _pair(name, tier_name, mask, seed=seed, **budget)
    jr, tr = jt.run(), tt.run()
    assert tr.n_real_evals == jr.n_real_evals
    assert tr.surrogate_r2 == jr.surrogate_r2
    assert tr.history == jr.history
    assert_same_front(jr.archive, tr.archive)
    assert [str(c) for c in tt.configs] == [str(c) for c in jt.configs]
    np.testing.assert_array_equal(np.asarray(tt.Y), np.asarray(jt.Y))
    jc, jo = jtuner.recommend(jr.archive)
    tc, to = ttuner.recommend(tr.archive)
    assert str(tc) == str(jc)
    np.testing.assert_array_equal(to, jo)
    base = tt.ev.evaluate(tspace.EfficiencyConfig.default())
    np.testing.assert_array_equal(
        base, jt.ev.evaluate(jspace.EfficiencyConfig.default()))
    for drop in (1.1, 0.0):
        jc, jo = jtuner.recommend_efficient(jr.archive, base,
                                            max_acc_drop=drop)
        tc, to = ttuner.recommend_efficient(tr.archive, base,
                                            max_acc_drop=drop)
        assert str(tc) == str(jc)
        np.testing.assert_array_equal(to, jo)
    assert ttuner.recommend(ttuner.ParetoArchive()) == (None, None)


def _fitted_pair():
    """Tiny surrogates fit directly on eight seeded configurations (as the
    reference's own test does), the same on both sides."""
    jt, tt = _pair("qwen2-1.5b", "v5e-1", n0=4, refine_iters=0,
                   k_per_iter=2, pop_size=8, generations=2, seed=0,
                   ensemble_k=2)
    rng = np.random.default_rng(0)
    cfgs = [tspace.sample_config(rng, tt.mask) for _ in range(8)]
    tt.X = [tspace.encode_config(c) for c in cfgs]
    tt.Y = [tt.ev.evaluate(c) for c in cfgs]
    jt.X = [jspace.encode_config(jeff(c)) for c in cfgs]
    jt.Y = [jt.ev.evaluate(jeff(c)) for c in cfgs]
    jt._fit()
    tt._fit()
    return jt, tt


def test_recalibrate_shifts_match_jax():
    """The same measured drift gives the same latency / energy shifts,
    the same shifted surrogate means, the calibration kept by the
    evaluator, and an untouched accuracy surrogate; a second
    recalibration shifts from the first's level."""
    jt, tt = _fitted_pair()
    x = np.asarray(tt.X[:3])
    mu_before = tt.surrogates["lat"].predict(x)[0]
    jcal, tcal = jcm.CalibratedCostModel(), tcm.CalibratedCostModel()
    for cal in (jcal, tcal):
        cal.update("decode_block", "arm", measured_s=4e-3,
                   predicted_s=1e-3)
        cal.update("admit", "arm", measured_s=3e-3, predicted_s=1e-3)
    js, ts = jt.recalibrate(jcal), tt.recalibrate(tcal)
    assert ts == js
    assert ts["lat"] > 0 and ts["energy"] > 0
    assert tt.ev.calibration is tcal
    assert tt.surrogates["acc"].offset == 0.0
    for name in ttuner.OBJS:
        assert tt.surrogates[name].offset == jt.surrogates[name].offset
        for a, b in zip(tt.surrogates[name].predict(x),
                        jt.surrogates[name].predict(x)):
            np.testing.assert_array_equal(a, b)
    # (mu + shift) - mu rounds the shift: 1e-12 relative
    np.testing.assert_allclose(tt.surrogates["lat"].predict(x)[0]
                               - mu_before, ts["lat"], rtol=1e-12)
    jcal2, tcal2 = jcm.CalibratedCostModel(), tcm.CalibratedCostModel()
    for cal in (jcal2, tcal2):
        cal.update("decode_block", "arm", measured_s=2e-3,
                   predicted_s=1e-3)
    assert tt.recalibrate(tcal2) == jt.recalibrate(jcal2)
    np.testing.assert_array_equal(tt._predict([tspace.EfficiencyConfig()])[0],
                                  jt._predict([jspace.EfficiencyConfig()])[0])


def test_constructor_threads_calibration_into_evaluator():
    _, tc = configs("qwen2-1.5b")
    ev = tev.Evaluator(tc, tfeat.TASKS["mmlu"], tier("v5e-1"))
    uncal = tev.Evaluator(tc, tfeat.TASKS["mmlu"], tier("v5e-1"))
    calib = tcm.CalibratedCostModel()
    calib.update("admit", "arm", 2e-3, 1e-3)
    ttuner.AutoTuner(ev, calibration=calib)
    assert ev.calibration is calib
    eff = tspace.EfficiencyConfig.default()
    assert ev.evaluate(eff)[1] > uncal.evaluate(eff)[1]
    assert ev.evaluate(eff)[0] == uncal.evaluate(eff)[0]
