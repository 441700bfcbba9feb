"""Port parity: the search's numpy building blocks (``repro_torch.core``
``features`` / ``pareto`` / ``nsga2`` / ``surrogate``) against the
reference's ``repro.core`` copies, on the same numpy inputs and seeds.

Both sides run the same numpy operations in the same order, so every
comparison is exact (``==`` / ``assert_array_equal``): task and model
features over the sixteen configs of the roster, ``encode_config`` of
seeded samples, the non-dominated sort, crowding distance and the
archive, NSGA-II's crossover, mutation, initialisation and a whole
search from one ``default_rng``, and the CART / boosting / ensemble fits
and predictions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _search_pairs import ROSTER, configs  # noqa: E402
from repro.core import features as jfeat  # noqa: E402
from repro.core import nsga2 as jnsga  # noqa: E402
from repro.core import pareto as jpar  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import surrogate as jsur  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import nsga2 as tnsga  # noqa: E402
from repro_torch.core import pareto as tpar  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import surrogate as tsur  # noqa: E402

MASKS = {"all": {}, "served": dict(attention_arms=False, moe_arms=False),
         "ssm": dict(attention_arms=False, kv_arms=False)}


# ---------------------------------------------------------------------------
# features


def test_tasks_and_features_match_jax():
    """The thirteen tasks field by field, ψ(T) of each, and φ(M) of every
    config of the roster."""
    assert list(tfeat.TASKS) == list(jfeat.TASKS)
    assert tfeat.TASK_DOMAINS == jfeat.TASK_DOMAINS
    for name, t in tfeat.TASKS.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(jfeat.TASKS[name])
        assert tfeat.encode_task(t) == jfeat.encode_task(jfeat.TASKS[name])
    for name in ROSTER:
        j, t = configs(name)
        assert tfeat.encode_model(t) == jfeat.encode_model(j), name


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_encode_config_of_seeded_samples(mask):
    """One seed draws the same configurations on both sides under each
    mask, and each encodes to the same feature vector."""
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    jm, tm = jspace.SpaceMask(**MASKS[mask]), tspace.SpaceMask(**MASKS[mask])
    for _ in range(200):
        jc, tc = jspace.sample_config(jr, jm), tspace.sample_config(tr, tm)
        assert str(tc) == str(jc)
        assert tspace.encode_config(tc) == jspace.encode_config(jc)


# ---------------------------------------------------------------------------
# Pareto


def _objs(rng, n):
    """[acc, lat, mem, energy] with ties (values on a coarse grid)."""
    return np.column_stack([rng.integers(50, 60, n), rng.integers(1, 6, n),
                            rng.integers(1, 6, n),
                            rng.integers(1, 4, n)]).astype(np.float64)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 60])
def test_pareto_sort_crowding_and_archive_match_jax(n):
    rng = np.random.default_rng(n)
    objs = _objs(rng, n)
    m = tpar.to_min(objs)
    np.testing.assert_array_equal(m, jpar.to_min(objs))
    tf, jf = tpar.non_dominated_sort(m), jpar.non_dominated_sort(m)
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tpar.crowding_distance(m[a]),
                                      jpar.crowding_distance(m[b]))
    np.testing.assert_array_equal(tpar.pareto_front_mask(m),
                                  jpar.pareto_front_mask(m))
    ta, ja = tpar.ParetoArchive(), jpar.ParetoArchive()
    for i, o in enumerate(objs):
        assert ta.add(f"c{i}", o) == ja.add(f"c{i}", o)
    assert [c for c, _ in ta.front()] == [c for c, _ in ja.front()]
    for (_, a), (_, b) in zip(ta.front(), ja.front()):
        np.testing.assert_array_equal(a, b)
    base = objs[0]
    norms = objs.max(axis=0)
    for o in objs:
        assert tpar.efficiency_score(o, base) == \
            jpar.efficiency_score(o, base)
        assert tpar.utility(o, (1.0, 0.5, 0.3, 0.2), norms) == \
            jpar.utility(o, (1.0, 0.5, 0.3, 0.2), norms)
        assert tpar.dominates(o, base) == jpar.dominates(o, base)


# ---------------------------------------------------------------------------
# NSGA-II


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_nsga2_operators_from_one_rng_match_jax(mask):
    """Crossover, mutation (every stage, under the mask), tournaments and
    constrained initialisation draw the same numbers from one seed and
    give the same configurations."""
    jm, tm = jspace.SpaceMask(**MASKS[mask]), tspace.SpaceMask(**MASKS[mask])
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    jpop = [jspace.sample_config(jr, jm) for _ in range(16)]
    tpop = [tspace.sample_config(tr, tm) for _ in range(16)]
    for _ in range(300):
        i, k = int(jr.integers(0, 16)), int(tr.integers(0, 16))
        assert i == k
        jc = jnsga.hierarchical_crossover(jpop[i], jpop[-1 - i], jr)
        tc = tnsga.hierarchical_crossover(tpop[i], tpop[-1 - i], tr)
        jc, tc = jnsga.mutate(jc, jr, jm), tnsga.mutate(tc, tr, tm)
        assert str(tc) == str(jc)
        # each stage's own mutation, forced
        assert str(tnsga._mutate_arch(tc.arch, tr, tm)) == \
            str(jnsga._mutate_arch(jc.arch, jr, jm))
        assert str(tnsga._mutate_ft(tc.ft, tr)) == \
            str(jnsga._mutate_ft(jc.ft, jr))
        assert str(tnsga._mutate_inf(tc.inf, tr, tm)) == \
            str(jnsga._mutate_inf(jc.inf, jr, jm))
        jpop[i], tpop[i] = jc, tc
    ranks = jr.integers(0, 3, 16)
    assert (tr.integers(0, 3, 16) == ranks).all()
    crowd = jr.random(16)
    tcrowd = tr.random(16)
    for _ in range(20):
        assert tnsga._tournament(tr, ranks, tcrowd) == \
            jnsga._tournament(jr, ranks, crowd)

    def feasible(c):
        return c.inf.quant != "int4" and c.arch.moe_experts < 8

    assert [str(c) for c in tnsga.constrained_init(12, tr, feasible, tm)] \
        == [str(c) for c in jnsga.constrained_init(12, jr, feasible, jm)]


def _linear_objectives(encode):
    """A deterministic objective function of a config's features, the same
    on both sides: [acc, lat, mem, energy] as fixed projections."""
    w = np.random.default_rng(3).normal(size=(4, len(
        tspace.encode_config(tspace.EfficiencyConfig()))))

    def evaluate(cs):
        x = np.asarray([encode(c) for c in cs])
        y = x @ w.T
        return np.column_stack([60 + y[:, 0], np.exp(y[:, 1] / 8),
                                np.exp(y[:, 2] / 8), np.exp(y[:, 3] / 8)])
    return evaluate


@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False)])
def test_nsga2_search_matches_jax(flags):
    """A whole search (with and without crossover and constrained
    initialisation, the Table-3 ablations) gives the same archive and
    history."""
    crossover, cinit = flags

    def feasible(c):
        return c.inf.quant != "int4"

    kw = dict(pop_size=12, generations=5, seed=7, use_crossover=crossover,
              use_constrained_init=cinit)
    ja, jh = jnsga.nsga2_search(_linear_objectives(jspace.encode_config),
                                feasible, mask=jspace.SpaceMask(), **kw)
    ta, th = tnsga.nsga2_search(_linear_objectives(tspace.encode_config),
                                feasible, mask=tspace.SpaceMask(), **kw)
    assert th == jh
    assert [str(c) for c, _ in ta.front()] == [str(c) for c, _ in ja.front()]
    for (_, a), (_, b) in zip(ta.front(), ja.front()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# surrogates


def _xy(seed, n=60, d=7):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (n, d)).astype(np.float64)   # repeated values
    x[:, 0] = rng.normal(size=n)
    y = x[:, 0] * 2 + np.sin(x[:, 1]) + rng.normal(scale=0.1, size=n)
    return x, y


def _nodes(tree):
    return [dataclasses.astuple(nd) for nd in tree.nodes]


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_and_boosting_fits_match_jax(seed):
    x, y = _xy(seed)
    xt, _ = _xy(seed + 10, n=25)
    for depth, min_samples in ((1, 4), (4, 4), (6, 2)):
        jt = jsur.RegressionTree(depth, min_samples).fit(x, y)
        tt = tsur.RegressionTree(depth, min_samples).fit(x, y)
        assert _nodes(tt) == _nodes(jt)
        np.testing.assert_array_equal(tt.predict(xt), jt.predict(xt))
    # a constant target stops at the root
    assert len(tsur.RegressionTree().fit(x, np.ones(len(y))).nodes) == 1
    for kw in (dict(n_estimators=30), dict(n_estimators=20, subsample=1.0,
                                           max_depth=2, seed=4)):
        jg = jsur.GradientBoostedTrees(**kw).fit(x, y)
        tg = tsur.GradientBoostedTrees(**kw).fit(x, y)
        assert tg.base == jg.base
        assert [_nodes(t) for t in tg.trees] == [_nodes(t) for t in jg.trees]
        np.testing.assert_array_equal(tg.predict(xt), jg.predict(xt))
        assert tg.r2(x, y) == jg.r2(x, y)


def test_ensemble_fit_predict_shift_and_update_match_jax():
    x, y = _xy(2)
    xn, yn = _xy(3, n=10)
    je = jsur.SurrogateEnsemble(k=3, seed=5, n_estimators=15).fit(x, y)
    te = tsur.SurrogateEnsemble(k=3, seed=5, n_estimators=15).fit(x, y)
    for a, b in zip(te.predict(xn), je.predict(xn)):
        np.testing.assert_array_equal(a, b)
    je.shift(0.25)
    te.shift(0.25)
    assert te.offset == je.offset == 0.25
    np.testing.assert_array_equal(te.predict(xn)[0], je.predict(xn)[0])
    je.update(xn, yn, x, y)
    te.update(xn, yn, x, y)
    for a, b in zip(te.predict(x), je.predict(x)):
        np.testing.assert_array_equal(a, b)
