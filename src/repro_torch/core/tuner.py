"""AutoTuner — Algorithm 1 (Adaptive Efficiency Optimization).

    1. evaluate n0 sampled configs for real            (Evaluator)
    2. fit surrogate ensembles per objective            (SurrogateEnsemble)
    3. for r in 1..R:
         NSGA-II on surrogates -> Pareto set P_r
         pick top-k *uncertain* configs near the front  (ensemble std)
         evaluate them for real, refit surrogates
    4. re-evaluate the final front for real -> Pareto archive

Output: ParetoArchive + ``recommend(weights)`` scalarizing with Eq. 4.

The port's copy of ``repro/core/tuner.py`` (numpy only): the same seeds
give the reference's fronts, surrogate fits and recommendations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.evaluator import Evaluator
from repro_torch.core.nsga2 import nsga2_search
from repro_torch.core.pareto import ParetoArchive, utility
from repro_torch.core.space import (EfficiencyConfig, SpaceMask,
                                    encode_config, sample_config,
                                    space_for_family)
from repro_torch.core.surrogate import SurrogateEnsemble

OBJS = ["acc", "lat", "mem", "energy"]


@dataclass
class TunerReport:
    archive: ParetoArchive
    n_real_evals: int
    surrogate_r2: dict
    history: list = field(default_factory=list)


class AutoTuner:
    def __init__(self, evaluator: Evaluator, *, mask: Optional[SpaceMask] = None,
                 n0: int = 96, refine_iters: int = 3, k_per_iter: int = 12,
                 pop_size: int = 64, generations: int = 25, seed: int = 0,
                 ensemble_k: int = 4, calibration=None,
                 log_fn=lambda *a: None):
        self.ev = evaluator
        if calibration is not None:
            self.ev.calibration = calibration
        self.mask = mask if mask is not None else \
            space_for_family(evaluator.cfg.family)
        self.n0 = n0
        self.R = refine_iters
        self.k = k_per_iter
        self.pop = pop_size
        self.gens = generations
        self.seed = seed
        self.ens_k = ensemble_k
        self.log = log_fn
        self.X: list = []
        self.Y: list = []
        self.configs: List[EfficiencyConfig] = []
        self.surrogates: dict = {}
        self.n_real = 0

    # ------------------------------------------------------------------
    def _real_eval(self, cfgs: List[EfficiencyConfig]) -> np.ndarray:
        out = []
        for c in cfgs:
            out.append(self.ev.evaluate(c))
            self.n_real += 1
        return np.asarray(out)

    def _fit(self):
        x = np.asarray(self.X)
        y = np.asarray(self.Y)
        for i, name in enumerate(OBJS):
            # latency/energy fitted in log space (span orders of magnitude)
            target = np.log(np.maximum(y[:, i], 1e-9)) if name in (
                "lat", "energy", "mem") else y[:, i]
            ens = SurrogateEnsemble(k=self.ens_k, seed=self.seed + i)
            ens.fit(x, target)
            self.surrogates[name] = ens

    def _predict(self, cfgs: List[EfficiencyConfig]):
        x = np.asarray([encode_config(c) for c in cfgs])
        means = np.zeros((len(cfgs), 4))
        stds = np.zeros((len(cfgs), 4))
        for i, name in enumerate(OBJS):
            mu, sd = self.surrogates[name].predict(x)
            if name in ("lat", "energy", "mem"):
                means[:, i] = np.exp(mu)
                stds[:, i] = np.exp(mu) * sd          # delta method
            else:
                means[:, i] = mu
                stds[:, i] = sd
        return means, stds

    def recalibrate(self, calibration) -> dict:
        """Fold measured dispatch-profile corrections into an already-fit
        tuner.  The analytic cost model is re-queried at the default arm
        with and without the calibration, and the resulting log-shift for
        latency/energy is pushed into those surrogates' output offsets —
        a level correction, exact for objectives fit in log space.  The
        evaluator keeps the calibration so every future real eval (and
        refit) is calibrated at the source."""
        from repro_torch.core.costmodel import predict
        eff = EfficiencyConfig.default()
        kw = dict(prompt=min(self.ev.task.seq_len, 512), gen=128)
        old = predict(self.ev.cfg, eff, self.ev.tier,
                      calibration=self.ev.calibration, **kw)
        new = predict(self.ev.cfg, eff, self.ev.tier,
                      calibration=calibration, **kw)
        shifts = {}
        for name, key in (("lat", "latency_ms"), ("energy", "energy_j")):
            delta = float(np.log(max(new[key], 1e-9))
                          - np.log(max(old[key], 1e-9)))
            shifts[name] = delta
            if name in self.surrogates:
                self.surrogates[name].shift(delta)
        self.ev.calibration = calibration
        self.log(f"[tuner] recalibrated: lat shift {shifts['lat']:+.3f}, "
                 f"energy shift {shifts['energy']:+.3f} (log-space)")
        return shifts

    # ------------------------------------------------------------------
    def run(self) -> TunerReport:
        rng = np.random.default_rng(self.seed)
        # Phase 0: initial sample (feasible-biased)
        init = []
        while len(init) < self.n0:
            c = sample_config(rng, self.mask)
            if self.ev.feasible(c) or rng.random() < 0.1:
                init.append(c)
        y0 = self._real_eval(init)
        self.configs += init
        self.X += [encode_config(c) for c in init]
        self.Y += list(y0)
        self._fit()
        self.log(f"[tuner] initial sample n={self.n0}")

        history = []
        for r in range(self.R):
            archive, hist = nsga2_search(
                lambda cs: self._predict(cs)[0],
                self.ev.feasible,
                pop_size=self.pop, generations=self.gens, mask=self.mask,
                seed=self.seed + 100 + r)
            front = [c for c, _ in archive.front()]
            # refinement picks: half uncertainty-targeted (§3.4), half
            # EXPLOITATION — the surrogate-predicted best Efficiency
            # Scores within the accuracy budget.  The scalar optimum is
            # an extreme corner of the 4-D front, exactly the kind of
            # point crowding-distance diversity drops from a small
            # population, so real-evaluating the predicted-best corner
            # keeps it in the output archive.
            from repro_torch.core.pareto import efficiency_score
            means, stds = self._predict(front)
            base_mu = self._predict([EfficiencyConfig.default()])[0][0]
            unc_order = np.argsort(-stds.sum(axis=1))
            # soft accuracy gate at ~2x the paper budget: configs NEAR
            # the constraint boundary are exactly the ones the surrogate
            # cannot resolve (its residual is the size of the budget), so
            # they get evaluated for real and the REAL measurement
            # decides feasibility at recommend time
            exp_score = np.array([
                efficiency_score(m, base_mu)
                if m[0] >= base_mu[0] - 2.0 else -1.0 for m in means])
            exp_order = np.argsort(-exp_score)
            seen = {str(c) for c in self.configs}
            chosen = []

            def take(order, budget):
                for i in order:
                    if budget <= 0:
                        break
                    key = str(front[i])
                    if key not in seen:
                        seen.add(key)
                        chosen.append(front[i])
                        budget -= 1

            take(exp_order, self.k - self.k // 2)
            take(unc_order, self.k - len(chosen))
            if chosen:
                y = self._real_eval(chosen)
                self.configs += chosen
                self.X += [encode_config(c) for c in chosen]
                self.Y += list(y)
                self._fit()
            history.append({"iter": r, "front": len(front),
                            "refined": len(chosen)})
            self.log(f"[tuner] refine {r}: front={len(front)} "
                     f"evaluated {len(chosen)} uncertain configs")

        # final: real-evaluate the surrogate front into the output archive
        archive, _ = nsga2_search(
            lambda cs: self._predict(cs)[0], self.ev.feasible,
            pop_size=self.pop, generations=self.gens, mask=self.mask,
            seed=self.seed + 999)
        final_front = [c for c, _ in archive.front()]
        if len(final_front) > 32:
            # keep the predicted-best scalar corners when truncating
            from repro_torch.core.pareto import efficiency_score
            means, _ = self._predict(final_front)
            base_mu = self._predict([EfficiencyConfig.default()])[0][0]
            order = np.argsort([-efficiency_score(m, base_mu)
                                for m in means])
            final_front = [final_front[i] for i in order]
        out = ParetoArchive()
        y = self._real_eval(final_front[:32])
        for c, o in zip(final_front[:32], y):
            out.add(c, o)
        # include everything real-evaluated so far (dominance filters)
        for c, o in zip(self.configs, self.Y):
            out.add(c, np.asarray(o))

        r2 = {}
        x = np.asarray(self.X)
        yv = np.asarray(self.Y)
        for i, name in enumerate(OBJS):
            t = np.log(np.maximum(yv[:, i], 1e-9)) if name in (
                "lat", "energy", "mem") else yv[:, i]
            r2[name] = float(np.mean(
                [m.r2(x, t) for m in self.surrogates[name].members]))
        return TunerReport(archive=out, n_real_evals=self.n_real,
                           surrogate_r2=r2, history=history)


def recommend(archive: ParetoArchive, weights=(1.0, 0.5, 0.3, 0.2)):
    """Pick the utility-maximizing config from the front (Eq. 3/4).
    All four objectives are normalized to the front's range."""
    front = archive.front()
    if not front:
        return None, None
    objs = np.array([o for _, o in front])
    acc_hi = max(objs[:, 0].max(), 1e-9)
    norms = [acc_hi, max(objs[:, 1].max(), 1e-9),
             max(objs[:, 2].max(), 1e-9), max(objs[:, 3].max(), 1e-9)]
    scores = [utility([o[0] / acc_hi, o[1], o[2], o[3]], weights, norms)
              for o in objs]
    i = int(np.argmax(scores))
    return front[i]


def recommend_efficient(archive: ParetoArchive, base_obj, *,
                        max_acc_drop: float = 1.1):
    """The paper's Table-2 selection: the config maximizing the Efficiency
    Score subject to accuracy within ``max_acc_drop`` points of Default
    (1.1 leaves margin under the paper's 1.2% budget).  If nothing on
    the front satisfies the budget, fall back to the most accurate
    config rather than the fastest."""
    from repro_torch.core.pareto import efficiency_score
    front = archive.front()
    if not front:
        return None, None
    ok = [(c, o) for c, o in front if o[0] >= base_obj[0] - max_acc_drop]
    if not ok:
        ok = [max(front, key=lambda t: t[1][0])]
    scored = [(efficiency_score(o, base_obj), c, o) for c, o in ok]
    scored.sort(key=lambda t: -t[0])
    _, c, o = scored[0]
    return c, o
