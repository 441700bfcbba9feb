"""Gradient-boosted regression trees, from scratch (numpy).

The port's copy of ``repro/core/surrogate.py``.

The paper's Phase-1 predictive models (§3.3.1): one GBT per objective
o ∈ {Acc, Lat, Mem, Energy}, features = encode(config) ⊕ φ(M) ⊕ ψ(T);
ensembles of GBTs (bootstrap) give the prediction variance that drives
Algorithm 1's uncertainty-targeted refinement.

Least-squares boosting: each stage fits a depth-limited CART tree to the
current residuals; histogram-free exact split search (feature dims are
tiny — ~30).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0
    is_leaf: bool = True


class RegressionTree:
    def __init__(self, max_depth: int = 4, min_samples: int = 4):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.nodes: List[_Node] = []

    def fit(self, x: np.ndarray, y: np.ndarray):
        self.nodes = []
        self._build(x, y, depth=0)
        return self

    def _build(self, x, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(np.mean(y))))
        if depth >= self.max_depth or len(y) < self.min_samples or \
                np.var(y) < 1e-12:
            return idx
        best = self._best_split(x, y)
        if best is None:
            return idx
        f, t = best
        mask = x[:, f] <= t
        node = self.nodes[idx]
        node.feature, node.threshold, node.is_leaf = f, t, False
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return idx

    def _best_split(self, x, y):
        n, d = x.shape
        total = y.sum()
        total_sq = (y ** 2).sum()
        best_gain, best = 1e-12, None
        for f in range(d):
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            csum = np.cumsum(ys)[:-1]
            cnt = np.arange(1, n)
            valid = xs[:-1] < xs[1:]          # split between distinct values
            if not valid.any():
                continue
            left_mean = csum / cnt
            right_mean = (total - csum) / (n - cnt)
            # variance reduction = n_l*m_l^2 + n_r*m_r^2 - n*m^2 (up to const)
            gain = cnt * left_mean ** 2 + (n - cnt) * right_mean ** 2
            gain = np.where(valid, gain, -np.inf)
            j = int(np.argmax(gain))
            g = gain[j] - total ** 2 / n
            if g > best_gain:
                best_gain = g
                best = (f, float((xs[j] + xs[j + 1]) / 2))
        return best

    def predict(self, x: np.ndarray) -> np.ndarray:
        out = np.empty(len(x))
        for i, row in enumerate(x):
            ni = 0
            while not self.nodes[ni].is_leaf:
                nd = self.nodes[ni]
                ni = nd.left if row[nd.feature] <= nd.threshold else nd.right
            out[i] = self.nodes[ni].value
        return out


class GradientBoostedTrees:
    """Least-squares GBT (paper Appendix A.1: 500 estimators, depth 8,
    lr 0.05, subsample 0.8 — defaults here are lighter for CPU)."""

    def __init__(self, n_estimators: int = 120, max_depth: int = 4,
                 learning_rate: float = 0.08, subsample: float = 0.8,
                 seed: int = 0):
        self.n = n_estimators
        self.depth = max_depth
        self.lr = learning_rate
        self.subsample = subsample
        self.rng = np.random.default_rng(seed)
        self.trees: List[RegressionTree] = []
        self.base = 0.0

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        self.base = float(np.mean(y))
        pred = np.full(len(y), self.base)
        self.trees = []
        for _ in range(self.n):
            resid = y - pred
            if self.subsample < 1.0:
                m = self.rng.random(len(y)) < self.subsample
                if m.sum() < 4:
                    m[:] = True
            else:
                m = np.ones(len(y), bool)
            t = RegressionTree(self.depth).fit(x[m], resid[m])
            pred = pred + self.lr * t.predict(x)
            self.trees.append(t)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        out = np.full(len(x), self.base)
        for t in self.trees:
            out += self.lr * t.predict(x)
        return out

    def r2(self, x, y) -> float:
        y = np.asarray(y, np.float64)
        p = self.predict(x)
        ss = np.sum((y - p) ** 2)
        tot = np.sum((y - np.mean(y)) ** 2)
        return 1.0 - ss / max(tot, 1e-12)


class SurrogateEnsemble:
    """K bootstrap GBTs; mean prediction + epistemic variance."""

    def __init__(self, k: int = 4, seed: int = 0, **gbt_kw):
        self.k = k
        self.seed = seed
        self.gbt_kw = gbt_kw
        self.members: List[GradientBoostedTrees] = []
        # additive output offset (log-space objectives: a multiplicative
        # recalibration) — set by AutoTuner.recalibrate when measured
        # profile corrections arrive after this ensemble was fit
        self.offset = 0.0

    def fit(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        self.members = []
        for i in range(self.k):
            idx = rng.integers(0, len(y), len(y))
            g = GradientBoostedTrees(seed=self.seed + i, **self.gbt_kw)
            g.fit(x[idx], y[idx])
            self.members.append(g)
        return self

    def predict(self, x):
        preds = np.stack([m.predict(x) for m in self.members])
        return preds.mean(0) + self.offset, preds.std(0)

    def shift(self, delta: float):
        """Recalibrate the ensemble's level without a refit: add
        ``delta`` to every mean prediction.  For objectives fit in log
        space this is an exact multiplicative correction — how measured
        cost-model drift (CalibratedCostModel) re-ranks a front whose
        surrogates were trained on uncalibrated analytic evals."""
        self.offset += float(delta)
        return self

    def update(self, x_new, y_new, x_all, y_all):
        """Refit on the extended dataset (Algorithm 1 line 6)."""
        return self.fit(np.concatenate([x_all, x_new]),
                        np.concatenate([y_all, y_new]))
