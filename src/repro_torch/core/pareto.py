"""Pareto dominance, fronts, archive, and the paper's Efficiency Score.

The port's copy of ``repro/core/pareto.py`` (numpy only).

Objectives vector convention everywhere in core/: ``[acc, lat, mem, energy]``
with acc maximized and the rest minimized.  Internally we flip acc so all
four are minimized.
"""
from __future__ import annotations

from typing import List

import numpy as np


def to_min(objs: np.ndarray) -> np.ndarray:
    out = np.array(objs, np.float64)
    out[:, 0] = -out[:, 0]
    return out


def dominates(a: np.ndarray, b: np.ndarray) -> bool:
    """a dominates b (both min-convention vectors)."""
    return bool(np.all(a <= b) and np.any(a < b))


def non_dominated_sort(objs: np.ndarray) -> List[np.ndarray]:
    """Fast non-dominated sort (Deb 2002).  objs: (n, m) min-convention.
    Returns list of index arrays, front 0 first."""
    n = len(objs)
    s = [[] for _ in range(n)]
    counts = np.zeros(n, int)
    for i in range(n):
        for j in range(i + 1, n):
            if dominates(objs[i], objs[j]):
                s[i].append(j)
                counts[j] += 1
            elif dominates(objs[j], objs[i]):
                s[j].append(i)
                counts[i] += 1
    fronts = []
    cur = np.where(counts == 0)[0]
    while len(cur):
        fronts.append(cur)
        nxt = []
        for i in cur:
            for j in s[i]:
                counts[j] -= 1
                if counts[j] == 0:
                    nxt.append(j)
        cur = np.array(sorted(set(nxt)), int)
    return fronts


def crowding_distance(objs: np.ndarray) -> np.ndarray:
    n, m = objs.shape
    if n <= 2:
        return np.full(n, np.inf)
    d = np.zeros(n)
    for k in range(m):
        order = np.argsort(objs[:, k], kind="stable")
        lo, hi = objs[order[0], k], objs[order[-1], k]
        d[order[0]] = d[order[-1]] = np.inf
        if hi - lo < 1e-12:
            continue
        d[order[1:-1]] += (objs[order[2:], k] - objs[order[:-2], k]) / (hi - lo)
    return d


def pareto_front_mask(objs: np.ndarray) -> np.ndarray:
    fronts = non_dominated_sort(objs)
    mask = np.zeros(len(objs), bool)
    mask[fronts[0]] = True
    return mask


# ---------------------------------------------------------------------------
# Paper metrics


def efficiency_score(obj, baseline) -> float:
    """Paper §4.2: geometric mean of (baseline/val) over {lat, mem, energy},
    normalized by accuracy degradation.  obj/baseline = [acc,lat,mem,en]."""
    gains = [baseline[i] / max(obj[i], 1e-12) for i in (1, 2, 3)]
    geo = float(np.prod(gains)) ** (1.0 / 3.0)
    acc_pen = min(obj[0] / max(baseline[0], 1e-12), 1.0)
    return geo * acc_pen


def utility(obj, weights, norms) -> float:
    """Paper Eq. 4: U = w_acc·acc − Σ w_m · norm(m)."""
    w_acc, w_lat, w_mem, w_en = weights
    acc, lat, mem, en = obj
    return (w_acc * acc
            - w_lat * min(lat / norms[1], 1.0)
            - w_mem * min(mem / norms[2], 1.0)
            - w_en * min(en / norms[3], 1.0))


class ParetoArchive:
    """Maintains the non-dominated set across generations."""

    def __init__(self):
        self.configs: list = []
        self.objs: list = []

    def add(self, config, obj) -> bool:
        v = np.array(obj, np.float64)
        v[0] = -v[0]
        keep_c, keep_o = [], []
        for c, o in zip(self.configs, self.objs):
            if dominates(o, v):
                return False              # dominated by archive
            if not dominates(v, o):
                keep_c.append(c)
                keep_o.append(o)
        keep_c.append(config)
        keep_o.append(v)
        self.configs, self.objs = keep_c, keep_o
        return True

    def front(self):
        return [(c, np.array([-o[0], o[1], o[2], o[3]]))
                for c, o in zip(self.configs, self.objs)]
