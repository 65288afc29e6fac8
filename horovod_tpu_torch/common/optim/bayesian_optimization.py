"""Expected-improvement Bayesian optimization (parity:
``horovod/common/optim/bayesian_optimization.h:45-106``).

Suggests the next (fusion threshold, cycle time) sample by maximizing EI
over the GP posterior. The reference maximizes EI with L-BFGS restarts;
at 2 dimensions dense random candidate sampling finds the same argmax and
keeps this NumPy-only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .gaussian_process import GaussianProcessRegressor


class BayesianOptimization:
    def __init__(self, bounds: List[Tuple[float, float]],
                 alpha: float = 1e-8, xi: float = 0.01, seed: int = 0):
        self.bounds = np.asarray(bounds, np.float64)
        self.dim = len(bounds)
        self.xi = xi
        self._gp = GaussianProcessRegressor(alpha=alpha)
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []
        self._rng = np.random.RandomState(seed)

    def add_sample(self, x, y: float) -> None:
        self._xs.append(np.asarray(x, np.float64).reshape(-1))
        self._ys.append(float(y))
        self._gp.fit(np.stack(self._xs), np.asarray(self._ys))

    def _expected_improvement(self, cand: np.ndarray) -> np.ndarray:
        from math import erf, sqrt

        mu, std = self._gp.predict(cand)
        best = max(self._ys)
        imp = mu - best - self.xi
        z = imp / std
        # Normal CDF/PDF without scipy.
        cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
        pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
        ei = imp * cdf + std * pdf
        ei[std < 1e-10] = 0.0
        return ei

    def suggest(self, n_candidates: int = 2000) -> np.ndarray:
        """Next point to sample (normalized to ``bounds``)."""
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        if not self._xs:
            return lo + self._rng.rand(self.dim) * (hi - lo)
        cand = lo + self._rng.rand(n_candidates, self.dim) * (hi - lo)
        ei = self._expected_improvement(cand)
        return cand[int(np.argmax(ei))]

    def best(self) -> Tuple[Optional[np.ndarray], float]:
        if not self._ys:
            return None, float("-inf")
        i = int(np.argmax(self._ys))
        return self._xs[i], self._ys[i]
