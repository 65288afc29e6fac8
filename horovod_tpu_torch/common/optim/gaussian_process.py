"""Gaussian-process regression with an RBF kernel (parity:
``horovod/common/optim/gaussian_process.h:46``).

The reference fits kernel hyperparameters with L-BFGS over Eigen matrices;
here the (tiny — tens of samples) GP is solved directly in NumPy with a
coarse grid search over the length scale, which reaches the same posterior
quality at this problem size without a native optimizer dependency.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class GaussianProcessRegressor:
    def __init__(self, alpha: float = 1e-8):
        # alpha: observation noise added to the kernel diagonal (the
        # reference's HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE plays this
        # role at the parameter-manager level).
        self.alpha = alpha
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._l: float = 1.0
        self._sigma_f: float = 1.0
        self._k_inv: Optional[np.ndarray] = None

    @staticmethod
    def _kernel(x1: np.ndarray, x2: np.ndarray, length: float,
                sigma_f: float) -> np.ndarray:
        d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
        return sigma_f ** 2 * np.exp(-0.5 * d2 / (length ** 2))

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64).reshape(-1)
        self._x, self._y = x, y
        self._y_mean = y.mean() if len(y) else 0.0
        yc = y - self._y_mean
        best = (np.inf, 1.0, max(yc.std(), 1e-3))
        # Marginal-likelihood grid search over the RBF length scale.
        for length in (0.1, 0.2, 0.5, 1.0, 2.0, 5.0):
            k = self._kernel(x, x, length, best[2]) + \
                self.alpha * np.eye(len(x))
            try:
                chol = np.linalg.cholesky(k)
            except np.linalg.LinAlgError:
                continue
            alpha_v = np.linalg.solve(chol.T, np.linalg.solve(chol, yc))
            nll = 0.5 * yc @ alpha_v + np.log(np.diag(chol)).sum()
            if nll < best[0]:
                best = (nll, length, best[2])
        self._l, self._sigma_f = best[1], best[2]
        k = self._kernel(x, x, self._l, self._sigma_f) + \
            self.alpha * np.eye(len(x))
        self._k_inv = np.linalg.inv(k)

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation at query points."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        if self._x is None or len(self._x) == 0:
            return np.zeros(len(x)), np.ones(len(x))
        ks = self._kernel(x, self._x, self._l, self._sigma_f)
        kss = self._kernel(x, x, self._l, self._sigma_f)
        mu = ks @ self._k_inv @ (self._y - self._y_mean) + self._y_mean
        cov = kss - ks @ self._k_inv @ ks.T
        std = np.sqrt(np.clip(np.diag(cov), 1e-12, None))
        return mu, std
