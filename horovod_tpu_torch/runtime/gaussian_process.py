"""Gaussian-process regression for the autotuner (this package's copy of
``horovod_tpu/runtime/gaussian_process.py``: numpy only, so the same
inputs give the same bits in both packages).

Parity with reference ``horovod/common/optim/gaussian_process.{h,cc}``
(~350 LoC, Eigen): GP regression with an RBF kernel and observation
noise, used exclusively by the parameter manager's Bayesian
optimization.  The reference optimizes kernel hyperparameters with
L-BFGS (vendored ``third_party/lbfgs``); here a small grid search over
the length scale maximizing the log marginal likelihood plays that
role — same model, simpler optimizer, no native dependency.
"""

from __future__ import annotations

import numpy as np


def _rbf(a: np.ndarray, b: np.ndarray, length_scale: float,
         signal_var: float) -> np.ndarray:
    """k(x, x') = sigma_f^2 * exp(-|x - x'|^2 / (2 l^2))."""
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return signal_var * np.exp(-0.5 * d2 / (length_scale ** 2))


class GaussianProcess:
    """GP posterior over noisy scalar observations of a black-box
    function on [0, 1]^d (inputs are normalized by the caller)."""

    def __init__(self, noise: float = 0.8) -> None:
        self.noise = float(noise)
        self._x: np.ndarray | None = None
        self._alpha: np.ndarray | None = None
        self._chol: np.ndarray | None = None
        self.length_scale = 1.0
        self.signal_var = 1.0
        self._y_mean = 0.0
        self._y_std = 1.0

    # -- fitting -----------------------------------------------------------

    def _log_marginal(self, x, y, ls) -> float:
        k = _rbf(x, x, ls, self.signal_var)
        k[np.diag_indices_from(k)] += self.noise ** 2 + 1e-10
        try:
            chol = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            return -np.inf
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, y))
        return float(-0.5 * y @ alpha - np.log(np.diag(chol)).sum()
                     - 0.5 * len(y) * np.log(2 * np.pi))

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).ravel()
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        # Hyperparameter "optimization": grid over length scales
        # (stand-in for the reference's L-BFGS over the kernel params).
        grid = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0)
        self.length_scale = max(
            grid, key=lambda ls: self._log_marginal(x, yn, ls))
        k = _rbf(x, x, self.length_scale, self.signal_var)
        k[np.diag_indices_from(k)] += self.noise ** 2 + 1e-10
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yn))
        self._x = x

    # -- prediction --------------------------------------------------------

    def predict(self, xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior (mean, std) at query points, in original y units."""
        xs = np.atleast_2d(np.asarray(xs, dtype=np.float64))
        if self._x is None:
            return (np.full(len(xs), self._y_mean),
                    np.full(len(xs), self._y_std))
        ks = _rbf(xs, self._x, self.length_scale, self.signal_var)
        mean = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = self.signal_var - (v ** 2).sum(0)
        var = np.maximum(var, 1e-12)
        return (mean * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)
