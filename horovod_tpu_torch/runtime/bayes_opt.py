"""Bayesian optimization (expected improvement over a GP posterior):
this package's copy of ``horovod_tpu/runtime/bayes_opt.py``, numpy
only, with the same seeded candidate cloud.

Parity with reference ``horovod/common/optim/bayesian_optimization.{h,cc}``
(~258 LoC): propose the next knob setting to try by maximizing expected
improvement over discretized candidate points, given noisy throughput
observations.  Used only by
:mod:`horovod_tpu_torch.runtime.parameter_manager`.
"""

from __future__ import annotations

import numpy as np

from horovod_tpu_torch.runtime.gaussian_process import GaussianProcess


def expected_improvement(mean: np.ndarray, std: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI(x) = (mu - best - xi) Phi(z) + sigma phi(z), z = (mu-best-xi)/sigma."""
    imp = mean - best - xi
    z = np.where(std > 0, imp / np.where(std > 0, std, 1.0), 0.0)
    # standard normal cdf/pdf without a scipy dependency
    cdf = 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))
    pdf = np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)
    ei = imp * cdf + std * pdf
    return np.where(std > 0, ei, 0.0)


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz & Stegun 7.1.26, |err| < 1.5e-7)."""
    x = np.asarray(x, dtype=np.float64)
    sign = np.sign(x)
    ax = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * np.exp(-ax * ax))


class BayesianOptimization:
    """Sequential model-based search over [0, 1]^d.

    The caller owns the mapping from unit coordinates to physical knob
    values; binary dims are rounded by the caller.
    """

    def __init__(self, dims: int, noise: float = 0.8,
                 seed: int = 0) -> None:
        self.dims = dims
        self.gp = GaussianProcess(noise=noise)
        self._x: list[np.ndarray] = []
        self._y: list[float] = []
        self._rng = np.random.RandomState(seed)

    def add_sample(self, x: np.ndarray, y: float) -> None:
        self._x.append(np.asarray(x, dtype=np.float64))
        self._y.append(float(y))
        self.gp.fit(np.stack(self._x), np.asarray(self._y))

    def best(self) -> tuple[np.ndarray, float]:
        i = int(np.argmax(self._y))
        return self._x[i], self._y[i]

    def next_sample(self, n_candidates: int = 512) -> np.ndarray:
        """argmax-EI over a random candidate cloud (the reference
        discretizes each dim into test points; a dense random cloud is
        the same idea without the curse-of-dimensionality grid)."""
        if not self._x:
            return np.full(self.dims, 0.5)
        cand = self._rng.rand(n_candidates, self.dims)
        mean, std = self.gp.predict(cand)
        ei = expected_improvement(mean, std, max(self._y))
        return cand[int(np.argmax(ei))]
