"""Bayesian-optimization search over strategy tunables.

Copy of ``dlrover_tpu/accelerate/bayes_search.py`` (numpy, with
``math.erf`` where the reference takes scipy's): with the same seed and
the same observations it suggests the same configs in the same order.
``tune_strategy`` times through the port's ``dry_runner.time_strategy``,
whose times every rank of a world shares, so every rank tunes to the
same config.

Reference parity: the strategy-generation engine's BO algorithm
(``atorch/atorch/auto/engine/sg_algo/bayes_opt_sg.py`` with its
vendored HEBO GP library).  The mesh *factorization* is already
enumerated and ranked analytically (``strategy.generate_candidates``)
and raced by successive halving (``search.successive_halving``); what
is left genuinely black-box are the TUNABLES inside a chosen
factorization — gradient-accumulation micro steps, remat policy,
GPipe microbatch count, flash-attention block sizes — whose cost
surface (compile-time x step-time x memory cliffs) no analytic model
predicts well.  That is the space this module searches.

The surrogate is a small exact Gaussian process (RBF kernel, Cholesky
solve — the space is tens of points, so an exact GP is cheaper and
more predictable than any approximation) with expected improvement as
the acquisition function.  Everything is numpy; no solver or GP
library exists in the image, and none is needed at this scale.
"""

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger


class GaussianProcess:
    """Exact GP regression with an RBF kernel on [0,1]^d inputs.

    Hyperparameters are fixed rather than optimized (lengthscale 0.3 of
    the unit cube, noise 1e-4 of signal variance): with <=a few dozen
    observations of a smooth-ish cost surface, marginal-likelihood
    optimization adds failure modes, not accuracy."""

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-4):
        self.ls = lengthscale
        self.noise = noise
        self._x: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = np.sum(
            (a[:, None, :] - b[None, :, :]) ** 2, axis=-1
        )
        return np.exp(-0.5 * d2 / (self.ls**2))

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        self._y_mean = float(np.mean(y))
        self._y_std = float(np.std(y)) or 1.0
        yn = (y - self._y_mean) / self._y_std
        k = self._k(self._x, self._x)
        k[np.diag_indices_from(k)] += self.noise
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yn)
        )

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and std (de-standardized) at query points."""
        x = np.asarray(x, np.float64)
        ks = self._k(x, self._x)
        mean = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.clip(1.0 - np.sum(v * v, axis=0), 1e-12, None)
        return (
            mean * self._y_std + self._y_mean,
            np.sqrt(var) * self._y_std,
        )


#: the error function elementwise; the reference takes scipy's, which
#: the port does not depend on (the two agree to a few ulp)
_erf = np.vectorize(math.erf, otypes=[np.float64])


def _phi_cdf(z: np.ndarray) -> np.ndarray:
    # standard normal cdf via erf, as the reference computes it
    return 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))


def _phi_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)


def expected_improvement(
    mean: np.ndarray, std: np.ndarray, best: float
) -> np.ndarray:
    """EI for MINIMIZATION: E[max(best - f, 0)]."""
    z = (best - mean) / std
    return (best - mean) * _phi_cdf(z) + std * _phi_pdf(z)


class BayesOpt:
    """Sequential minimizer over a discrete config space.

    ``space`` maps knob name -> ordered value list; every knob is
    treated as ordinal and embedded at its normalized index in [0,1]
    (micro steps, block sizes and remat aggressiveness are all
    monotone-ish axes, which is what makes the RBF metric meaningful).

    >>> bo = BayesOpt({"micro": [1, 2, 4], "remat": ["none", "dots",
    ...                "full"]}, seed=0)
    >>> cfg = bo.suggest(); bo.observe(cfg, measured_cost)
    """

    def __init__(
        self,
        space: Dict[str, Sequence],
        seed: int = 0,
        n_init: int = 4,
    ):
        self.space = {k: list(v) for k, v in space.items()}
        self.names = sorted(self.space)
        grid = list(
            itertools.product(*(self.space[n] for n in self.names))
        )
        self._configs: List[Dict] = [
            dict(zip(self.names, combo)) for combo in grid
        ]
        self._embed = np.array(
            [self._encode(c) for c in self._configs], np.float64
        )
        self._rng = np.random.RandomState(seed)
        self._order = self._rng.permutation(len(self._configs))
        self.n_init = min(n_init, len(self._configs))
        self._observed: Dict[int, float] = {}
        self._failed_cost: Optional[float] = None

    def _encode(self, config: Dict) -> List[float]:
        out = []
        for n in self.names:
            vals = self.space[n]
            idx = vals.index(config[n])
            out.append(
                idx / (len(vals) - 1) if len(vals) > 1 else 0.0
            )
        return out

    def _index_of(self, config: Dict) -> int:
        for i, c in enumerate(self._configs):
            if c == config:
                return i
        raise KeyError(f"config not in space: {config}")

    def suggest(self) -> Optional[Dict]:
        """Next config to evaluate; None when the space is exhausted."""
        unobserved = [
            i for i in range(len(self._configs))
            if i not in self._observed
        ]
        if not unobserved:
            return None
        if len(self._observed) < self.n_init:
            for i in self._order:
                if i not in self._observed:
                    return dict(self._configs[i])
        x = self._embed[sorted(self._observed)]
        y = np.array(
            [self._observed[i] for i in sorted(self._observed)]
        )
        gp = GaussianProcess()
        gp.fit(x, y)
        cand = self._embed[unobserved]
        mean, std = gp.predict(cand)
        ei = expected_improvement(mean, std, float(np.min(y)))
        return dict(self._configs[unobserved[int(np.argmax(ei))]])

    def observe(self, config: Dict, cost: Optional[float]) -> None:
        """Record a measurement; ``None``/inf marks a failed build and
        is encoded as worse-than-anything-seen so the GP steers away
        without poisoning the scale."""
        idx = self._index_of(config)
        if cost is None or not np.isfinite(cost):
            seen = [
                v for v in self._observed.values() if np.isfinite(v)
            ]
            cost = (max(seen) if seen else 1.0) * 2.0
        self._observed[idx] = float(cost)

    def best(self) -> Tuple[Optional[Dict], float]:
        if not self._observed:
            return None, float("inf")
        idx = min(self._observed, key=self._observed.get)
        return dict(self._configs[idx]), self._observed[idx]


def tune_strategy(
    build_fn: Callable,
    base,
    space: Dict[str, Sequence],
    budget: int = 8,
    seed: int = 0,
    time_fn: Optional[Callable] = None,
):
    """BO-tune a chosen mesh factorization's tunable knobs.

    ``base`` is a ``Strategy``; each knob in ``space`` must be a field
    of it (e.g. ``num_micro_steps``, ``remat``, ``pipe_microbatches``).
    ``build_fn`` is the same builder the dry runner uses.  Returns
    ``(best_strategy, history)`` where history maps describe->cost.
    """
    from dlrover_tpu_torch.accelerate.dry_runner import time_strategy

    timer = time_fn or time_strategy
    bo = BayesOpt(space, seed=seed)
    history: Dict[str, Optional[float]] = {}
    for _ in range(budget):
        cfg = bo.suggest()
        if cfg is None:
            break
        candidate = dataclasses.replace(base, **cfg)
        cost = timer(build_fn, candidate)
        history[repr(sorted(cfg.items()))] = cost
        bo.observe(cfg, cost)
        logger.info(
            "bayes-tune %s -> %s", cfg, f"{cost:.4f}s" if cost else "fail"
        )
    best_cfg, _ = bo.best()
    if best_cfg is None:
        return base, history
    return dataclasses.replace(base, **best_cfg), history
