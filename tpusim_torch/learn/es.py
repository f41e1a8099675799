"""Seeded antithetic OpenAI-ES over the continuous weight vector
(counterpart of tpusim/learn/es.py, the same draws under the same seed).

The estimator of Salimans et al. ("Evolution Strategies as a Scalable
Alternative to RL") with the two standard variance reductions: mirrored
(antithetic) sampling — each draw eps contributes candidates mean±sigma*eps
— and centered-rank fitness shaping, which makes the update invariant to
monotone transforms of the objective (gpu_alloc percents and frag
percents need no calibration against each other).

Determinism contract (the tuning log's byte-identity hinges on it): the
generation-g perturbations come from `np.random.default_rng([seed, g])`
— a pure function of (seed, gen), independent of call history — so
`ask`/`tell` never carry RNG state, a resumed run re-derives exactly the
draws the interrupted run would have made, and `state_dict()` is just
(mean, sigma, lr): plain floats that round-trip JSON exactly.
"""

from __future__ import annotations

import numpy as np


def centered_ranks(scores) -> np.ndarray:
    """Fitness shaping: scores -> ranks scaled into [-0.5, 0.5] (ties
    broken by candidate index — deterministic). The mean-zero property
    makes the antithetic pairs cancel their common component exactly."""
    s = np.asarray(scores, np.float64)
    n = s.size
    ranks = np.empty(n, np.float64)
    ranks[np.argsort(s, kind="stable")] = np.arange(n, dtype=np.float64)
    if n == 1:
        return np.zeros(1, np.float64)
    return ranks / (n - 1) - 0.5


class OpenAIES:
    """Maximize f over R^d: ask(gen) -> [popsize, d] candidates,
    tell(gen, scores) updates the mean. popsize must be even (antithetic
    halves)."""

    algo = "es"

    def __init__(self, x0, sigma: float = 250.0, lr: float = 300.0,
                 popsize: int = 8, seed: int = 0):
        self.mean = np.asarray(x0, np.float64).copy()
        if self.mean.ndim != 1:
            raise ValueError(f"x0 must be a vector, got shape {self.mean.shape}")
        if popsize < 2 or popsize % 2:
            raise ValueError(f"popsize must be even and >= 2, got {popsize}")
        self.sigma = float(sigma)
        self.lr = float(lr)
        self.popsize = int(popsize)
        self.seed = int(seed)

    def _eps(self, gen: int) -> np.ndarray:
        """The generation's mirrored perturbations [popsize, d] — a pure
        function of (seed, gen), see module docstring."""
        rng = np.random.default_rng([self.seed, int(gen)])
        half = rng.standard_normal((self.popsize // 2, self.mean.size))
        return np.concatenate([half, -half], axis=0)

    def ask(self, gen: int) -> np.ndarray:
        return self.mean[None, :] + self.sigma * self._eps(gen)

    def tell(self, gen: int, scores) -> None:
        scores = np.asarray(scores, np.float64)
        if scores.shape != (self.popsize,):
            raise ValueError(
                f"scores must have shape ({self.popsize},), got "
                f"{scores.shape}"
            )
        util = centered_ranks(scores)
        eps = self._eps(gen)
        # normalized ascent direction (rank utilities are dimensionless,
        # |direction| = O(1)); lr is therefore in WEIGHT units — the mean
        # moves at most ~lr/2 per generation through the i32 operand
        # space, regardless of sigma
        direction = util @ eps / self.popsize
        self.mean = self.mean + self.lr * direction

    # ---- resumable state (tuning-log vocabulary) ----

    def state_dict(self) -> dict:
        return {
            "algo": self.algo,
            "mean": [float(x) for x in self.mean],
            "sigma": float(self.sigma),
            "lr": float(self.lr),
        }

    def load_state(self, state: dict) -> None:
        if state.get("algo") != self.algo:
            raise ValueError(
                f"state is for algo {state.get('algo')!r}, not {self.algo!r}"
            )
        mean = np.asarray(state["mean"], np.float64)
        if mean.shape != self.mean.shape:
            raise ValueError(
                f"state mean has shape {mean.shape}, expected "
                f"{self.mean.shape}"
            )
        self.mean = mean
        self.sigma = float(state["sigma"])
        self.lr = float(state["lr"])
