"""Minimal diagonal (separable) CMA-ES over the weight vector
(counterpart of tpusim/learn/cma.py, the same draws under the same seed).

sep-CMA-ES (Ros & Hansen 2008): the full covariance is restricted to its
diagonal, which drops the update to O(d) and — with policy-weight
dimensions in the single digits — loses nothing while keeping CMA's two
adaptations ES lacks: per-dimension step sizes (frag-weight and
alloc-weight live on very different sensitivity scales) and cumulative
step-size control (fast on the separable objectives the tuning surface
largely is; value-function-based optimization, arxiv 2011.14486,
motivates exactly this sample-efficient gradient-free loop).

Same determinism contract as learn.es: the generation-g draws come from
`np.random.default_rng([seed, g])`, so tell() regenerates the z it needs
instead of carrying it, and `state_dict()` is the full strategy state
(mean, sigma, diagonal C, both evolution paths) as JSON-exact floats —
a resumed run continues bit-identically.
"""

from __future__ import annotations

import math

import numpy as np


class DiagonalCMA:
    """Maximize f over R^d: ask(gen) -> [popsize, d], tell(gen, scores).

    Standard CMA constants (Hansen's tutorial) with the sep-CMA c_mu
    boost (d+2)/3; recombination over the top half with log weights."""

    algo = "cma"

    def __init__(self, x0, sigma: float = 250.0, popsize: int = 8,
                 seed: int = 0):
        self.mean = np.asarray(x0, np.float64).copy()
        if self.mean.ndim != 1:
            raise ValueError(f"x0 must be a vector, got shape {self.mean.shape}")
        d = self.mean.size
        if popsize < 4:
            raise ValueError(f"popsize must be >= 4, got {popsize}")
        self.popsize = int(popsize)
        self.seed = int(seed)
        self.sigma = float(sigma)

        mu = self.popsize // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        self.weights = w / w.sum()  # [mu], positive, sums to 1
        self.mu_eff = float(1.0 / (self.weights ** 2).sum())

        self.cs = (self.mu_eff + 2.0) / (d + self.mu_eff + 5.0)
        self.ds = (
            1.0
            + 2.0 * max(0.0, math.sqrt((self.mu_eff - 1.0) / (d + 1.0)) - 1.0)
            + self.cs
        )
        self.cc = (4.0 + self.mu_eff / d) / (d + 4.0 + 2.0 * self.mu_eff / d)
        self.c1 = 2.0 / ((d + 1.3) ** 2 + self.mu_eff)
        cmu = min(
            1.0 - self.c1,
            2.0 * (self.mu_eff - 2.0 + 1.0 / self.mu_eff)
            / ((d + 2.0) ** 2 + self.mu_eff),
        )
        # sep-CMA: the diagonal restriction frees degrees of freedom, so
        # the rank-mu rate grows by (d+2)/3 (Ros & Hansen eq. 4)
        self.cmu = min(1.0 - self.c1, cmu * (d + 2.0) / 3.0)
        self.chi_n = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d)
                                     + 1.0 / (21.0 * d * d))

        self.C = np.ones(d, np.float64)  # diagonal covariance
        self.ps = np.zeros(d, np.float64)  # step-size path
        self.pc = np.zeros(d, np.float64)  # covariance path
        self.gens_told = 0  # drives the hsig normalizer

    def _z(self, gen: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, int(gen)])
        return rng.standard_normal((self.popsize, self.mean.size))

    def ask(self, gen: int) -> np.ndarray:
        y = self._z(gen) * np.sqrt(self.C)[None, :]
        return self.mean[None, :] + self.sigma * y

    def tell(self, gen: int, scores) -> None:
        scores = np.asarray(scores, np.float64)
        if scores.shape != (self.popsize,):
            raise ValueError(
                f"scores must have shape ({self.popsize},), got "
                f"{scores.shape}"
            )
        d = self.mean.size
        z = self._z(gen)
        y = z * np.sqrt(self.C)[None, :]
        # maximize: best first; stable sort keeps ties deterministic
        order = np.argsort(-scores, kind="stable")[: self.weights.size]
        yw = self.weights @ y[order]  # [d]
        zw = self.weights @ z[order]  # [d] == C^{-1/2} yw, diagonally

        self.mean = self.mean + self.sigma * yw

        self.ps = (1.0 - self.cs) * self.ps + math.sqrt(
            self.cs * (2.0 - self.cs) * self.mu_eff
        ) * zw
        self.gens_told += 1
        ps_norm = float(np.linalg.norm(self.ps))
        hsig = ps_norm / math.sqrt(
            1.0 - (1.0 - self.cs) ** (2.0 * self.gens_told)
        ) < (1.4 + 2.0 / (d + 1.0)) * self.chi_n
        self.pc = (1.0 - self.cc) * self.pc + (
            math.sqrt(self.cc * (2.0 - self.cc) * self.mu_eff) * yw
            if hsig else 0.0
        )

        rank_mu = self.weights @ (y[order] ** 2)  # diagonal rank-mu term
        self.C = (
            (1.0 - self.c1 - self.cmu) * self.C
            + self.c1 * (
                self.pc ** 2
                + (0.0 if hsig else self.cc * (2.0 - self.cc)) * self.C
            )
            + self.cmu * rank_mu
        )
        # numerical floor: a collapsed axis would freeze the draw there
        self.C = np.maximum(self.C, 1e-20)
        self.sigma = self.sigma * math.exp(
            (self.cs / self.ds) * (ps_norm / self.chi_n - 1.0)
        )

    # ---- resumable state (tuning-log vocabulary) ----

    def state_dict(self) -> dict:
        return {
            "algo": self.algo,
            "mean": [float(x) for x in self.mean],
            "sigma": float(self.sigma),
            "C": [float(x) for x in self.C],
            "ps": [float(x) for x in self.ps],
            "pc": [float(x) for x in self.pc],
            "gens_told": int(self.gens_told),
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
        self.C = np.asarray(state["C"], np.float64)
        self.ps = np.asarray(state["ps"], np.float64)
        self.pc = np.asarray(state["pc"], np.float64)
        self.gens_told = int(state["gens_told"])
