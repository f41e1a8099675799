"""Rollout backend of the tuning loop (counterpart of
tpusim/learn/rollout.py).

LocalRollout drives `Simulator.run_sweep`: a generation's population is one
lanes launch of the replay kernels (`replay_lanes`, or
`replay_blocked_lanes` under "hbm"), a lane a candidate, over tables built
once; the weights are lane operands, so every generation runs the kernel
library the first one loaded (`executables()` stays 1: the port's
counterpart of tpusim's one compiled sweep). The lane count is pinned to
`width`: a short or deduplicated population repeats its last row.

RemoteRollout, the service-backed backend, belongs to the service plane the
port does not have yet (ROADMAP queue 1, item 14).

Candidates live in the replays' i32 weight space: `project_weights` rounds
and clips the optimizer's float vectors, `dedup_rows` collapses integer
collisions so a generation never replays one vector twice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from tpusim_torch.learn.objective import lane_terms


def project_weights(xs, lo: int = 0, hi: int = 4000) -> np.ndarray:
    """Float candidates [B, d] -> the i32 weight space: round half to even,
    clip to [lo, hi]."""
    if hi <= lo:
        raise ValueError(f"need lo < hi, got [{lo}, {hi}]")
    return np.clip(np.rint(np.asarray(xs, np.float64)), lo, hi).astype(
        np.int32)


def dedup_rows(rows: np.ndarray) -> Tuple[List[tuple], List[int]]:
    """Integer candidate rows -> (unique rows in first-seen order, each
    candidate's index into them)."""
    uniq: List[tuple] = []
    index: dict = {}
    where: List[int] = []
    for row in np.asarray(rows, np.int32):
        key = tuple(int(w) for w in row)
        if key not in index:
            index[key] = len(uniq)
            uniq.append(key)
        where.append(index[key])
    return uniq, where


def make_family_sim(nodes, pods, policies, gpu_sel: str = "best",
                    norm: str = "max", dim_ext: str = "share",
                    engine: str = "auto", table_cache_dir: str = "",
                    device="cuda"):
    """A Simulator configured as tpusim's make_family_sim configures its
    own (deterministic prep, reporting off, seed 42), on `device`."""
    from tpusim_torch.sim.driver import Simulator, SimulatorConfig

    cfg = SimulatorConfig(
        policies=tuple((str(n), int(w)) for n, w in policies),
        gpu_sel_method=gpu_sel,
        norm_method=norm,
        dim_ext_method=dim_ext,
        engine=engine,
        report_per_event=False,
        shuffle_pod=False,
        seed=42,
        table_cache_dir=table_cache_dir,
    )
    sim = Simulator(nodes, cfg, device=device)
    sim.set_workload_pods(list(pods))
    return sim


def _library() -> str:
    """The kernel library the main path loaded ("plain" on the CPU, where
    the plain versions run)."""
    from tpusim_torch import kernels

    info = kernels._build_info.get("")
    return info.path if info is not None else "plain"


class LocalRollout:
    """Vectorized local backend: rollout(rows, seed) -> term dicts from one
    `run_sweep` of exactly `width` lanes. `fault`, a FaultConfig, makes each
    generation a chaos sweep under that one seeded fault schedule."""

    name = "local"

    def __init__(self, sim, width: int, bucket: int = 512, fault=None):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        if sim.cfg.heartbeat_every:
            raise ValueError(
                "LocalRollout needs a heartbeat-free Simulator "
                "(heartbeat_every=0): a sweep runs no heartbeat")
        self.fault = fault
        self.sim = sim
        self.width = int(width)
        self.bucket = int(bucket)
        self._libs: set = set()  # kernel libraries the rollouts ran

    def rollout(self, rows: Sequence[tuple], seed: int) -> List[dict]:
        if not rows:
            return []
        if len(rows) > self.width:
            raise ValueError(
                f"{len(rows)} unique candidates exceed the backend width "
                f"{self.width}")
        padded = list(rows) + [rows[-1]] * (self.width - len(rows))
        w = np.asarray(padded, np.int32)
        faults = [self.fault] * self.width if self.fault else None
        lanes = self.sim.run_sweep(
            w, seeds=[int(seed)] * self.width, bucket=self.bucket,
            faults=faults)[:len(rows)]
        self._libs.add(_library())
        return [lane_terms(lane) for lane in lanes]

    def executables(self) -> int:
        """Kernel libraries the rollouts ran: 1 for a whole tuning run (no
        rebuild between generations)."""
        return len(self._libs)


class RemoteRollout:
    """The service-backed backend (a `serve --jobs` endpoint)."""

    name = "remote"

    def __init__(self, url: str, *args, **kwargs):
        raise NotImplementedError(
            f"tune --url {url!r}: the port has no job service to roll out "
            "against yet (ROADMAP queue 1, item 14); run the rollouts "
            "locally")
