"""Measurement-calibrated mesh-dimension planner.

Copy of ``dlrover_tpu/accelerate/dim_planner.py`` (numpy over the
port's ``strategy.strategy_cost_terms``).

Reference parity: the profile-driven shard planners
(``atorch/atorch/auto/auto/shard_planners/dim_planner.py:238`` — device
mesh dims from profiling + dynamic programming — and the MIP TP planner
``mip_tp_planner.py:496``).  The reference profiles ops on a few GPUs,
then solves for the mesh shape to use at full scale.

The TPU translation: the strategy space is mesh factorizations whose
step time decomposes into a handful of physical terms (compute shard,
grad reduce, FSDP gathers, TP activation reductions, pipe bubble,
SP/EP hops — the same terms ``strategy.estimate_step_cost`` ranks by
analytically).  Instead of an ILP over an op graph (GSPMD already does
op-level placement), the planner:

1. expresses every candidate as a FEATURE VECTOR of those terms,
2. CALIBRATES per-term coefficients from a few timed dry runs at
   whatever scale is actually available (ridge regression toward the
   analytic prior — small-sample-safe),
3. ranks the full candidate space AT THE TARGET device count with the
   calibrated model — extrapolating measurements from an 8-device
   profile run to a 256-chip plan, which is exactly the reference
   planner's job.
"""

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.accelerate.analyser import ModelProfile
from dlrover_tpu_torch.accelerate.strategy import (
    FEATURE_NAMES,
    Strategy,
    generate_candidates,
    strategy_cost_terms,
)


def strategy_features(
    s: Strategy,
    profile: ModelProfile,
    batch_per_replica: int = 1,
    seq_len: int = 2048,
) -> np.ndarray:
    """Per-term second estimates (the analytic model of
    ``estimate_step_cost`` split into its addends); the calibrated
    planner learns a scale for each."""
    return np.asarray(
        strategy_cost_terms(s, profile, batch_per_replica, seq_len)
    )


@dataclass
class CalibratedPlanner:
    """Fit per-term coefficients from measured (strategy, step-time)
    pairs, then rank candidates — including at a DIFFERENT (larger)
    device count than the measurements were taken at."""

    profile: ModelProfile
    batch_per_replica: int = 1
    seq_len: int = 2048
    ridge: float = 1e-2

    def __post_init__(self):
        # analytic prior: every term at its modeled scale (weight 1)
        self.weights = np.ones(len(FEATURE_NAMES))

    def _features(self, s: Strategy) -> np.ndarray:
        return strategy_features(
            s, self.profile, self.batch_per_replica, self.seq_len
        )

    def calibrate(
        self, measurements: Sequence[Tuple[Strategy, float]]
    ) -> np.ndarray:
        """Ridge regression of measured step seconds onto the feature
        terms, shrunk toward the analytic prior (weight 1): with 2-3
        measurements most terms are unobserved and keep their prior;
        observed terms get rescaled by reality (e.g. an ICI link that
        delivers half the modeled bandwidth doubles its comm weights).
        Returns the fitted weights (also stored on self)."""
        meas = [
            (s, t) for s, t in measurements
            if t is not None and np.isfinite(t)
        ]
        if not meas:
            return self.weights
        F = np.stack([self._features(s) for s, _ in meas])
        y = np.array([t for _, t in meas])
        # column scaling so ridge strength is comparable across terms
        scale = np.maximum(np.abs(F).max(axis=0), 1e-12)
        Fn = F / scale
        lam = self.ridge * len(meas)
        # scaled weights ws = w * scale; prior w=1 -> ws = scale
        A = Fn.T @ Fn + lam * np.eye(F.shape[1])
        b = Fn.T @ y + lam * scale
        w_scaled = np.linalg.solve(A, b)
        self.weights = np.clip(w_scaled / scale, 0.0, None)
        return self.weights

    def predict(self, s: Strategy) -> float:
        return float(self._features(s) @ self.weights)

    def rank(
        self, candidates: Sequence[Strategy]
    ) -> List[Tuple[Strategy, float]]:
        scored = [(s, self.predict(s)) for s in candidates]
        scored.sort(key=lambda sv: sv[1])
        return scored

    def plan(
        self,
        n_devices: int,
        max_tensor: int = 8,
        long_context: bool = False,
        moe: bool = False,
        top_k: int = 5,
    ) -> List[Tuple[Strategy, float]]:
        """Candidate plans for ``n_devices`` (possibly >> the measured
        scale), ranked by the calibrated model — the reference dim
        planner's profile-small/plan-big flow."""
        cands = generate_candidates(
            self.profile,
            n_devices,
            max_tensor=max_tensor,
            long_context=long_context,
            moe=moe,
            batch_per_replica=self.batch_per_replica,
            seq_len=self.seq_len,
        )
        return self.rank(cands)[:top_k]
