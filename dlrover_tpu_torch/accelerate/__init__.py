"""``auto_accelerate`` of the port (``dlrover_tpu/accelerate``): one
card, or a mesh of ``data``, ``fsdp``, ``tensor``, ``seq`` and ``pipe``
axes over the world's ranks, its strategy pinned (and re-solved for a
new world), the analytic ranking's first, or searched by timed dry runs
agreed across the ranks (successive halving, Bayesian tuning, the
calibrated planner); and the strategy service."""

from dlrover_tpu_torch.accelerate.analyser import (
    ModelProfile,
    analyse_model,
)
from dlrover_tpu_torch.accelerate.api import (
    AccelerateResult,
    auto_accelerate,
)
from dlrover_tpu_torch.accelerate.bayes_search import (
    BayesOpt,
    tune_strategy,
)
from dlrover_tpu_torch.accelerate.dim_planner import CalibratedPlanner
from dlrover_tpu_torch.accelerate.engine_service import (
    StrategyClient,
    start_strategy_service,
)
from dlrover_tpu_torch.accelerate.search import successive_halving
from dlrover_tpu_torch.accelerate.solver import JointPlan
from dlrover_tpu_torch.accelerate.solver import solve as solve_joint_plan
from dlrover_tpu_torch.accelerate.strategy import Strategy, load_strategy

__all__ = [
    "AccelerateResult",
    "BayesOpt",
    "CalibratedPlanner",
    "JointPlan",
    "ModelProfile",
    "Strategy",
    "StrategyClient",
    "analyse_model",
    "auto_accelerate",
    "load_strategy",
    "solve_joint_plan",
    "start_strategy_service",
    "successive_halving",
    "tune_strategy",
]
