"""Strategy search over timed dry runs.

Copy of ``dlrover_tpu/accelerate/search.py`` over the port's
``dry_runner.time_strategy`` (which, over a world of several ranks,
hands every rank the same agreed times, so every rank keeps the same
field and crowns the same winner).

Reference parity: the acceleration engine's strategy-generation
search (``atorch/atorch/auto/engine/sg_algo/combination_sg.py``,
``bayes_opt_sg.py`` + vendored HEBO).  The reference searches a large
mixed space (wrap classes, fp modes, tunable knobs) where a GP
surrogate earns its keep; a strategy space of mesh factorizations is a
handful of candidates already ranked by an analytic cost model, so the
right search is **successive halving**: race all finalists for one
cheap step, keep the best half, re-race the survivors with more steps —
building a candidate dominates, so every candidate pays it exactly
once and the extra steps only go to plausible winners.

Each timing runs ``dry_runner.WARMUP_STEPS`` untimed steps first (the
reference passes one): the one-time costs a fresh state pays in its
first steps stay out of the race's numbers.
"""

import math
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.accelerate.dry_runner import time_strategy
from dlrover_tpu_torch.accelerate.strategy import Strategy
from dlrover_tpu_torch.common.log import default_logger as logger


def successive_halving(
    build_fn: Callable,
    candidates: List[Strategy],
    max_candidates: int = 6,
    first_steps: int = 1,
    final_steps: int = 5,
) -> Tuple[Optional[Strategy], Dict[str, List[float]]]:
    """Race the top candidates, halving the field each round while
    doubling the measured steps; returns
    (winner, {strategy: [per-round step seconds]}).

    Memory discipline: exactly ONE candidate's train state is live at a
    time — each timing builds, measures, and drops the candidate
    (``time_strategy``).  Candidates were admitted by a memory model
    sized for a single train state at 85% of the card's memory, so
    caching runners across rounds would OOM on the second build;
    survivors pay a rebuild per round instead, which the halving keeps
    to ~log2(field) extra builds on the plausible winners only."""
    field = list(candidates[:max_candidates])
    timings: Dict[str, List[float]] = {}
    steps = first_steps
    rounds = max(1, math.ceil(math.log2(max(len(field), 1))))
    for rnd in range(rounds):
        scored = []
        for s in field:
            t = time_strategy(build_fn, s, steps=steps)
            timings.setdefault(s.describe(), []).append(
                t if t is not None else float("nan")
            )
            if t is not None:
                scored.append((t, s))
        if not scored:
            return None, timings
        scored.sort(key=lambda ts: ts[0])
        keep = max(1, len(scored) // 2)
        field = [s for _, s in scored[:keep]]
        logger.info(
            "search round %d (%d steps): kept %s",
            rnd, steps, [s.describe() for s in field],
        )
        if len(field) == 1:
            break
        steps = min(final_steps, steps * 2)
    return field[0], timings
