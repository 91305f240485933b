"""Resource optimization: the Brain algorithm set for allreduce jobs.

Copy of ``dlrover_tpu/master/resource_optimizer.py`` (imports
rewritten), so that both packages' Brains make the same decisions and
journal the same state from the same signals.

Reference parity: the Go Brain service's optimizer-algorithm plugin
registry (``dlrover/go/brain/pkg/optimizer/implementation/
optalgorithm/``) restricted to the allreduce-relevant set, plus
``dlrover/python/master/resource/local_optimizer.py:66``
(``PSLocalOptimizer`` stage plans / OOM recovery ``:98`` /
worker-speed-ratio scaling ``:250``):

- worker-create        (``optimize_job_worker_create_resource.go``):
  the initial scale plan.
- worker-resource      (``optimize_job_worker_resource.go:400``):
  linear-model throughput extrapolation from SpeedMonitor samples —
  grow while the marginal speedup stays near-linear, settle back to
  the best-known world size on diminishing returns.
- worker-oom           (``optimize_job_worker_create_oom_resource.go``):
  relaunch OOM-killed workers with grown host memory.
- straggler-migrate    (``optimize_job_hot_ps_resource.go`` dual for
  allreduce): migrate nodes the network-check rounds flagged slow.

The unit of scaling is a whole worker node (its cards come with it),
so plans adjust *worker count* within [min, max].
"""

import threading
import time
from abc import ABCMeta, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import ScalePlan


@dataclass
class SpeedSample:
    worker_num: int
    records_per_sec: float


class JobStage:
    CREATE = "create"
    RUNNING = "running"


@dataclass
class JobMeta:
    """Everything an optimize algorithm may consult — the Brain's
    datastore row for one job, assembled by the auto-scaler each
    cycle."""

    stage: str = JobStage.RUNNING
    min_workers: int = 1
    max_workers: int = 1
    current_workers: int = 0
    # best observed throughput per world size (records/sec)
    speed_samples: Dict[int, float] = field(default_factory=dict)
    # node names the health-check rounds flagged as stragglers
    stragglers: List[str] = field(default_factory=list)
    # node name -> current memory MB for OOM-killed workers
    oom_nodes: Dict[str, int] = field(default_factory=dict)


class OptimizeAlgorithm(metaclass=ABCMeta):
    """One pluggable optimization rule (Brain's ``OptimizeAlgorithm``
    interface; plugins registered by name)."""

    name: str = ""

    @abstractmethod
    def optimize(self, meta: JobMeta) -> Optional[ScalePlan]:
        ...


_ALGORITHMS: Dict[str, type] = {}


def register_algorithm(cls):
    _ALGORITHMS[cls.name] = cls
    return cls


def get_algorithm(name: str) -> Optional[type]:
    return _ALGORITHMS.get(name)


@register_algorithm
class WorkerCreateResource(OptimizeAlgorithm):
    """Initial plan: launch the full worker window (elasticity shrinks
    later if throughput says so)."""

    name = "optimize_worker_create_resource"

    def optimize(self, meta: JobMeta) -> Optional[ScalePlan]:
        if meta.stage != JobStage.CREATE:
            return None
        plan = ScalePlan()
        plan.node_group_resources[NodeType.WORKER] = {
            "count": meta.max_workers
        }
        return plan


@register_algorithm
class WorkerResource(OptimizeAlgorithm):
    """Throughput-driven worker-count tuning.

    With >=3 observed world sizes the decision uses a FITTED scaling
    model extrapolated to unseen sizes (the reference Brain fits a
    linear throughput model over persisted history,
    ``optimize_job_worker_resource.go:400``): least-squares of
    ``n/speed = a + b*n`` — the Amdahl/serial-fraction form, linear in
    exactly the quantity a synchronous data-parallel job degrades in —
    then jump toward the LARGEST size whose predicted marginal gain
    still clears ``min_marginal_gain``.  The durable speed history
    (``master/datastore.py``) makes the fit meaningful across master
    restarts.

    With only 2 sizes, fall back to the local slope between them
    (the reference's worker-speed-ratio); while marginal throughput
    stays above the threshold, grow by up to 25% per cycle."""

    name = "optimize_worker_resource"

    # never jump more than this factor past the current size in one
    # plan: the fit extrapolates, reality gets a vote at each stop
    MAX_JUMP_FACTOR = 2.0

    def __init__(self, min_marginal_gain: float = 0.6,
                 growth_ratio: float = 0.25):
        self._gain = min_marginal_gain
        self._growth = growth_ratio

    def _fit_knee(self, samples: Dict[int, float],
                  max_workers: int) -> Optional[int]:
        """Fit n/speed = a + b*n; return the largest n whose predicted
        marginal gain clears the threshold (None = fit unusable)."""
        sizes = sorted(samples)
        xs = [float(n) for n in sizes]
        ys = [n / max(samples[n], 1e-9) for n in sizes]
        k = len(xs)
        sx, sy = sum(xs), sum(ys)
        sxx = sum(x * x for x in xs)
        sxy = sum(x * y for x, y in zip(xs, ys))
        denom = k * sxx - sx * sx
        if abs(denom) < 1e-12:
            return None
        b = (k * sxy - sx * sy) / denom
        a = (sy - b * sx) / k

        def speed(n: float) -> float:
            d = a + b * n
            return n / d if d > 1e-12 else 0.0

        if b <= 0:
            # no measurable serial fraction yet: predicted scaling is
            # (super)linear — the knee is past max_workers
            return max_workers
        best = None
        for n in range(1, max_workers + 1):
            per_worker = speed(n) / n
            marginal = (speed(n + 1) - speed(n)) / max(
                per_worker, 1e-12
            )
            if marginal >= self._gain:
                best = n + 1
        return best

    @staticmethod
    def _best_known(meta: JobMeta, tolerance: float = 0.05) -> int:
        """The SMALLEST size within ``tolerance`` of the peak observed
        throughput — scale-back exists to shed workers that buy almost
        nothing, so near-ties resolve to fewer workers."""
        if not meta.speed_samples:
            return meta.min_workers
        peak = max(meta.speed_samples.values())
        ok = [
            n
            for n, v in meta.speed_samples.items()
            if v >= (1.0 - tolerance) * peak
        ]
        return min(ok) if ok else meta.min_workers

    def optimize(self, meta: JobMeta) -> Optional[ScalePlan]:
        if meta.stage != JobStage.RUNNING:
            return None
        samples = meta.speed_samples
        if not samples:
            return None
        sizes = sorted(samples)
        # the ACTUAL world size, not the max-ever-sampled one: after a
        # settle the stale larger sample would otherwise re-emit the
        # same scale-back plan every cycle forever
        current = meta.current_workers or sizes[-1]
        if len(sizes) >= 3:
            target = self._fit_knee(samples, meta.max_workers)
            if target is not None:
                target = max(target, meta.min_workers)
                if target > current:
                    cap = int(current * self.MAX_JUMP_FACTOR)
                    count = min(target, cap, meta.max_workers)
                    if count == current:
                        return None  # capped at where we already are
                    plan = ScalePlan()
                    plan.node_group_resources[NodeType.WORKER] = {
                        "count": count
                    }
                    logger.info(
                        "fitted scaling model: knee at %d workers "
                        "(current %d)", target, current,
                    )
                    return plan
                if target < current:
                    settle = max(
                        min(target, self._best_known(meta)),
                        meta.min_workers,
                    )
                    if settle != current:
                        plan = ScalePlan()
                        plan.node_group_resources[
                            NodeType.WORKER
                        ] = {"count": settle}
                        logger.info(
                            "fitted scaling model: settling at %d "
                            "workers (current %d)", settle, current,
                        )
                        return plan
                return None  # already at the predicted knee
        if len(sizes) >= 2:
            # stop/settle decision uses the LOCAL slope between the two
            # largest observed sizes (the reference's worker-speed-ratio
            # compares speed before/after the last grow step) — a global
            # least-squares fit smooths the knee away and keeps growing
            # past it
            n0, n1 = sizes[-2], sizes[-1]
            local_slope = (samples[n1] - samples[n0]) / (n1 - n0)
            ref = current if current in samples else n1
            per_worker_now = samples[ref] / ref
            # marginal value of one more worker, as a fraction of the
            # current per-worker throughput (1.0 == perfectly linear)
            marginal = local_slope / max(per_worker_now, 1e-9)
            if marginal < self._gain:
                best_n = self._best_known(meta)
                if best_n != current:
                    plan = ScalePlan()
                    plan.node_group_resources[NodeType.WORKER] = {
                        "count": max(best_n, meta.min_workers)
                    }
                    logger.info(
                        "scale back to %d workers (marginal %.2f)",
                        best_n, marginal,
                    )
                    return plan
                return None  # diminishing returns: stop growing
        if current < meta.max_workers:
            step = max(1, int(current * self._growth))
            plan = ScalePlan()
            plan.node_group_resources[NodeType.WORKER] = {
                "count": min(current + step, meta.max_workers)
            }
            return plan
        return None


@register_algorithm
class WorkerOomResource(OptimizeAlgorithm):
    """Relaunch OOM-killed workers with grown host memory
    (reference ``local_optimizer.py:98`` OOM ladder)."""

    name = "optimize_worker_oom_resource"

    def __init__(self, oom_memory_factor: float = 1.5):
        self._factor = oom_memory_factor

    def optimize(self, meta: JobMeta) -> Optional[ScalePlan]:
        if not meta.oom_nodes:
            return None
        plan = ScalePlan()
        for node, memory_mb in meta.oom_nodes.items():
            plan.remove_nodes.append(node)
            plan.launch_nodes.append(
                {
                    "type": NodeType.WORKER,
                    "memory": int(memory_mb * self._factor),
                }
            )
        return plan


@register_algorithm
class StragglerMigrate(OptimizeAlgorithm):
    """Migrate nodes the health-check rounds flagged slow (the
    allreduce dual of hot-PS migration: a synchronous mesh runs at the
    slowest node's speed, so one straggler taxes the whole job)."""

    name = "optimize_straggler_migrate"

    def optimize(self, meta: JobMeta) -> Optional[ScalePlan]:
        if not meta.stragglers:
            return None
        plan = ScalePlan()
        for node in meta.stragglers:
            plan.migrate_nodes[str(node)] = {"type": NodeType.WORKER}
        return plan


def merge_plans(plans: List[Optional[ScalePlan]]) -> Optional[ScalePlan]:
    merged = ScalePlan()
    for p in plans:
        if p is None:
            continue
        merged.node_group_resources.update(p.node_group_resources)
        merged.launch_nodes.extend(p.launch_nodes)
        merged.remove_nodes.extend(p.remove_nodes)
        merged.migrate_nodes.update(p.migrate_nodes)
    return None if merged.is_empty() else merged


class ResourceOptimizer(metaclass=ABCMeta):
    @abstractmethod
    def generate_plan(self, stage: str) -> Optional[ScalePlan]:
        ...


class LocalAllreduceOptimizer(ResourceOptimizer):
    """The local Brain: runs the registered algorithm set against the
    job's observed state (reference ``BrainResoureOptimizer`` role
    without the external service; same algorithms, in-process)."""

    def __init__(
        self,
        min_workers: int = 1,
        max_workers: int = 1,
        min_marginal_gain: float = 0.6,
        oom_memory_factor: float = 1.5,
        datastore=None,
        job_name: str = "default",
    ):
        """``datastore``/``job_name``: persist speed samples per job
        (reference: the Go Brain's MySQL job-metrics recorders) so a
        restarted master's WorkerResource decisions start from the
        job's full observed speed curve, not an empty map.  Defaults
        to the process datastore when ``DLROVER_TPU_BRAIN_DB`` is
        set."""
        if datastore is None:
            from dlrover_tpu_torch.master.datastore import (
                get_default_datastore,
            )

            datastore = get_default_datastore()
        self._datastore = datastore
        self._job_name = job_name
        self._min = min_workers
        self._max = max_workers
        self._samples: Dict[int, float] = {}
        if datastore is not None:
            try:
                self._samples.update(
                    datastore.speed_history(job_name)
                )
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "speed-history restore failed: %s", e
                )
        self._current_workers = 0
        self._stragglers: List[str] = []
        self._oom_nodes: Dict[str, int] = {}
        self._algorithms: List[OptimizeAlgorithm] = [
            WorkerCreateResource(),
            WorkerResource(min_marginal_gain=min_marginal_gain),
            WorkerOomResource(oom_memory_factor=oom_memory_factor),
            StragglerMigrate(),
        ]
        self._oom_factor = oom_memory_factor

    # -- observation feeds (the Brain's datastore writes) ---------------
    def record_speed(self, worker_num: int, records_per_sec: float):
        if worker_num <= 0 or records_per_sec <= 0:
            return
        prev = self._samples.get(worker_num, 0.0)
        self._samples[worker_num] = max(prev, records_per_sec)
        self._current_workers = worker_num
        if self._datastore is not None and records_per_sec > prev:
            try:
                self._datastore.record_speed(
                    self._job_name, worker_num, records_per_sec
                )
            except Exception as e:  # noqa: BLE001
                logger.warning("speed persist failed: %s", e)

    def set_current_workers(self, worker_num: int):
        if worker_num > 0:
            self._current_workers = worker_num

    def report_stragglers(self, nodes: List[str]):
        self._stragglers = list(nodes)

    def report_oom(self, node_name: str, current_memory_mb: int):
        self._oom_nodes[node_name] = current_memory_mb

    # -- plan generation -------------------------------------------------
    def _meta(self, stage: str) -> JobMeta:
        sizes = sorted(self._samples)
        return JobMeta(
            stage=stage,
            min_workers=self._min,
            max_workers=self._max,
            current_workers=self._current_workers
            or (sizes[-1] if sizes else 0),
            speed_samples=dict(self._samples),
            stragglers=list(self._stragglers),
            oom_nodes=dict(self._oom_nodes),
        )

    def generate_plan(self, stage: str) -> Optional[ScalePlan]:
        meta = self._meta(stage)
        plans = [alg.optimize(meta) for alg in self._algorithms]
        plan = merge_plans(plans)
        # one-shot signals are consumed by the plan they produced
        self._stragglers = []
        self._oom_nodes = {}
        return plan

    def oom_recovery_plan(self, node_name: str,
                          current_memory_mb: int) -> ScalePlan:
        """Immediate OOM relaunch plan (outside the periodic cycle)."""
        self.report_oom(node_name, current_memory_mb)
        meta = self._meta(JobStage.RUNNING)
        plan = WorkerOomResource(self._oom_factor).optimize(meta)
        self._oom_nodes = {}
        return plan


# ---------------------------------------------------------------------------
# the observatory-fed Brain (DLROVER_TPU_BRAIN; ROADMAP item 1)
# ---------------------------------------------------------------------------
#
# The seed optimizer above reads one scalar (records/sec from the
# SpeedMonitor) and its only actuator is a pod-count plan.  The Brain
# variant below consumes the observatory derivations and the
# goodput ledger, and every verdict is a single explicit
# :class:`BrainDecision` the executor (``master/brain.py``) turns into
# ONE planned action — fence + cooperative drain + re-solve +
# resharded restore — instead of an emergent restart.  Rules:
#
# - confirmed straggler / hang-watchdog conclusion -> drain_replace
# - chronic data-stall share                        -> shrink
# - near-linear step-time scaling + spare capacity  -> grow
#
# Everything is hysteresis/cooldown-guarded, and the whole mutable
# rule state (streaks, last decision, the in-flight action) exports /
# restores through the ``ControlPlaneJournal`` so a master
# failover mid-action resumes or abandons it instead of flip-flopping.

#: BrainDecision.action vocabulary
ACTION_GROW = "grow"
ACTION_SHRINK = "shrink"
ACTION_DRAIN_REPLACE = "drain_replace"

#: capacity direction per action (hysteresis keys on it: an opposite-
#: direction decision needs twice the cooldown)
_DIRECTION = {
    ACTION_GROW: "up",
    ACTION_SHRINK: "down",
    ACTION_DRAIN_REPLACE: "down",
}

#: execution outcomes (scale_execute labels / journal records)
OUTCOME_DONE = "done"
OUTCOME_FENCED_FALLBACK = "fenced_fallback"
OUTCOME_ABANDONED = "abandoned"


@dataclass
class ObservatorySignals:
    """One decision cycle's inputs, assembled by the auto-scaler from
    the health engine + rendezvous manager + ledger (kept a plain
    dataclass so the rule tests feed it directly)."""

    #: node ranks of the latest completed world (rank order)
    world: List[int] = field(default_factory=list)
    min_nodes: int = 1
    max_nodes: int = 1
    #: (node, score) past the straggler ratio (HealthEngine.stragglers)
    stragglers: List[tuple] = field(default_factory=list)
    #: (node, silence_s) hang-watchdog verdicts
    hangs: List[tuple] = field(default_factory=list)
    #: node -> {stage: share} windowed data-stall shares
    stall_shares: Dict[int, Dict[str, float]] = field(
        default_factory=dict
    )
    #: across-node median step-time EWMA (0 = not enough steps yet)
    median_step_time_s: float = 0.0
    #: live preemption fences (nodes already on their way out)
    fenced: List[int] = field(default_factory=list)
    #: the executor can CREATE nodes (a scaler is attached)
    can_launch: bool = False
    #: goodput ledger snapshot (advisory context, journaled with the
    #: decision so every verdict carries the evidence it saw)
    goodput: float = 0.0
    #: wall clock (injected so rule tests control time)
    now: float = 0.0


@dataclass
class BrainDecision:
    """One planned action: what rule fired, against whom, and the
    world transition it intends.  Serialized verbatim into the
    journal and the ``scale_decision`` / ``scale_execute`` events."""

    decision_id: int = 0
    action: str = ""
    reason: str = ""
    node: int = -1  # target rank (drain/shrink victim; -1 for grow)
    from_world: int = 0
    to_world: int = 0
    made_at: float = 0.0
    goodput: float = 0.0

    @property
    def direction(self) -> str:
        return _DIRECTION.get(self.action, "none")

    def to_dict(self) -> dict:
        return {
            "decision_id": self.decision_id,
            "action": self.action,
            "reason": self.reason,
            "node": self.node,
            "from_world": self.from_world,
            "to_world": self.to_world,
            "made_at": self.made_at,
            "goodput": self.goodput,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "BrainDecision":
        known = {
            k: v
            for k, v in (data or {}).items()
            if k in cls.__dataclass_fields__
        }
        return cls(**known)


class ObservatoryBrainOptimizer:
    """The Brain's rule engine: ``decide()`` turns one cycle's
    :class:`ObservatorySignals` into at most ONE
    :class:`BrainDecision`, guarded by sustain streaks (a single
    noisy snapshot is not a verdict), a post-execution cooldown, and
    2x-cooldown hysteresis against direction flips.  All mutable
    state round-trips through ``export_state``/``restore_state`` (the
    journal component contract)."""

    #: step-time EWMA blend for the per-world scaling history
    HISTORY_ALPHA = 0.4

    def __init__(
        self,
        cooldown_s: Optional[float] = None,
        sustain_cycles: Optional[int] = None,
        stall_share_threshold: float = 0.3,
        linear_tolerance: float = 0.15,
        hysteresis_factor: float = 2.0,
    ):
        from dlrover_tpu_torch.common.env import (
            brain_cooldown_s,
            brain_sustain_cycles,
        )

        self.cooldown_s = (
            brain_cooldown_s() if cooldown_s is None else cooldown_s
        )
        self.sustain_cycles = (
            brain_sustain_cycles()
            if sustain_cycles is None
            else max(int(sustain_cycles), 1)
        )
        self.stall_share_threshold = stall_share_threshold
        self.linear_tolerance = linear_tolerance
        self.hysteresis_factor = hysteresis_factor
        #: per-node consecutive-cycle streaks per signal
        self._straggler_streak: Dict[int, int] = {}
        self._hang_streak: Dict[int, int] = {}
        #: job-level chronic-stall streak
        self._stall_streak = 0
        #: cycles observed at the current world size (grow evidence)
        self._world_cycles: List[int] = [0, 0]  # [world_size, cycles]
        #: median step time per observed world size (the scaling curve)
        self._step_time_by_world: Dict[int, float] = {}
        #: hysteresis/cooldown state — journaled
        self._last: Optional[BrainDecision] = None
        self._in_flight: Optional[BrainDecision] = None
        self._next_id = 1
        #: every other ControlPlaneJournal component locks its state
        #: (the snapshot thread and the status RPC read concurrently
        #: with the brain thread's mutations); reentrant because
        #: decide() composes the locked helpers
        self._lock = threading.RLock()

    # ------------------------------------------------------------ state
    @property
    def in_flight(self) -> Optional[BrainDecision]:
        with self._lock:
            return self._in_flight

    @property
    def last_decision(self) -> Optional[BrainDecision]:
        with self._lock:
            return self._last

    def complete(self, outcome: str, now: Optional[float] = None):
        """The executor finished (or abandoned) the in-flight action:
        it becomes the cooldown anchor."""
        del outcome
        with self._lock:
            if self._in_flight is None:
                return
            done = self._in_flight
            # the cooldown runs from COMPLETION, not decision time —
            # a slow execution must not eat its own quiet period
            done.made_at = now if now is not None else time.time()
            self._last = done
            self._in_flight = None

    def _cooled_down(self, action: str, now: float) -> bool:
        if self._last is None:
            return True
        quiet = now - self._last.made_at
        needed = self.cooldown_s
        if _DIRECTION.get(action) != self._last.direction:
            needed *= self.hysteresis_factor
        return quiet >= needed

    # ---------------------------------------------------------- streaks
    def _update_streaks(self, signals: ObservatorySignals):
        world = set(signals.world)
        fenced = set(signals.fenced)
        eligible = world - fenced

        flagged = {
            n: score
            for n, score in signals.stragglers
            if n in eligible
        }
        self._straggler_streak = {
            n: self._straggler_streak.get(n, 0) + 1 for n in flagged
        }
        hung = {
            n: silence
            for n, silence in signals.hangs
            if n in eligible
        }
        self._hang_streak = {
            n: self._hang_streak.get(n, 0) + 1 for n in hung
        }
        stalled = [
            n
            for n in eligible
            if max(
                (signals.stall_shares.get(n) or {}).values(),
                default=0.0,
            )
            >= self.stall_share_threshold
        ]
        # chronic = the job is input-bound, not one unlucky node: at
        # least half the eligible world is past the share threshold
        if eligible and len(stalled) * 2 >= len(eligible):
            self._stall_streak += 1
        else:
            self._stall_streak = 0
        return flagged, hung, stalled

    def _update_history(self, signals: ObservatorySignals):
        w = len(signals.world)
        if w <= 0:
            return
        if self._world_cycles[0] != w:
            self._world_cycles = [w, 1]
        else:
            self._world_cycles[1] += 1
        if signals.median_step_time_s > 0:
            prev = self._step_time_by_world.get(w, 0.0)
            if prev <= 0:
                self._step_time_by_world[w] = signals.median_step_time_s
            else:
                a = self.HISTORY_ALPHA
                self._step_time_by_world[w] = (
                    a * signals.median_step_time_s + (1 - a) * prev
                )

    # ----------------------------------------------------------- decide
    def decide(
        self, signals: ObservatorySignals
    ) -> Optional[BrainDecision]:
        now = signals.now or time.time()
        if not signals.world:
            return None  # no completed world yet: nothing to plan
        with self._lock:
            return self._decide_locked(signals, now)

    def _decide_locked(
        self, signals: ObservatorySignals, now: float
    ) -> Optional[BrainDecision]:
        self._update_history(signals)
        flagged, hung, stalled = self._update_streaks(signals)
        if self._in_flight is not None:
            return None  # one planned action at a time
        candidate = self._drain_candidate(signals, flagged, hung)
        if candidate is None:
            candidate = self._shrink_candidate(signals, stalled)
        if candidate is None:
            candidate = self._grow_candidate(signals)
        if candidate is None:
            return None
        if not self._cooled_down(candidate.action, now):
            return None
        candidate.decision_id = self._next_id
        self._next_id += 1
        candidate.made_at = now
        candidate.goodput = signals.goodput
        self._in_flight = candidate
        # acting on a verdict consumes its streak: if the condition
        # persists after the action lands, it must re-prove itself
        self._straggler_streak.pop(candidate.node, None)
        self._hang_streak.pop(candidate.node, None)
        if candidate.action == ACTION_SHRINK:
            self._stall_streak = 0
        return candidate

    def _drain_candidate(
        self, signals: ObservatorySignals, flagged: Dict[int, float],
        hung: Dict[int, float],
    ) -> Optional[BrainDecision]:
        world = len(signals.world)
        sustained = sorted(
            (
                (score, n)
                for n, score in flagged.items()
                if self._straggler_streak.get(n, 0)
                >= self.sustain_cycles
            ),
            reverse=True,
        )
        reason = None
        if sustained:
            score, node = sustained[0]
            reason = f"straggler:{score:.2f}x"
        else:
            hung_sustained = sorted(
                (
                    (silence, n)
                    for n, silence in hung.items()
                    if self._hang_streak.get(n, 0)
                    >= self.sustain_cycles
                ),
                reverse=True,
            )
            if hung_sustained:
                silence, node = hung_sustained[0]
                reason = f"hang:{silence:.0f}s"
        if reason is None:
            return None
        to_world = world if signals.can_launch else world - 1
        if to_world < max(signals.min_nodes, 1):
            logger.warning(
                "brain: %s on node %s suppressed (world %d at "
                "min_nodes %d, no launch capacity)",
                reason, node, world, signals.min_nodes,
            )
            return None
        return BrainDecision(
            action=ACTION_DRAIN_REPLACE,
            reason=reason,
            node=node,
            from_world=world,
            to_world=to_world,
        )

    def _shrink_candidate(
        self, signals: ObservatorySignals, stalled: List[int]
    ) -> Optional[BrainDecision]:
        if self._stall_streak < self.sustain_cycles or not stalled:
            return None
        world = len(signals.world)
        if world - 1 < max(signals.min_nodes, 1):
            return None
        # victim: the worst-stalled node (ties -> highest rank, the
        # scale-down convention)
        victim = max(
            stalled,
            key=lambda n: (
                max(
                    (signals.stall_shares.get(n) or {}).values(),
                    default=0.0,
                ),
                n,
            ),
        )
        share = max(
            (signals.stall_shares.get(victim) or {}).values(),
            default=0.0,
        )
        return BrainDecision(
            action=ACTION_SHRINK,
            reason=f"data_stall:{share:.2f}",
            node=victim,
            from_world=world,
            to_world=world - 1,
        )

    def _grow_candidate(
        self, signals: ObservatorySignals
    ) -> Optional[BrainDecision]:
        world = len(signals.world)
        if not signals.can_launch or world >= signals.max_nodes:
            return None
        # only a HEALTHY job grows: any live adverse signal means new
        # capacity would feed the problem, not the throughput
        if (
            self._straggler_streak
            or self._hang_streak
            or self._stall_streak > 0
        ):
            return None
        # evidence: enough settled cycles at this size (a world change
        # resets the counter in _update_history), and the step time
        # did not degrade past tolerance when the world last grew
        # (near-linear scaling — adding a node bought real throughput)
        if self._world_cycles[1] < self.sustain_cycles:
            return None
        here = self._step_time_by_world.get(world, 0.0)
        if here <= 0:
            return None  # insufficient samples at this size
        smaller = [
            w for w in self._step_time_by_world if w < world
        ]
        if smaller:
            ref = self._step_time_by_world[max(smaller)]
            if ref > 0 and here / ref > 1.0 + self.linear_tolerance:
                return None  # scaling already sub-linear: stop
        return BrainDecision(
            action=ACTION_GROW,
            reason=f"linear_scaling:{here:.3f}s",
            node=-1,
            from_world=world,
            to_world=min(world + 1, signals.max_nodes),
        )

    # -------------------------------------------------- journal contract
    def export_state(self) -> dict:
        with self._lock:
            return self._export_locked()

    def _export_locked(self) -> dict:
        return {
            "next_id": self._next_id,
            "last": self._last.to_dict() if self._last else None,
            "in_flight": (
                self._in_flight.to_dict() if self._in_flight else None
            ),
            "straggler_streak": {
                str(k): v for k, v in self._straggler_streak.items()
            },
            "hang_streak": {
                str(k): v for k, v in self._hang_streak.items()
            },
            "stall_streak": self._stall_streak,
            "world_cycles": list(self._world_cycles),
            "step_time_by_world": {
                str(k): v
                for k, v in self._step_time_by_world.items()
            },
        }

    def restore_state(self, state: dict):
        with self._lock:
            self._restore_locked(state)

    def _restore_locked(self, state: dict):
        self._next_id = int(state.get("next_id", 1))
        last = state.get("last")
        self._last = BrainDecision.from_dict(last) if last else None
        in_flight = state.get("in_flight")
        self._in_flight = (
            BrainDecision.from_dict(in_flight) if in_flight else None
        )
        self._straggler_streak = {
            int(k): int(v)
            for k, v in (state.get("straggler_streak") or {}).items()
        }
        self._hang_streak = {
            int(k): int(v)
            for k, v in (state.get("hang_streak") or {}).items()
        }
        self._stall_streak = int(state.get("stall_streak", 0))
        cycles = state.get("world_cycles") or [0, 0]
        self._world_cycles = [int(cycles[0]), int(cycles[1])]
        self._step_time_by_world = {
            int(k): float(v)
            for k, v in (
                state.get("step_time_by_world") or {}
            ).items()
        }
