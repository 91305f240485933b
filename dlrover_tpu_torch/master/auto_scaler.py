"""Auto-scalers: the periodic decide-and-act loops.

Copy of ``dlrover_tpu/master/auto_scaler.py`` (imports rewritten).
``DistributedJobMaster`` (``master/master.py``) wires them as the
reference does: ``set_scaler`` hands the Brain its scaler, and with the
Brain off it runs ``AllreduceAutoScaler``.  The local master builds only
the Brain, which without a scaler drains and shrinks and never grows.

Two generations live here:

- :class:`AllreduceAutoScaler` — the seed loop (reference parity:
  ``dlrover/python/master/node/job_auto_scaler.py`` —
  ``AllreduceTrainingAutoScaler:271``): poll the ``SpeedMonitor``,
  ask the :class:`LocalAllreduceOptimizer` for a plan, execute it
  through ``Scaler.scale``.  This is what ``DLROVER_TPU_BRAIN=0``
  pins, byte-for-byte in decision behavior.
- :class:`BrainAutoScaler` — the observatory-fed autonomy loop
  (ROADMAP item 1; PAPER.md §1's Brain/ResourceOptimizer claim): each
  cycle assembles :class:`ObservatorySignals` from the
  ``HealthEngine`` + the goodput ledger + the live rendezvous world,
  asks :class:`ObservatoryBrainOptimizer` for at most one
  :class:`BrainDecision`, and executes it as ONE planned action
  through :class:`~dlrover_tpu_torch.master.brain.BrainExecutor`.  Every
  decision and execution outcome is journaled (the
  ``ControlPlaneJournal`` ``brain`` component) and emitted on the
  timeline (``scale_decision`` / ``scale_execute`` instants,
  ``dlrover_tpu_autoscale_*`` metrics), so a master failover
  mid-action resumes or safely abandons it instead of flip-flopping.
"""

import threading
import time
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.resource_optimizer import (
    BrainDecision,
    JobStage,
    LocalAllreduceOptimizer,
    ObservatoryBrainOptimizer,
    ObservatorySignals,
    OUTCOME_DONE,
)
from dlrover_tpu_torch.master.scaler import Scaler


def _registry():
    from dlrover_tpu_torch.observability.metrics import get_registry

    return get_registry()



class _DecisionLoop:
    """Shared thread/lifecycle/error machinery for both scaler
    generations: a daemon loop ticking every ``interval``, failure
    accounting into ``dlrover_tpu_autoscale_errors`` with a throttled
    traceback, and a stop() that JOINS so master shutdown can't leak
    a mid-decision cycle.  Subclasses implement ``_cycle()``."""

    #: a failing cycle's traceback is logged at most once per this
    #: window (the counter still ticks every failure) — a wedged
    #: dependency must not write an identical stack trace every
    #: interval forever
    ERROR_LOG_COOLDOWN_S = 300.0
    _THREAD_NAME = "auto-scaler"
    _LOG_PREFIX = "auto-scale cycle"

    def __init__(self, interval: float):
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.cycle_errors = 0
        self._last_error_log = 0.0

    def _cycle(self):
        raise NotImplementedError

    def start(self):
        # is_alive guard: a stop() whose join timed out on a wedged
        # cycle keeps _thread set; once that thread finally exits a
        # later start() must still work, not no-op forever
        if self._thread is not None and self._thread.is_alive():
            return
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name=self._THREAD_NAME, daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0):
        """Signal the loop and JOIN it — master shutdown must not
        leak a mid-decision cycle into the dying process."""
        self._stopped.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=timeout)
            if thread.is_alive():
                logger.warning(
                    "%s thread did not stop within %.1fs",
                    self._THREAD_NAME, timeout,
                )
            else:
                self._thread = None

    def _loop(self):
        while not self._stopped.wait(self._interval):
            try:
                self._cycle()
            except Exception as e:  # noqa: BLE001
                self._on_cycle_error(e)

    def _on_cycle_error(self, e: BaseException):
        """Count every failure in the metric, but write the full
        traceback at most once per cooldown — repeated identical
        warnings forever were worse than silence."""
        self.cycle_errors += 1
        try:
            _registry().inc_counter("dlrover_tpu_autoscale_errors")
        except Exception:  # noqa: BLE001 - accounting must not throw
            pass
        now = time.monotonic()
        if now - self._last_error_log >= self.ERROR_LOG_COOLDOWN_S:
            self._last_error_log = now
            logger.warning(
                "%s failed (%d so far): %s",
                self._LOG_PREFIX, self.cycle_errors, e, exc_info=True,
            )
        else:
            logger.warning("%s failed: %s", self._LOG_PREFIX, e)


class AllreduceAutoScaler(_DecisionLoop):
    def __init__(
        self,
        optimizer: LocalAllreduceOptimizer,
        scaler: Scaler,
        speed_monitor=None,
        job_manager=None,
        rendezvous_manager=None,
        interval: float = 60.0,
    ):
        self._optimizer = optimizer
        self._scaler = scaler
        self._speed_monitor = speed_monitor
        self._job_manager = job_manager
        self._rdzv_manager = rendezvous_manager
        super().__init__(interval)
        self._started_job = False

    def execute_initial_plan(self):
        plan = self._optimizer.generate_plan(JobStage.CREATE)
        if plan and not plan.is_empty():
            self._scaler.scale(plan)
            self._started_job = True

    def _collect_speed(self):
        if self._speed_monitor is None:
            return
        # running_speed is a METHOD — the bare attribute compared >0
        # raised TypeError every cycle, silently eaten by the loop's
        # catch-all (caught by the autoscale e2e test)
        speed = self._speed_monitor.running_speed()
        worker_num = 0
        if self._job_manager is not None:
            worker_num = len(self._job_manager.get_running_nodes())
        if worker_num > 0:
            # the optimizer's settle decision needs the ACTUAL world
            # size even when no fresh speed sample exists this cycle
            self._optimizer.set_current_workers(worker_num)
        if speed > 0 and worker_num > 0:
            self._optimizer.record_speed(worker_num, speed)

    def _collect_stragglers(self):
        """Feed the health-check rounds' straggler verdict to the
        straggler-migrate algorithm.  Ranks are mapped to node NAMES
        (the scaler removes pods by name; an unmapped rank is skipped
        rather than producing an un-executable plan)."""
        if self._rdzv_manager is None:
            return
        try:
            stragglers, _ = self._rdzv_manager.check_straggler()
        except Exception:  # noqa: BLE001
            return
        if not stragglers:
            return
        names = []
        rank_to_name = {}
        if self._job_manager is not None:
            for node in self._job_manager.get_running_nodes():
                key = (
                    node.rank_index
                    if node.rank_index is not None
                    else node.id
                )
                if node.name:
                    rank_to_name[key] = node.name
        for rank in stragglers:
            name = rank_to_name.get(rank)
            if name:
                names.append(name)
            else:
                logger.warning(
                    "straggler rank %s has no known node name; "
                    "skipping migration", rank,
                )
        if names:
            self._optimizer.report_stragglers(names)

    def _cycle(self):
        self._collect_speed()
        self._collect_stragglers()
        plan = self._optimizer.generate_plan(JobStage.RUNNING)
        if plan and not plan.is_empty():
            logger.info("auto-scaler executing plan: %s", plan)
            self._scaler.scale(plan)


class BrainAutoScaler(_DecisionLoop):
    """The closed autonomy loop: observe (health engine + ledger) →
    decide (:class:`ObservatoryBrainOptimizer`) → act
    (:class:`BrainExecutor`) → verify, with everything journaled.

    Implements the journal-component contract
    (``set_journal`` / ``export_state`` / ``restore_state``) so the
    optimizer's hysteresis/cooldown state and any in-flight action
    survive a master failover under the ``ControlPlaneJournal``.
    """

    _THREAD_NAME = "brain-auto-scaler"
    _LOG_PREFIX = "brain cycle"

    def __init__(
        self,
        optimizer: ObservatoryBrainOptimizer,
        executor,
        health_engine=None,
        timeline_aggregator=None,
        interval: Optional[float] = None,
        job: str = "default",
    ):
        from dlrover_tpu_torch.common.env import brain_interval_s
        from dlrover_tpu_torch.master.brain import execution_deadline_s

        self._optimizer = optimizer
        self._executor = executor
        self._health = health_engine
        self._aggregator = timeline_aggregator
        super().__init__(
            brain_interval_s() if interval is None else interval
        )
        self._deadline_s = execution_deadline_s(self._interval)
        self._job = job
        self._journal_cb: Optional[Callable[[str, dict], None]] = None
        #: an in-flight decision inherited from a dead incarnation
        #: must be re-armed (its directive died with the old master)
        self._resume_pending = False
        executor.on_follow_up = self._journal

    @property
    def directives(self):
        return self._executor.directives

    @property
    def optimizer(self) -> ObservatoryBrainOptimizer:
        return self._optimizer

    @property
    def executor(self):
        return self._executor

    def set_scaler(self, scaler):
        self._executor.set_scaler(scaler)

    # ------------------------------------------------------------ loop
    def _cycle(self):
        self.run_cycle()

    # ----------------------------------------------------------- signals
    def gather_signals(self, now: Optional[float] = None) -> ObservatorySignals:
        world = self._executor.current_world()
        min_nodes, max_nodes = self._executor.world_bounds()
        signals = ObservatorySignals(
            world=world,
            min_nodes=min_nodes,
            max_nodes=max_nodes,
            fenced=self._executor.fenced(),
            can_launch=self._executor.can_launch,
            now=now or time.time(),
        )
        if self._health is not None:
            signals.stragglers = self._health.stragglers()
            signals.hangs = self._health.hang_suspects()
            signals.stall_shares = self._health.stall_shares()
            signals.median_step_time_s = (
                self._health.median_step_time()
            )
        if self._aggregator is not None:
            try:
                signals.goodput = float(
                    self._aggregator.ledger().get("goodput", 0.0)
                )
            except Exception as e:  # noqa: BLE001 - advisory context
                logger.warning("brain ledger read failed: %s", e)
        return signals

    # ------------------------------------------------------------ cycle
    def run_cycle(self, now: Optional[float] = None):
        """One decide/verify beat (public so tests and harnesses can
        drive the loop synchronously)."""
        now = now or time.time()
        in_flight = self._optimizer.in_flight
        if in_flight is not None:
            self._advance_in_flight(in_flight, now)
            return
        signals = self.gather_signals(now)
        decision = self._optimizer.decide(signals)
        self._export_world_gauge(signals)
        if decision is None:
            return
        logger.info(
            "brain decision %d: %s node=%s (%s) world %d -> %d",
            decision.decision_id, decision.action, decision.node,
            decision.reason, decision.from_world, decision.to_world,
        )
        self._journal()
        self._emit_decision(decision)
        self._executor.begin(decision)

    def _advance_in_flight(self, decision: BrainDecision, now: float):
        if self._resume_pending:
            # inherited from a dead incarnation: its directive died
            # with the old master's memory — re-arm (or observe that
            # the world already reflects it)
            self._resume_pending = False
            if not self._executor.resume(decision):
                self._finish(decision, OUTCOME_DONE, now)
                return
            logger.info(
                "brain: resumed in-flight decision %d (%s node=%s) "
                "after failover",
                decision.decision_id, decision.action, decision.node,
            )
        outcome = self._executor.check(decision)
        if outcome is None and now - decision.made_at >= self._deadline_s:
            outcome = self._executor.force(decision)
        if outcome is not None:
            self._finish(decision, outcome, now)

    def _finish(self, decision: BrainDecision, outcome: str, now: float):
        logger.info(
            "brain decision %d executed: %s (%s)",
            decision.decision_id, outcome, decision.action,
        )
        self._optimizer.complete(outcome, now=now)
        self._journal()
        self._emit_execute(decision, outcome)

    # --------------------------------------------------------- telemetry
    def _emit_decision(self, decision: BrainDecision):
        from dlrover_tpu_torch.observability.events import get_event_logger

        get_event_logger().instant(
            "scale_decision",
            action=decision.action,
            reason=decision.reason,
            from_world=decision.from_world,
            to_world=decision.to_world,
            plane="train",
            target_node=decision.node,
            decision_id=decision.decision_id,
        )
        try:
            _registry().inc_counter(
                "dlrover_tpu_autoscale_decisions",
                labels={"action": decision.action},
            )
        except Exception:  # noqa: BLE001
            pass

    def _emit_execute(self, decision: BrainDecision, outcome: str):
        from dlrover_tpu_torch.observability.events import get_event_logger

        get_event_logger().instant(
            "scale_execute",
            action=decision.action,
            reason=decision.reason,
            from_world=decision.from_world,
            to_world=decision.to_world,
            plane="train",
            target_node=decision.node,
            decision_id=decision.decision_id,
            outcome=outcome,
        )
        try:
            _registry().inc_counter(
                "dlrover_tpu_autoscale_executions",
                labels={"action": decision.action,
                        "outcome": outcome},
            )
        except Exception:  # noqa: BLE001
            pass

    def _export_world_gauge(self, signals: ObservatorySignals):
        try:
            _registry().set_gauge(
                "dlrover_tpu_autoscale_world", len(signals.world)
            )
        except Exception:  # noqa: BLE001
            pass

    # -------------------------------------------------- journal contract
    def set_journal(self, cb: Optional[Callable[[str, dict], None]]):
        self._journal_cb = cb

    def _journal(self):
        if self._journal_cb is None:
            return
        try:
            self._journal_cb("state", self.export_state())
        except Exception as e:  # noqa: BLE001
            logger.warning("brain journal failed: %s", e)

    def export_state(self) -> dict:
        # the port's: which decisions' pod-side legs already ran
        return dict(self._optimizer.export_state(),
                    followed_up=self._executor.followed_up())

    def restore_state(self, state: dict):
        """Journal replay: reinstall the optimizer's hysteresis /
        cooldown / in-flight state.  A restored in-flight action is
        resumed (directive re-armed) or observed-as-done on the first
        cycle; its original decision deadline still bounds it, so a
        long outage abandons instead of acting on stale evidence."""
        self._optimizer.restore_state(state)
        self._executor.restore_followed_up(state.get("followed_up") or [])
        self._resume_pending = self._optimizer.in_flight is not None

    def status(self) -> dict:
        """The Brain's corner of the JobStatus snapshot."""
        last = self._optimizer.last_decision
        in_flight = self._optimizer.in_flight
        return {
            "interval_s": self._interval,
            "cycle_errors": self.cycle_errors,
            "last_decision": last.to_dict() if last else None,
            "in_flight": in_flight.to_dict() if in_flight else None,
            "pending_directives": (
                self._executor.directives.pending_nodes()
            ),
        }
