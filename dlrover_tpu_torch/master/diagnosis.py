"""Failure diagnosis: data store + pluggable inference chain.

Copy of ``dlrover_tpu/master/diagnosis.py``, error patterns as they are
(the port's ``master/error_monitor.py`` keeps them too).  The GEMM
regression operator has no feed until a trace parser lands (ROADMAP
A7).

Reference parity: ``dlrover/python/master/diagnosis/`` —
``DiagnosisManager`` (``diagnosis.py:31``: collect ``DiagnosisData``,
periodic ``_diagnose_failures``), ``Diagnostician`` and the
``InferenceChain`` rule engine (``inferencechain/inference_chain.py:28``
with pluggable ``InferenceOperator``s).

TPU operators: step-stagnation (hang), OOM pattern in training logs,
chip unhealthy (libtpu error strings), preemption notice.
"""

import json
import os
import re
import threading
import time
from abc import ABCMeta, abstractmethod
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class DiagnosisDataType:
    TRAINING_LOG = "training_log"
    CHIP_METRICS = "chip_metrics"
    AGENT_REPORT = "agent_report"


@dataclass
class DiagnosisData:
    data_type: str
    content: str
    node_rank: int = -1
    timestamp: float = field(default_factory=time.time)


@dataclass
class Inference:
    """A (problem, cause, action) conclusion."""

    problem: str
    cause: str = ""
    action: str = ""  # restart_process | relaunch_node | abort | none
    node_rank: int = -1


class InferenceOperator(metaclass=ABCMeta):
    @abstractmethod
    def infer(self, store: "DiagnosisDataStore") -> List[Inference]:
        ...


class DiagnosisDataStore:
    """Windowed diagnosis evidence, bucketed by data type.

    Buckets are ``deque``s bounded BOTH ways: by age (``window_secs``,
    evicted on every add) and by length (``max_per_type`` via the
    deque's own ``maxlen``) — high-rate CHIP_METRICS used to pay an
    O(n) ``list.pop(0)`` per eviction AND could grow without bound
    inside the window."""

    def __init__(
        self, window_secs: float = 1800.0, max_per_type: int = 2048
    ):
        self._data: Dict[str, "deque[DiagnosisData]"] = {}
        self._window = window_secs
        self._max_per_type = max(int(max_per_type), 1)
        self._lock = threading.Lock()

    def add(self, data: DiagnosisData):
        with self._lock:
            bucket = self._data.get(data.data_type)
            if bucket is None:
                bucket = self._data[data.data_type] = deque(
                    maxlen=self._max_per_type
                )
            bucket.append(data)
            horizon = time.time() - self._window
            while bucket and bucket[0].timestamp < horizon:
                bucket.popleft()

    def get(self, data_type: str) -> List[DiagnosisData]:
        with self._lock:
            return list(self._data.get(data_type, ()))


class OomOperator(InferenceOperator):
    _PATTERN = re.compile(
        r"out of memory|oom-kill|RESOURCE_EXHAUSTED", re.IGNORECASE
    )

    def infer(self, store: DiagnosisDataStore) -> List[Inference]:
        results = []
        for d in store.get(DiagnosisDataType.TRAINING_LOG):
            if self._PATTERN.search(d.content):
                results.append(
                    Inference(
                        problem="oom",
                        cause="host or HBM memory exhausted",
                        action="relaunch_node",
                        node_rank=d.node_rank,
                    )
                )
        return results


class ChipErrorOperator(InferenceOperator):
    """libtpu / XLA hardware error signatures → node replacement."""

    _PATTERN = re.compile(
        r"(tpu.*(unhealthy|halted)|DEADLINE_EXCEEDED.*collective|"
        r"slice health|device or resource busy|uncorrectable)",
        re.IGNORECASE,
    )

    def infer(self, store: DiagnosisDataStore) -> List[Inference]:
        results = []
        for d in store.get(DiagnosisDataType.TRAINING_LOG):
            if self._PATTERN.search(d.content):
                results.append(
                    Inference(
                        problem="chip_error",
                        cause="TPU hardware/runtime fault",
                        action="relaunch_node",
                        node_rank=d.node_rank,
                    )
                )
        return results


class PreemptionOperator(InferenceOperator):
    _PATTERN = re.compile(
        r"(maintenance event|preempt|TERMINATING)", re.IGNORECASE
    )

    def infer(self, store: DiagnosisDataStore) -> List[Inference]:
        results = []
        for d in store.get(DiagnosisDataType.AGENT_REPORT):
            if self._PATTERN.search(d.content):
                results.append(
                    Inference(
                        problem="preemption",
                        cause="TPU-VM maintenance/spot reclaim",
                        action="relaunch_node",
                        node_rank=d.node_rank,
                    )
                )
        return results


class HangOperator(InferenceOperator):
    """Step stagnation from the SpeedMonitor."""

    def __init__(self, speed_monitor, hang_secs: Optional[float] = None):
        self._speed_monitor = speed_monitor
        self._hang_secs = hang_secs

    def infer(self, store: DiagnosisDataStore) -> List[Inference]:
        if self._speed_monitor and self._speed_monitor.step_is_stagnant(
            self._hang_secs
        ):
            return [
                Inference(
                    problem="hang",
                    cause="global step stagnant beyond threshold",
                    action="restart_process",
                )
            ]
        return []


class GemmRegressionOperator(InferenceOperator):
    """Op-time regression over the resident profiler's GEMM census.

    The reference's xpu_timer watches per-kernel time for the whole
    job and flags slow kernels (``atorch/dev/xpu_timer/common/
    manager.h:201``).  Here the Trainer's ``trace_interval`` captures
    drop per-GEMM-cluster step times as CHIP_METRICS JSON (content
    carries a ``gemm_clusters`` list); this operator compares each
    cluster's newest per-step time against the median of its history
    and concludes when one slowed past ``ratio`` — the signature of a
    thermally throttled / degraded chip, which per-STEP timing alone
    cannot localize to an op."""

    def __init__(self, ratio: float = 1.5, min_history: int = 3):
        self._ratio = ratio
        self._min_history = min_history

    @staticmethod
    def _reports(store: DiagnosisDataStore, rank: int):
        out = []
        for d in store.get(DiagnosisDataType.CHIP_METRICS):
            if d.node_rank != rank:
                continue
            try:
                content = json.loads(d.content)
            except (TypeError, ValueError):
                continue
            if isinstance(content, dict) and content.get(
                "gemm_clusters"
            ):
                out.append(content)
        return out

    def infer(self, store: DiagnosisDataStore) -> List[Inference]:
        ranks = {
            d.node_rank
            for d in store.get(DiagnosisDataType.CHIP_METRICS)
        }
        results: List[Inference] = []
        for rank in ranks:
            reports = self._reports(store, rank)
            if len(reports) < self._min_history:
                continue
            # per-cluster per-step time series, oldest -> newest
            series: Dict[str, List[float]] = {}
            for rep in reports:
                steps = max(float(rep.get("steps", 1) or 1), 1.0)
                for row in rep["gemm_clusters"]:
                    key = row.get("key")
                    t = row.get("time_us")
                    if key is None or not t:
                        continue
                    series.setdefault(key, []).append(
                        float(t) / steps
                    )
            for key, ts in series.items():
                if len(ts) < self._min_history:
                    continue
                history = sorted(ts[:-1])
                baseline = history[len(history) // 2]  # median
                if baseline > 0 and ts[-1] > self._ratio * baseline:
                    results.append(
                        Inference(
                            problem="op_time_regression",
                            cause=(
                                f"GEMM cluster {key} per-step time "
                                f"{ts[-1]:.0f}us vs baseline "
                                f"{baseline:.0f}us "
                                f"(x{ts[-1] / baseline:.2f})"
                            ),
                            action="none",
                            node_rank=rank,
                        )
                    )
        return results


def _attribution_hint(health_engine, node: int) -> str:
    """"; dominant device time: copy 40%" when the live attribution
    profiler has a step_profile-derived share for the node, "" when
    not (profiler off, old engine, or test facade without the
    accessor) — conclusions cite WHY, not just WHO."""
    accessor = getattr(health_engine, "attribution", None)
    if not callable(accessor):
        return ""
    try:
        dominant = accessor().get(node)
    except Exception:  # noqa: BLE001 - advisory context only
        return ""
    if not dominant:
        return ""
    category, share = dominant
    return f"; dominant device time: {category} {share:.0%}"


class StragglerOperator(InferenceOperator):
    """Relative straggler verdicts from the observatory's streaming
    step-time EWMAs (``observability/health.py``): a node whose EWMA
    exceeds the across-node median by the engine's ratio is concluded
    a straggler.  Replaces nothing — per-STEP timing at the master was
    simply never derived before; the network-check manager only sees
    the pre-flight rounds.  With the live attribution profiler on,
    the cause cites the node's dominant device-time category (a
    straggler at 40% copy share is an offload problem, not a bad
    host)."""

    def __init__(self, health_engine):
        self._health = health_engine

    def infer(self, store: "DiagnosisDataStore") -> List[Inference]:
        del store  # derived from the timeline, not the evidence store
        return [
            Inference(
                problem="straggler",
                cause=(
                    f"step time x{score:.2f} vs across-node median "
                    f"(ratio {self._health.straggler_ratio:.2f})"
                    + _attribution_hint(self._health, node)
                ),
                action="none",
                node_rank=node,
            )
            for node, score in self._health.stragglers()
        ]


class DataStallOperator(InferenceOperator):
    """Chronic input starvation from the goodput ledger's
    ``data_stall`` spans: when a node's windowed stall share (by
    stage) passes ``share_threshold``, conclude the stage that
    stalls.  The ledger already proved the share is pure loss —
    this operator just names the node and the stage."""

    def __init__(self, health_engine, share_threshold: float = 0.3):
        self._health = health_engine
        self._threshold = share_threshold

    def infer(self, store: "DiagnosisDataStore") -> List[Inference]:
        del store
        results = []
        for node, shares in self._health.stall_shares().items():
            stage, share = max(
                shares.items(), key=lambda kv: kv[1]
            )
            if share < self._threshold:
                continue
            results.append(
                Inference(
                    problem="data_stall",
                    cause=(
                        f"{stage} stall share {share:.0%} of the "
                        f"window (threshold "
                        f"{self._threshold:.0%})"
                        + _attribution_hint(self._health, node)
                    ),
                    action="none",
                    node_rank=node,
                )
            )
        return results


class HangWatchdogOperator(InferenceOperator):
    """Per-node hang via the observatory's span-heartbeat watchdog:
    a node whose agent still heartbeats but whose processes emitted
    no timeline event for the watchdog window is concluded hung.
    Unlike :class:`HangOperator` this needs no ``GlobalStep``
    reports, and it NAMES the wedged node — the global step keeps
    advancing while one rank hangs in a collective, which is exactly
    the case the SpeedMonitor cannot see."""

    def __init__(self, health_engine):
        self._health = health_engine

    def infer(self, store: "DiagnosisDataStore") -> List[Inference]:
        del store
        return [
            Inference(
                problem="hang",
                cause=(
                    f"no timeline event for {silence:.0f}s "
                    f"(watchdog {self._health.hang_watchdog_s:.0f}s)"
                    " while the node is otherwise alive"
                ),
                action="restart_process",
                node_rank=node,
            )
            for node, silence in self._health.hang_suspects()
        ]


class MasterOverloadOperator(InferenceOperator):
    """The control plane diagnosing ITSELF: each diagnose cycle is
    one derivation interval of the ``MasterHealth`` deriver
    (``observability/health.py``) — sustained p99 RPC latency,
    write-behind queue-near-bound, journal-lag and pool-saturation
    streaks become ``master_overload`` conclusions.  ``action`` is
    ``none`` on purpose: the remedy (raise
    ``DLROVER_TPU_MASTER_WORKERS``, shard the job off this master) is
    an operator decision, not a node relaunch — but the conclusion
    rides the same timeline/status/Brain surfaces as every fleet
    verdict, so the signal chain covers its own substrate."""

    def __init__(self, master_health):
        self._master_health = master_health

    def infer(self, store: "DiagnosisDataStore") -> List[Inference]:
        del store  # derived from self-telemetry, not the evidence
        # the reason rides the PROBLEM key ("master_overload:<reason>")
        # on purpose: the manager dedupes on (problem, node, action),
        # and a journal_lag breach must not be swallowed for 600 s
        # because a pool_saturated verdict fired first — MasterHealth
        # keeps reasons independent, the conclusion keys must too
        return [
            Inference(
                problem=f"master_overload:{v['reason']}",
                cause=(
                    f"{v['reason']} at {v['value']:g} vs threshold "
                    f"{v['threshold']:g} for {v['streak']} intervals"
                ),
                action="none",
                node_rank=-1,
            )
            for v in self._master_health.evaluate()
        ]


class InferenceChain:
    def __init__(self, operators: List[InferenceOperator]):
        self._operators = operators

    def infer(self, store: DiagnosisDataStore) -> List[Inference]:
        conclusions = []
        for op in self._operators:
            conclusions.extend(op.infer(store))
        return conclusions


#: cadence of the background diagnose loop (env-overridable so the
#: chaos scenario and tests can run many intervals in seconds)
DIAGNOSIS_INTERVAL_ENV = "DLROVER_TPU_DIAGNOSIS_INTERVAL_S"


class DiagnosisManager:
    #: conclusion problems that auto-trigger ONE throttled deep
    #: capture of the named rank (the CaptureCoordinator's per-node
    #: cooldown owns the throttle) — the xpu_timer reflex: a hang or
    #: sustained straggler verdict is exactly when you want stacks +
    #: an op trace of that rank
    CAPTURE_PROBLEMS = frozenset({"hang", "straggler"})

    def __init__(
        self,
        speed_monitor=None,
        operators: Optional[List[InferenceOperator]] = None,
        interval: Optional[float] = None,
        conclusion_cooldown: float = 600.0,
        health_engine=None,
        datastore=None,
        job: str = "",
        capture=None,
        master_health=None,
    ):
        """With a ``health_engine`` (the observatory is on) the chain
        sits ON TOP of the streaming derivations: straggler /
        data-stall / per-node hang operators join the log-pattern
        operators, and the SpeedMonitor hang rule is subsumed by the
        span-heartbeat watchdog.  Conclusions are then recorded as
        ``diagnosis`` instants on the timeline and persisted to the
        Brain ``node_events`` table (``datastore``) so they survive
        master failover.  Without an engine the manager is exactly
        the pre-observatory one."""
        self.store = DiagnosisDataStore()
        self._cooldown = conclusion_cooldown
        self._emitted: Dict = {}
        self._health = health_engine
        self._datastore = datastore
        #: CaptureCoordinator (master/capture.py) — None when the
        #: profiler is kill-switched; fresh hang/straggler
        #: conclusions then trigger nothing extra, exactly as today
        self._capture = capture
        self._job = job or os.getenv("DLROVER_TPU_JOB_NAME", "default")
        if operators is None:
            operators = [
                OomOperator(),
                ChipErrorOperator(),
                PreemptionOperator(),
                GemmRegressionOperator(),
            ]
            if health_engine is not None:
                operators.extend(
                    [
                        StragglerOperator(health_engine),
                        DataStallOperator(health_engine),
                        HangWatchdogOperator(health_engine),
                    ]
                )
            if master_health is not None:
                # the diagnose loop's cadence IS the MasterHealth
                # derivation interval — the master's own overload
                # verdicts join the chain like any fleet signal
                operators.append(
                    MasterOverloadOperator(master_health)
                )
            if speed_monitor is not None:
                # the whole-job stagnation rule stays EVEN WITH the
                # watchdog: the two see different failure shapes (the
                # watchdog names a silent node; this one catches a
                # job whose every node idles inside open spans), and
                # their conclusion keys differ so the cooldown dedupe
                # keeps them from stacking restarts
                operators.append(HangOperator(speed_monitor))
        self.chain = InferenceChain(operators)
        if interval is None:
            from dlrover_tpu_torch.common.env import env_float

            interval = env_float(DIAGNOSIS_INTERVAL_ENV, 60.0)
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conclusions: List[Inference] = []
        #: newest conclusions kept for the status snapshot (NOT
        #: consumed by take_conclusions, which feeds the node manager)
        self._recent: "deque[dict]" = deque(maxlen=64)
        self._lock = threading.Lock()

    def collect_data(self, data: DiagnosisData):
        self.store.add(data)

    def _record_conclusion(self, c: Inference, now: float):
        """One fresh conclusion onto the timeline (``diagnosis``
        instant) and into the Brain sqlite — the observatory's audit
        trail survives master failover.  Best-effort: recording must
        never block or break the diagnose loop."""
        if self._health is None:
            return  # observatory off: today's (unrecorded) behavior
        from dlrover_tpu_torch.observability.events import get_event_logger

        try:
            get_event_logger().instant(
                "diagnosis",
                problem=c.problem,
                action=c.action,
                node_rank=c.node_rank,
                cause=c.cause,
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("diagnosis instant emit failed: %s", e)
        if self._datastore is not None:
            try:
                self._datastore.record_node_event(
                    self._job,
                    str(c.node_rank),
                    "diagnosis",
                    json.dumps(
                        {**asdict(c), "t": now},
                        separators=(",", ":"),
                    ),
                )
            except Exception as e:  # noqa: BLE001
                logger.warning("diagnosis persist failed: %s", e)
        if (
            self._capture is not None
            and c.node_rank >= 0
            and c.problem in self.CAPTURE_PROBLEMS
        ):
            # deep-capture reflex: ask the named rank for stacks +
            # an N-step trace.  The coordinator's per-node cooldown
            # and in-flight dedupe make this at most ONE capture per
            # window no matter how many conclusions repeat.
            try:
                self._capture.request(c.node_rank, reason=c.problem)
            except Exception as e:  # noqa: BLE001
                logger.warning("capture trigger failed: %s", e)

    def diagnose(self) -> List[Inference]:
        """Run the chain, de-duplicating conclusions: the same
        (problem, node, action) fires at most once per cooldown — a
        single stored log line must not re-trigger restarts every
        cycle while it ages out of the data window."""
        conclusions = self.chain.infer(self.store)
        now = time.time()
        fresh = []
        with self._lock:
            for c in conclusions:
                key = (c.problem, c.node_rank, c.action)
                last = self._emitted.get(key, 0.0)
                if now - last < self._cooldown:
                    continue
                self._emitted[key] = now
                fresh.append(c)
                self._recent.append({**asdict(c), "t": now})
            self._conclusions.extend(fresh)
        for c in fresh:
            self._record_conclusion(c, now)
        return fresh

    def recent_conclusions(self, limit: int = 16) -> List[dict]:
        """Newest de-duplicated conclusions (not consumed — the
        status snapshot's view; ``take_conclusions`` still owns the
        apply-exactly-once contract)."""
        with self._lock:
            out = list(self._recent)
        return out[-limit:] if limit else out

    def take_conclusions(self) -> List[Inference]:
        """Consume pending conclusions (applied exactly once)."""
        with self._lock:
            out, self._conclusions = self._conclusions, []
            return out

    def start(self):
        if self._thread is not None:
            return

        def _loop():
            while not self._stopped.wait(self._interval):
                self.diagnose()

        self._thread = threading.Thread(
            target=_loop, name="diagnosis", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
