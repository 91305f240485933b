"""Job metrics collection and reporting.

Copy of ``dlrover_tpu/master/stats.py``.

Reference parity: ``dlrover/python/master/stats/`` —
``JobMetricCollector`` (``job_collector.py:185``), ``StatsReporter``
(``reporter.py``: LOCAL vs BRAIN ``ReporterType``) and
``training_metrics.py``.  The local reporter stores in-process (the
brain-backed reporter plugs in through the same interface).
"""

import json
import threading
import time
from abc import ABCMeta, abstractmethod
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class ReporterType:
    LOCAL = "local"
    BRAIN = "brain"


@dataclass
class JobMeta:
    job_name: str = ""
    namespace: str = ""
    uuid: str = ""


@dataclass
class RuntimeMetric:
    timestamp: float
    global_step: int
    speed: float
    running_nodes: int
    node_resources: Dict = field(default_factory=dict)


@dataclass
class ModelMetric:
    num_params: int = 0
    flops_per_step: float = 0.0
    hidden_size: int = 0
    num_layers: int = 0
    seq_len: int = 0


class StatsReporter(metaclass=ABCMeta):
    @abstractmethod
    def report_runtime(self, metric: RuntimeMetric):
        ...

    @abstractmethod
    def report_model(self, metric: ModelMetric):
        ...

    @abstractmethod
    def report_job_exit(self, success: bool, reason: str):
        ...


class LocalStatsReporter(StatsReporter):
    """In-memory store, optionally mirrored to a JSONL file for
    offline analysis (the reference's MySQL-less mode)."""

    def __init__(self, job_meta: Optional[JobMeta] = None,
                 dump_path: str = ""):
        self.job_meta = job_meta or JobMeta()
        self.runtime: List[RuntimeMetric] = []
        self.model: Optional[ModelMetric] = None
        self.exit_info: Optional[Dict] = None
        self._dump_path = dump_path
        self._lock = threading.Lock()

    def _dump(self, kind: str, payload: Dict):
        if not self._dump_path:
            return
        try:
            with open(self._dump_path, "a") as f:
                f.write(json.dumps({"kind": kind, **payload}) + "\n")
        except OSError as e:
            logger.warning("stats dump failed: %s", e)

    def report_runtime(self, metric: RuntimeMetric):
        with self._lock:
            self.runtime.append(metric)
            if len(self.runtime) > 4096:
                self.runtime.pop(0)
        self._dump("runtime", asdict(metric))

    def report_model(self, metric: ModelMetric):
        with self._lock:
            self.model = metric
        self._dump("model", asdict(metric))

    def report_job_exit(self, success: bool, reason: str):
        with self._lock:
            self.exit_info = {
                "success": success,
                "reason": reason,
                "timestamp": time.time(),
            }
        self._dump("exit", self.exit_info)


class JobMetricCollector:
    """Aggregates from SpeedMonitor + JobManager into the reporter
    (reference ``job_collector.py``)."""

    def __init__(
        self,
        reporter: StatsReporter,
        speed_monitor=None,
        job_manager=None,
        interval: float = 30.0,
    ):
        self._reporter = reporter
        self._speed_monitor = speed_monitor
        self._job_manager = job_manager
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def collect_model_info(self, num_params: int,
                           flops_per_step: float = 0.0, **kwargs):
        self._reporter.report_model(
            ModelMetric(
                num_params=num_params,
                flops_per_step=flops_per_step,
                **{
                    k: v
                    for k, v in kwargs.items()
                    if k in ("hidden_size", "num_layers", "seq_len")
                },
            )
        )

    def _tick(self):
        step = 0
        speed = 0.0
        if self._speed_monitor is not None:
            step = self._speed_monitor.completed_global_step
            # running_speed is a METHOD (same defect auto_scaler had:
            # the bare attribute serialized a bound method as "speed")
            speed = self._speed_monitor.running_speed()
        running = 0
        resources: Dict = {}
        if self._job_manager is not None:
            nodes = self._job_manager.get_running_nodes()
            running = len(nodes)
            for n in nodes:
                resources[n.name] = {
                    "cpu": n.used_resource.cpu,
                    "memory": n.used_resource.memory,
                }
        self._reporter.report_runtime(
            RuntimeMetric(
                timestamp=time.time(),
                global_step=step,
                speed=speed,
                running_nodes=running,
                node_resources=resources,
            )
        )

    def start(self):
        if self._thread is not None:
            return

        def _loop():
            while not self._stopped.wait(self._interval):
                try:
                    self._tick()
                except Exception as e:  # noqa: BLE001
                    logger.warning("metric collection failed: %s", e)

        self._thread = threading.Thread(
            target=_loop, name="metric-collector", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
