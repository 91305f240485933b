"""Error monitor: classify node/process failures and recommend the
recovery rung.

Copy of ``dlrover_tpu/master/error_monitor.py``.

Reference parity: ``dlrover/python/master/monitor/error_monitor.py``
(process/node error-log handling) + the relaunch-decision inputs of
``_should_relaunch`` (``dist_job_manager.py:546``).  The reference's
production finding (``docs/blogs/flash_checkpoint.md:88``): ~75% of
faults are recoverable by a process restart — so classification is
what keeps the recovery ladder cheap: restart the process for software
faults, replace the pod for hardware faults, grow memory for OOM, stop
the job for deterministic user-code errors.
"""

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger


class ErrorKind:
    OOM = "oom"
    HARDWARE = "hardware"
    NETWORK = "network"
    USER_CODE = "user_code"
    PREEMPTION = "preemption"
    UNKNOWN = "unknown"


class RecoveryAction:
    RESTART_PROCESS = "restart_process"
    RELAUNCH_NODE = "relaunch_node"
    GROW_MEMORY = "grow_memory"
    STOP_JOB = "stop_job"


# first match wins; patterns over stderr/log excerpts and exit reasons
_CLASSIFIERS: List[Tuple[str, str]] = [
    (r"RESOURCE_EXHAUSTED|out of memory|OOM|Killed.*memory", ErrorKind.OOM),
    (
        r"preempt|maintenance event|TERMINATED_BY_SYSTEM|spot.*reclaim",
        ErrorKind.PREEMPTION,
    ),
    (
        r"hbm.*(error|fail)|uncorrectable|device.*(lost|unhealthy)|"
        r"libtpu.*abort|chip.*fail|ICI.*(down|error)",
        ErrorKind.HARDWARE,
    ),
    (
        r"connection (refused|reset)|deadline exceeded|unavailable|"
        r"socket.*(closed|timeout)|coordinator.*unreachable",
        ErrorKind.NETWORK,
    ),
    (
        r"Traceback \(most recent call last\)|AssertionError|KeyError|"
        r"ValueError|TypeError|ModuleNotFoundError",
        ErrorKind.USER_CODE,
    ),
]

_ACTION_FOR: Dict[str, str] = {
    ErrorKind.OOM: RecoveryAction.GROW_MEMORY,
    ErrorKind.PREEMPTION: RecoveryAction.RELAUNCH_NODE,
    ErrorKind.HARDWARE: RecoveryAction.RELAUNCH_NODE,
    ErrorKind.NETWORK: RecoveryAction.RESTART_PROCESS,
    ErrorKind.USER_CODE: RecoveryAction.STOP_JOB,
    ErrorKind.UNKNOWN: RecoveryAction.RESTART_PROCESS,
}


def classify_error(error_data: str) -> str:
    for pattern, kind in _CLASSIFIERS:
        if re.search(pattern, error_data, re.IGNORECASE):
            return kind
    return ErrorKind.UNKNOWN


@dataclass
class ErrorRecord:
    node_id: int
    node_type: str
    kind: str
    excerpt: str
    timestamp: float = field(default_factory=time.time)


class ErrorMonitor:
    """Collects error reports, classifies them, and answers the job
    manager's "how should this failure be recovered?" question."""

    MAX_RECORDS = 1000  # bounded history: a flapping link must not
    # grow master memory for weeks

    def __init__(self, user_code_threshold: int = 3,
                 window_secs: float = 1800.0):
        import collections

        self._lock = threading.Lock()
        self._records: "collections.deque[ErrorRecord]" = (
            collections.deque(maxlen=self.MAX_RECORDS)
        )
        # repeated deterministic user-code failures stop the job
        self._user_code_threshold = user_code_threshold
        self._window = window_secs

    def report(self, node_id: int, node_type: str,
               error_data: str) -> str:
        """Record and classify one failure; returns the recommended
        RecoveryAction."""
        kind = classify_error(error_data or "")
        with self._lock:
            self._records.append(
                ErrorRecord(
                    node_id=node_id,
                    node_type=node_type,
                    kind=kind,
                    excerpt=(error_data or "")[:500],
                )
            )
        action = _ACTION_FOR[kind]
        if kind == ErrorKind.USER_CODE:
            # one traceback can still be environmental; repeated
            # same-class failures of the SAME node across restarts are
            # deterministic -> stop the job instead of burning
            # restarts.  (Counting across nodes would let three
            # unrelated transient tracebacks on a 100-worker job kill
            # everything.)
            if self._recent_count(
                ErrorKind.USER_CODE, node_id=node_id
            ) < self._user_code_threshold:
                action = RecoveryAction.RESTART_PROCESS
        logger.info(
            "node %s failure classified %s -> %s", node_id, kind, action
        )
        return action

    def _recent_count(self, kind: str,
                      node_id: Optional[int] = None) -> int:
        cutoff = time.time() - self._window
        with self._lock:
            return sum(
                1
                for r in self._records
                if r.kind == kind
                and r.timestamp >= cutoff
                and (node_id is None or r.node_id == node_id)
            )

    def history(self, node_id: Optional[int] = None) -> List[ErrorRecord]:
        with self._lock:
            return [
                r
                for r in self._records
                if node_id is None or r.node_id == node_id
            ]

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for r in self._records:
                out[r.kind] = out.get(r.kind, 0) + 1
            return out
