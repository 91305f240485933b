"""Job-event timeline: structured spans appended to a JSONL file.

The part of ``dlrover_tpu/observability/events.py`` (``anchored_now``
:54, ``EventLogger`` :425, ``get_event_logger`` :640) that the flash
checkpoint calls: one finished span per snapshot, persist and restore
(``complete``) and instant markers (``instant``, which the fault
injector writes).  The records are the reference's, on the same
``DLROVER_TPU_EVENTS_FILE``, so one timeline reader merges both
packages' spans.  Left out (ROADMAP A3b and A7): the phase registry
and its lint, the goodput ledger, the chrome-trace export, rotation
and the master-side aggregator.
"""

import json
import os
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.log import default_logger as logger

EVENTS_FILE_ENV = "DLROVER_TPU_EVENTS_FILE"

# One (wall, mono) anchor per process: every record's ``wall`` is
# derived from ``mono`` against this pair, so the two clocks carry a
# constant offset within a writer.
_WALL_EPOCH = time.time()
_MONO_EPOCH = time.monotonic()


def anchored_now(mono: Optional[float] = None) -> float:
    """Wall-clock "now" on the same ``(wall, mono)`` anchor the
    emitted records use; a span reported after the fact samples its
    start through this."""
    if mono is None:
        mono = time.monotonic()
    return _WALL_EPOCH + (mono - _MONO_EPOCH)


class EventLogger:
    """Append structured events to a JSONL timeline file.

    Disabled (every call a cheap no-op) when no path is configured.
    One ``os.write`` per line on an ``O_APPEND`` descriptor keeps
    concurrent writers from interleaving bytes.
    """

    def __init__(self, path: str = "", job: str = "",
                 node: Optional[int] = None, rank: Optional[int] = None,
                 incarnation: Optional[int] = None):
        self._path = path or os.getenv(EVENTS_FILE_ENV, "")
        self._job = job or os.getenv("DLROVER_TPU_JOB_NAME", "default")
        self._node = (
            node if node is not None
            else int(os.getenv("DLROVER_TPU_NODE_RANK", "0") or 0)
        )
        # -1 = not a training process
        self._rank = (
            rank if rank is not None
            else int(os.getenv("DLROVER_TPU_PROCESS_RANK", "-1") or -1)
        )
        self._inc = (
            incarnation if incarnation is not None
            else int(os.getenv("DLROVER_TPU_RESTART_COUNT", "0") or 0)
        )
        self._fd: Optional[int] = None
        self._lock = threading.Lock()

    def _record(self, name: str, ph: str, **labels) -> dict:
        mono = time.monotonic()
        rec = {
            "name": name,
            "ph": ph,
            "wall": _WALL_EPOCH + (mono - _MONO_EPOCH),
            "mono": mono,
            "job": self._job,
            "node": self._node,
            "rank": self._rank,
            "inc": labels.pop("inc", self._inc),
            "pid": os.getpid(),
        }
        if labels:
            rec["labels"] = dict(labels)
        return rec

    def emit(self, record: dict):
        """Write one record as one atomic appended JSONL line."""
        if not self._path:
            return
        try:
            line = json.dumps(record, separators=(",", ":"),
                              default=str) + "\n"
        except (TypeError, ValueError):
            return
        with self._lock:
            try:
                if self._fd is None:
                    parent = os.path.dirname(os.path.abspath(self._path))
                    os.makedirs(parent, exist_ok=True)
                    self._fd = os.open(
                        self._path,
                        os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
                os.write(self._fd, line.encode())
            except OSError as e:
                logger.warning("event emit failed: %s", e)

    def complete(self, phase: str, start_wall: float, duration_s: float,
                 **labels):
        """One finished span, emitted after the fact (``ph: "X"``)."""
        if not self._path:
            return
        rec = self._record(phase, "X", **labels)
        rec["wall"] = float(start_wall)
        rec["dur"] = max(float(duration_s), 0.0)
        self.emit(rec)

    def instant(self, name: str, **labels):
        if not self._path:
            return
        self.emit(self._record(name, "i", **labels))

    def close(self):
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


_default_logger: Optional[EventLogger] = None
_default_logger_lock = threading.Lock()


def get_event_logger() -> EventLogger:
    """Process-wide logger configured from the environment
    (``DLROVER_TPU_EVENTS_FILE`` etc.); a disabled no-op when unset."""
    global _default_logger
    with _default_logger_lock:
        if _default_logger is None:
            _default_logger = EventLogger()
        return _default_logger


def set_default_event_logger(event_logger: Optional[EventLogger]):
    """Install (or with ``None`` reset) the process default."""
    global _default_logger
    with _default_logger_lock:
        _default_logger = event_logger


def read_events(path: str):
    """Parse a JSONL timeline file, skipping torn lines."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "name" in rec:
                out.append(rec)
    return out
