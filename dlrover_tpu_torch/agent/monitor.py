"""Agent-side monitors: node resources, heartbeat, training progress,
and the timeline shipper.

Copy of ``dlrover_tpu/agent/monitor.py``.  Reference parity:
``dlrover/python/elastic_agent/monitor/resource.py:86``
(``ResourceMonitor``: psutil CPU/mem + per-accelerator stats reported to
the master) and ``monitor/training.py:77`` (``TorchTrainingMonitor``:
global step read from a file the training process writes).  The card's
stats come from the training process, which holds the card: its
``ElasticTrainer`` writes the memory in use (``torch.cuda``) to the file
``ResourceMonitor`` reads (``DLROVER_TPU_CHIP_STATS_FILE``; here also a
directory of them, one a worker), and the agent aggregates host-level
stats.  The agent runs all four (``agent/training.py``); the reference
defines the first three and starts none.  ``psutil`` stays optional.
"""

import glob
import json
import os
import threading
import time
from typing import List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient, ReportBuffer
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.log import default_logger as logger

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

CHIP_STATS_ENV = "DLROVER_TPU_CHIP_STATS_FILE"


def get_process_cpu_percent() -> float:
    if psutil is None:
        return 0.0
    return psutil.cpu_percent(interval=None)


def get_used_memory_mb() -> int:
    if psutil is None:
        return 0
    return int(psutil.virtual_memory().used / 1024 / 1024)


class PeriodicReporter:
    """Daemon-thread loop calling ``_tick`` every ``interval`` seconds;
    master connectivity errors are logged, never fatal.

    With a shared ``ReportBuffer`` the tick's message coalesces into
    the node's next ``BatchedReport`` envelope instead of paying its
    own RPC — heartbeats, resource stats, step samples, and timeline
    batches from one node ride together.
    """

    name = "periodic-reporter"

    def __init__(
        self,
        client: Optional[MasterClient] = None,
        interval: float = 15.0,
        buffer: Optional[ReportBuffer] = None,
    ):
        self._client = client or MasterClient.singleton_instance()
        self._interval = interval
        self._buffer = buffer
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    def _submit(self, message: msg.Message) -> bool:
        """One report message: buffered when a ReportBuffer is wired,
        a direct RPC otherwise."""
        if self._buffer is not None:
            return self._buffer.add(message)
        return self._client._channel.report(message)

    def _tick(self):
        raise NotImplementedError

    def _loop(self):
        while not self._stopped.wait(self._interval):
            try:
                self._tick()
            except ConnectionError as e:
                logger.warning("%s report failed: %s", self.name, e)

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()


class ResourceMonitor(PeriodicReporter):
    """Periodically reports host CPU/memory (+ the workers' card stats)
    to the master; feeds the autoscaler / resource optimizer."""

    name = "resource-monitor"

    def __init__(
        self,
        client: Optional[MasterClient] = None,
        interval: float = 15.0,
        chip_stats_file: str = "",
        buffer: Optional[ReportBuffer] = None,
    ):
        super().__init__(client, interval, buffer=buffer)
        self._chip_stats_file = chip_stats_file or os.getenv(
            CHIP_STATS_ENV, ""
        )

    def _read_chip_stats(self) -> List[dict]:
        """Card stats dropped by the training processes (device memory
        in use): one JSON file, or a directory of ``*.json`` files (one
        a worker), each a dict or a list of them."""
        path = self._chip_stats_file
        if not path or not os.path.exists(path):
            return []
        files = (sorted(glob.glob(os.path.join(path, "*.json")))
                 if os.path.isdir(path) else [path])
        out: List[dict] = []
        for name in files:
            try:
                with open(name) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            out.extend(data if isinstance(data, list) else [data])
        return out

    def _tick(self):
        self._submit(
            msg.ResourceStats(
                cpu_percent=get_process_cpu_percent(),
                memory_mb=get_used_memory_mb(),
                tpu_stats=self._read_chip_stats(),
            )
        )


class HeartbeatReporter(PeriodicReporter):
    """Agent heartbeat so the master can detect dead nodes
    (reference ``dist_job_manager.py:340`` heartbeat monitor)."""

    name = "heartbeat"

    def _tick(self):
        self._submit(msg.HeartBeat(timestamp=time.time()))


class TrainingMonitor(PeriodicReporter):
    """Reports the training global step to the master's SpeedMonitor by
    watching the step file the trainer writes (reference
    ``TorchTrainingMonitor`` ``monitor/training.py:77``)."""

    name = "training-monitor"

    def __init__(
        self,
        step_file: str,
        client: Optional[MasterClient] = None,
        interval: float = 15.0,
        buffer: Optional[ReportBuffer] = None,
    ):
        super().__init__(client, interval, buffer=buffer)
        self._step_file = step_file
        self._last_step = -1

    def _tick(self):
        if not os.path.exists(self._step_file):
            return
        try:
            with open(self._step_file) as f:
                data = json.load(f)
            step = int(data.get("step", -1))
            ts = float(data.get("timestamp", time.time()))
        except (OSError, ValueError):
            return
        if step > self._last_step:
            # report first: a ConnectionError must not advance
            # _last_step or the step would never be re-reported (the
            # buffered path re-queues undeliverable batches instead)
            self._submit(msg.GlobalStep(step=step, timestamp=ts))
            self._last_step = step


class TimelineReporter(PeriodicReporter):
    """Tails the node-local event timeline (the JSONL every process on
    this node appends to — see ``observability/events.py``) and ships
    the delta to the master's TimelineAggregator each tick.

    Only whole lines past the last shipped offset are consumed, so a
    write caught mid-line is picked up next tick; a truncated file
    (fresh run reusing the path) resets the offset.
    """

    name = "timeline-reporter"

    def __init__(
        self,
        events_file: str,
        client: Optional[MasterClient] = None,
        interval: float = 5.0,
        max_batch: int = 1000,
        buffer: Optional[ReportBuffer] = None,
    ):
        super().__init__(client, interval, buffer=buffer)
        self._events_file = events_file
        self._offset = 0
        #: inode of the file instance ``_offset`` was measured in —
        #: how a size-based rotation is told apart from ordinary
        #: growth (the recreated file can regrow PAST the old offset
        #: between ticks, so size alone cannot detect it)
        self._ino: Optional[int] = None
        self._max_batch = max_batch

    def _read_delta(self):
        """New complete JSONL records past the shipped offset, each
        paired with the file offset consuming it advances to."""
        try:
            st = os.stat(self._events_file)
        except OSError:
            return []
        size = st.st_size
        if self._ino is None:
            self._ino = st.st_ino
        elif st.st_ino != self._ino:
            # the path points at a NEW file: a size rotation
            # (EventLogger moved ours to `.1`) or a fresh run
            # recreating the path.  On rotation the unshipped tail
            # lives in the backup — drain it first or up to one
            # reporter interval of spans (including E records the
            # master's open-span bookkeeping needs) silently
            # vanishes from the ledger.
            tail = self._read_rotated_tail(expect_ino=self._ino)
            self._ino = st.st_ino
            self._offset = 0
            if tail:
                return tail
        elif size < self._offset:
            self._offset = 0  # truncated in place
        if size == self._offset:
            return []
        try:
            with open(self._events_file, "rb") as f:
                f.seek(self._offset)
                chunk = f.read(size - self._offset)
        except OSError:
            return []
        cut = chunk.rfind(b"\n")
        if cut < 0:
            return []  # only a partial line so far
        out = []  # (record, end_offset)
        pos = self._offset
        for line in chunk[: cut + 1].splitlines(keepends=True):
            pos += len(line)
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "name" in rec:
                out.append((rec, pos))
        # torn/blank trailing lines must still be consumed
        if out:
            out[-1] = (out[-1][0], self._offset + cut + 1)
        else:
            self._offset += cut + 1
        return out

    def _read_rotated_tail(self, expect_ino: int):
        """Whole-line records past the shipped offset in the rotated
        backup (``<events_file>.1``), with end offsets pinned to 0 so
        delivering them leaves the offset at the START of the new
        live file.  The backup must BE the file instance the offset
        was measured in (``expect_ino``) — a stale backup from an
        older run, or the middle file of a double rotation, would
        ship garbage from a misaligned offset.  Empty when absent,
        foreign, or fully shipped already."""
        backup = self._events_file + ".1"
        try:
            st = os.stat(backup)
            if st.st_ino != expect_ino or st.st_size <= self._offset:
                return []
            with open(backup, "rb") as f:
                f.seek(self._offset)
                chunk = f.read(st.st_size - self._offset)
        except OSError:
            return []
        out = []
        for line in chunk.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "name" in rec:
                out.append((rec, 0))
        return out

    def _tick(self):
        delta = self._read_delta()
        # the offset advances PER DELIVERED BATCH: a ConnectionError
        # mid-loop re-ships only the undelivered tail next tick (no
        # duplicates for batches the master already accepted, no loss
        # for the ones it didn't).  On the BUFFERED path "delivered"
        # means handed to the ReportBuffer, which owns delivery from
        # there (front re-queue on transport failure, drained on
        # close) — the timeline batch then coalesces with heartbeats
        # and metric samples into one envelope.
        for i in range(0, len(delta), self._max_batch):
            batch = delta[i:i + self._max_batch]
            events = [rec for rec, _ in batch]
            if self._buffer is not None:
                # add() is the direct-send ack under
                # DLROVER_TPU_CONTROL_BATCH=0 and True for a buffered
                # enqueue — either way it IS the delivery verdict
                ok = self._buffer.add(
                    msg.TimelineEventsReport(events=events)
                )
            else:
                ok = self._client.report_timeline_events(events)
            if not ok:
                # master refused (no aggregator / old master): drop
                # with a trace rather than re-shipping forever
                logger.warning(
                    "master rejected a timeline batch of %d events; "
                    "dropping it", len(batch),
                )
            self._offset = batch[-1][1]

    def flush(self):
        """One synchronous drain (agent shutdown / tests)."""
        try:
            self._tick()
            if self._buffer is not None:
                self._buffer.flush()
        except ConnectionError as e:
            logger.warning("timeline flush failed: %s", e)
