"""Agent-side diagnosis data collectors.

Copy of ``dlrover_tpu/agent/diagnosis_collector.py``.

Reference parity: ``dlrover/python/elastic_agent/datacollector/*``
(cuda-log / log / metrics collectors, ~130 LoC skeletons feeding the
master's DiagnosisManager) and the diagnosis agent of
``elastic_agent/monitor/diagnosis.py:112``.  The TPU forms:

* :class:`TrainingLogCollector` — incrementally tails the training
  process's log file and ships only NEW error-class lines (XLA/HBM
  OOM, RESOURCE_EXHAUSTED, tracebacks, NaN reports) to the master,
  where the inference chain (``master/diagnosis.py``) pattern-matches
  them into recovery verdicts.  There is no CUDA-log analog on TPU —
  the XLA error text IS the chip-side log.
* :class:`ChipMetricsCollector` — forwards the chip-stats JSON the
  training process drops (device HBM in use, duty cycle; the agent
  cannot open the TPU runtime itself) as CHIP_METRICS diagnosis data.

Both run on the agent's :class:`PeriodicReporter` daemon-thread loop
and survive master connectivity blips.
"""

import json
import os
import re
from typing import List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import PeriodicReporter
from dlrover_tpu_torch.common.log import default_logger as logger

# lines worth shipping to the master's inference chain; everything
# else stays on the node (the reference ships whole logs to Brain —
# on TPU slices that volume would ride DCN for no diagnostic value)
_ERROR_PATTERN = re.compile(
    r"(RESOURCE_EXHAUSTED|OOM|out of memory|Traceback|"
    r"FAILED_PRECONDITION|DEADLINE_EXCEEDED|UNAVAILABLE|"
    r"NaN|non-finite|loss spike|halted|XlaRuntimeError)",
    re.IGNORECASE,
)
_MAX_LINES_PER_TICK = 50
_MAX_LINE_CHARS = 500


class TrainingLogCollector(PeriodicReporter):
    """Tail ``log_file`` from the last read offset; report error-class
    lines as TRAINING_LOG diagnosis data."""

    name = "training-log-collector"

    def __init__(
        self,
        log_file: str,
        client: Optional[MasterClient] = None,
        interval: float = 30.0,
        node_rank: int = -1,
    ):
        super().__init__(client, interval)
        self._log_file = log_file
        self._offset = 0
        self._node_rank = node_rank

    def _read_new_lines(self) -> List[str]:
        if not self._log_file or not os.path.exists(self._log_file):
            return []
        try:
            size = os.path.getsize(self._log_file)
            if size < self._offset:  # rotated/truncated: restart
                self._offset = 0
            with open(
                self._log_file, "r", errors="replace"
            ) as f:
                f.seek(self._offset)
                chunk = f.read()
                self._offset = f.tell()
        except OSError:
            return []
        return chunk.splitlines()

    def _tick(self):
        hits = [
            line[:_MAX_LINE_CHARS]
            for line in self._read_new_lines()
            if _ERROR_PATTERN.search(line)
        ][:_MAX_LINES_PER_TICK]
        if not hits:
            return
        from dlrover_tpu_torch.master.diagnosis import DiagnosisDataType

        self._client.report_diagnosis_data(
            DiagnosisDataType.TRAINING_LOG,
            "\n".join(hits),
            node_rank=self._node_rank,
        )
        logger.info(
            "shipped %d error log lines for diagnosis", len(hits)
        )


class ChipMetricsCollector(PeriodicReporter):
    """Forward the training process's chip-stats drop file as
    CHIP_METRICS diagnosis data (device HBM bytes in use, duty cycle —
    the inference chain's straggler/OOM evidence)."""

    name = "chip-metrics-collector"

    def __init__(
        self,
        chip_stats_file: str = "",
        client: Optional[MasterClient] = None,
        interval: float = 60.0,
        node_rank: int = -1,
    ):
        super().__init__(client, interval)
        self._chip_stats_file = chip_stats_file or os.getenv(
            "DLROVER_TPU_CHIP_STATS_FILE", ""
        )
        self._node_rank = node_rank
        self._last_mtime = 0.0

    def _tick(self):
        f = self._chip_stats_file
        if not f or not os.path.exists(f):
            return
        try:
            mtime = os.path.getmtime(f)
            if mtime <= self._last_mtime:  # nothing new
                return
            with open(f) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return
        self._last_mtime = mtime
        from dlrover_tpu_torch.master.diagnosis import DiagnosisDataType

        self._client.report_diagnosis_data(
            DiagnosisDataType.CHIP_METRICS,
            json.dumps(data),
            node_rank=self._node_rank,
        )
