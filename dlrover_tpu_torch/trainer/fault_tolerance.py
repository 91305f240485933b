"""In-trainer fault-tolerance utilities.

Port of ``dlrover_tpu/trainer/fault_tolerance.py``'s ``HangDetector``
(:26) and its default action.  A hung worker reports the hang to the
master and exits, and the agent restarts it (the JAX version reports
only).  The loss-spike capture, ``pytree_digest`` and the
``NumericChecker`` come with ``replay.py`` (ROADMAP A3c.7).

Reference parity: ``HangingDetector`` (``atorch/atorch/fault_tolerance/
hanging_detector.py:86``): a side thread watches step progress and
triggers a relaunch when stuck.
"""

import os
import threading
import time
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class HangDetector:
    """Watches a monotonically-increasing step counter from a side
    thread; fires ``on_hang`` when no progress within ``timeout``."""

    def __init__(
        self,
        timeout: float = 1800.0,
        check_interval: float = 30.0,
        on_hang: Optional[Callable[[], None]] = None,
    ):
        self._timeout = timeout
        self._interval = check_interval
        self._on_hang = on_hang
        self._last_step = -1
        self._last_progress = time.time()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hang_detected = False

    def report_step(self, step: int):
        if step > self._last_step:
            self._last_step = step
            self._last_progress = time.time()
            self.hang_detected = False

    def _loop(self):
        while not self._stopped.wait(self._interval):
            stalled = time.time() - self._last_progress
            if self._last_step >= 0 and stalled > self._timeout:
                self.hang_detected = True
                logger.error(
                    "hang: no step progress for %.0fs (step %d)",
                    stalled,
                    self._last_step,
                )
                if self._on_hang is not None:
                    self._on_hang()
                self._last_progress = time.time()  # don't refire hot

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="hang-detector", daemon=True
            )
            self._thread.start()

    def stop(self):
        self._stopped.set()


#: a worker that exits on a hang does so with this code
HANG_EXIT_CODE = 75


def default_hang_action():
    """Report a hang to the master (process restart verdict) — the
    reference's relaunch RPC — then exit, so that the agent sees the
    worker fail and restarts it."""
    from dlrover_tpu_torch.agent.master_client import MasterClient

    try:
        client = MasterClient.singleton_instance()
        client.report_failure(
            "training hang detected", level="process_error"
        )
    except Exception as e:  # noqa: BLE001
        logger.warning("hang report failed: %s", e)
    logger.error("exiting on a hang (code %d)", HANG_EXIT_CODE)
    os._exit(HANG_EXIT_CODE)
