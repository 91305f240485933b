"""Worker-side graceful-drain protocol (SIGUSR1).

Copy of ``dlrover_tpu/trainer/drain.py``.

When the agent learns the node is about to die — a GCE maintenance
notice, a pod SIGTERM, or a membership change it is about to restart
for — it sends every training process ``SIGUSR1``.  The worker's
response is NOT to stop: it flips into **drain mode** and snapshots
the train state into shm at EVERY following step boundary (blocking
save).  Why every step rather than once: the job's ranks are coupled
by the per-step collective, so by the time the agent flushes shm to
storage, every rank's newest complete snapshot is the same step — the
last step the whole world completed together.  That is the property
the multi-rank checkpoint commit needs (one stage dir per step, done
files from every node), and it means survivors reshard from a step
within ~1 of the preemption instead of the last periodic snapshot.

The flag is a process-wide event, not a callback: signal handlers
must not run checkpoint code (the main thread may be inside a
collective); the training loop polls :func:`drain_requested` at the
step boundary, where the state is consistent by construction.
"""

import signal
import threading

from dlrover_tpu_torch.common.log import default_logger as logger

#: the drain request signal the agent sends
DRAIN_SIGNAL = signal.SIGUSR1

_drain = threading.Event()


def _on_drain(signum, frame):  # pragma: no cover - signal path
    if not _drain.is_set():
        logger.warning(
            "drain requested (signal %s): snapshotting every step "
            "until teardown", signum,
        )
    _drain.set()


def install_drain_handler() -> threading.Event:
    """Install the SIGUSR1 drain handler (main thread only — off the
    main thread the handler cannot be installed and the returned
    event simply never fires from a signal; callers may still set it
    programmatically).  Returns the process-wide drain event."""
    try:
        signal.signal(DRAIN_SIGNAL, _on_drain)
    except ValueError:
        logger.warning(
            "not on main thread: drain signal handler not installed"
        )
    return _drain


def drain_requested() -> bool:
    """Whether the agent asked this process to drain (snapshot every
    step boundary until the process is torn down)."""
    return _drain.is_set()


def reset_drain():
    """Test hook: clear the drain flag."""
    _drain.clear()
