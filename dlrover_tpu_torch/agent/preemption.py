"""Preemption / maintenance-event watcher.

Copy of ``dlrover_tpu/agent/preemption.py``.  Reference parity: on GPU
clusters the primary failure signal is the k8s pod kill (SIGTERM →
``ckpt_saver`` flush, ``training.py`` restart); on a cloud VM the
metadata server's maintenance event fires ~60 s before the host is
migrated or the spot VM is terminated, long before any SIGTERM arrives,
so the agent subscribes to both.

``PreemptionWatcher`` plain-polls the instance metadata endpoint
every ``poll_interval`` seconds (well inside the ~60s preemption
lead; the metadata ``wait_for_change`` long-poll would shave the
interval but complicates the injectable-fetcher seam) and invokes
the registered callbacks once per event:
the agent wires these to (1) flush the latest shm checkpoint slot to
storage and (2) report the imminent failure to the master so the
rendezvous can fence the node before the hardware goes away.

The metadata fetcher is injectable (tests never touch the network).
One change against the reference: the default fetcher sends a request
only where there is a metadata server to ask, a GCE VM (its DMI product
name says so) or an endpoint named in ``DLROVER_TPU_METADATA_BASE``;
elsewhere it answers "unreachable" at once, without resolving a name,
and the watcher idles as the reference's does after a failed request.
Its requests bypass any proxy the environment names.
"""

import os
import threading
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

_METADATA_BASE = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
)


METADATA_BASE_ENV = "DLROVER_TPU_METADATA_BASE"
#: the DMI product name of a GCE VM starts with "Google"
_DMI_PRODUCT = "/sys/class/dmi/id/product_name"


def _metadata_base() -> str:
    """Metadata server base URL; overridable so fault-injection
    harnesses can stand in a fake endpoint and drive the REAL
    watcher->flush->restart path."""
    return os.getenv(METADATA_BASE_ENV, _METADATA_BASE)


def _metadata_server_expected() -> bool:
    """A metadata server to ask: an endpoint named in the environment,
    or a GCE VM (read from DMI, no request)."""
    if os.getenv(METADATA_BASE_ENV):
        return True
    try:
        with open(_DMI_PRODUCT) as f:
            return f.read().strip().startswith("Google")
    except OSError:
        return False
# Hosted-VM migration/termination and spot/preemptible termination
# are surfaced on DIFFERENT endpoints (maintenance-event says
# NONE/MIGRATE.../TERMINATE...; preempted says TRUE/FALSE) — a
# spot preemption never appears on maintenance-event, so both must
# be polled.
_METADATA_PATHS = ("maintenance-event", "preempted")
_NONE_EVENT = "NONE"


def _fetch_metadata(path: str, timeout: float) -> Optional[str]:
    import urllib.request

    req = urllib.request.Request(
        _metadata_base() + path,
        headers={"Metadata-Flavor": "Google"},
    )
    # never through a proxy from the environment: the metadata server
    # answers on the VM's own link
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout) as resp:
            return resp.read().decode().strip()
    except OSError:
        return None


def _default_fetcher(timeout: float = 5.0) -> Optional[str]:
    """Poll maintenance-event then preempted; return the first
    non-idle value, an idle value when both endpoints answered idle,
    or None when the metadata server is unreachable (not on GCE, or no
    metadata server expected: then nothing is sent)."""
    if not _metadata_server_expected():
        return None
    idle_seen: Optional[str] = None
    for path in _METADATA_PATHS:
        value = _fetch_metadata(path, timeout)
        if value is None:
            continue
        if value.upper() in (_NONE_EVENT, "FALSE", ""):
            idle_seen = value
            continue
        return "PREEMPTED" if path == "preempted" else value
    return idle_seen


class PreemptionWatcher:
    """Fire callbacks exactly once per maintenance event.

    Events (GCE contract): ``NONE`` (idle), ``MIGRATE_ON_HOST_MAINTENANCE``,
    ``TERMINATE_ON_HOST_MAINTENANCE``; preemptible VMs surface
    ``TRUE``/``FALSE`` on the preempted endpoint — any non-idle value
    is treated as "hardware goes away soon"."""

    def __init__(
        self,
        fetcher: Optional[Callable[[], Optional[str]]] = None,
        poll_interval: Optional[float] = None,
    ):
        self._fetch = fetcher or _default_fetcher
        if poll_interval is None:
            # well inside the ~60s preemption lead; harnesses shrink
            # it so graceful-path recovery is measurable at CI scale
            raw = os.getenv("DLROVER_TPU_PREEMPTION_POLL", "5.0")
            try:
                poll_interval = float(raw)
            except ValueError:
                logger.warning(
                    "ignoring malformed DLROVER_TPU_PREEMPTION_POLL"
                    "=%r", raw,
                )
                poll_interval = 5.0
        self._interval = poll_interval
        self._callbacks: List[Callable[[str], None]] = []
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_event = _NONE_EVENT
        self.unavailable = False  # metadata server unreachable

    def on_preemption(self, callback: Callable[[str], None]):
        """Register ``callback(event_str)``; called from the watcher
        thread once per distinct non-idle event."""
        self._callbacks.append(callback)

    def _is_idle(self, value: Optional[str]) -> bool:
        return value is None or value.upper() in (_NONE_EVENT, "FALSE", "")

    def check_once(self) -> Optional[str]:
        """One poll; fires callbacks on a NEW non-idle event and
        returns it (None otherwise)."""
        value = self._fetch()
        if value is None:
            if not self.unavailable:
                self.unavailable = True
                logger.info(
                    "metadata server unreachable; preemption watcher "
                    "idle (not on GCE)"
                )
            return None
        self.unavailable = False
        if self._is_idle(value):
            self._last_event = _NONE_EVENT
            return None
        if value == self._last_event:
            return None  # already reported this event
        self._last_event = value
        logger.warning("maintenance event: %s — flushing state", value)
        from dlrover_tpu_torch.observability.events import get_event_logger

        get_event_logger().instant("preemption_signal", event=value)
        for cb in self._callbacks:
            try:
                cb(value)
            except Exception as e:  # noqa: BLE001
                logger.error("preemption callback failed: %s", e)
        return value

    def _loop(self):
        backoff = self._interval
        while not self._stopped.wait(backoff):
            self.check_once()
            # when not on GCE, poll rarely — the endpoint won't appear
            backoff = 300.0 if self.unavailable else self._interval

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="preemption-watcher", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
