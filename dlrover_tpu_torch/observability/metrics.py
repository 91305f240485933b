"""Process-local metrics registry.

The part of ``dlrover_tpu/observability/metrics.py`` that the flash
checkpoint calls: counters and gauges (``MetricsRegistry`` :123,
``get_registry`` :330), ``record_ckpt_io`` (:347) and
``record_reshard_io`` (:536), under the reference's metric names.
Left out (ROADMAP A7): histograms, series retirement, the Prometheus
text rendering and the exporter file it feeds (``native_build``): the
registry keeps its values in memory, read back with ``get``.
"""

import re
import threading
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class MetricsRegistry:
    """Counters and gauges keyed by name and labels."""

    _NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

    def __init__(self, rank: Optional[int] = None):
        self._metrics: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._rank = rank

    @staticmethod
    def _escape_label(value) -> str:
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def _key(self, name: str, labels: Optional[Dict] = None) -> str:
        name = self._NAME_RE.sub("_", name)
        merged = dict(labels or {})
        if self._rank is not None:
            merged.setdefault("rank", self._rank)
        if not merged:
            return name
        inner = ",".join(
            f'{self._NAME_RE.sub("_", str(k))}="{self._escape_label(v)}"'
            for k, v in sorted(merged.items()))
        return f"{name}{{{inner}}}"

    def set_gauge(self, name: str, value: float, labels=None):
        with self._lock:
            self._metrics[self._key(name, labels)] = float(value)

    def inc_counter(self, name: str, value: float = 1.0, labels=None):
        key = self._key(name, labels)
        with self._lock:
            self._metrics[key] = self._metrics.get(key, 0.0) + value

    def get(self, name: str, labels=None, default: float = 0.0) -> float:
        with self._lock:
            return self._metrics.get(self._key(name, labels), default)

_default_registry: Optional[MetricsRegistry] = None
_default_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """Process-wide default registry."""
    global _default_registry
    with _default_registry_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


def record_ckpt_io(kind: str, nbytes: int, seconds: float):
    """One checkpoint data-plane measurement as gauges
    (``dlrover_tpu_ckpt_io_gbps{kind=...}`` / ``_bytes{kind=...}``).
    ``kind``: drain | restore | persist | prealloc.  Never raises."""
    try:
        reg = get_registry()
        reg.set_gauge("dlrover_tpu_ckpt_io_gbps",
                      nbytes / 1e9 / max(seconds, 1e-9),
                      labels={"kind": kind})
        reg.set_gauge("dlrover_tpu_ckpt_io_bytes", float(nbytes),
                      labels={"kind": kind})
    except Exception as e:  # noqa: BLE001
        logger.warning("ckpt io metric export failed: %s", e)


def record_reshard_io(from_world: int, to_world: int, nbytes: int,
                      seconds: float):
    """One resharded restore as gauges labeled with the world
    transition, plus the ``dlrover_tpu_reshard_total`` counter.  Never
    raises."""
    try:
        reg = get_registry()
        labels = {"from_world": str(int(from_world)),
                  "to_world": str(int(to_world))}
        reg.set_gauge("dlrover_tpu_reshard_gbps",
                      nbytes / 1e9 / max(seconds, 1e-9), labels=labels)
        reg.set_gauge("dlrover_tpu_reshard_bytes", float(nbytes),
                      labels=labels)
        reg.inc_counter("dlrover_tpu_reshard_total")
    except Exception as e:  # noqa: BLE001
        logger.warning("reshard metric export failed: %s", e)
