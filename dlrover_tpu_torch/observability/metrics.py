"""Process-local metrics registry.

The part of ``dlrover_tpu/observability/metrics.py`` that the port
calls: counters, gauges and log-bucketed histograms
(``MetricsRegistry`` :123, ``Histogram`` :42, ``LATENCY_BOUNDS`` and
``SIZE_BOUNDS`` :36-40, ``get_registry`` :330), the Prometheus text
rendering the master's ``/metrics`` serves (``render_text`` :282),
``record_ckpt_io`` (:347), ``record_offload_io`` (:514),
``record_reshard_io`` (:536),
``record_datastore_flush`` (:563), ``record_dropped_reports`` (:588)
and ``record_control_rpc`` (:613), under the reference's metric names.
Left out (ROADMAP A7): series retirement and the exporter file that the
native daemon serves (``native_build``): the registry keeps its values
in memory, read back with ``get``, ``histogram`` and ``render_text``.
"""

import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger


def log_bounds(base: float, growth: float, count: int) -> Tuple[float, ...]:
    """Geometric (log-spaced) histogram bucket upper bounds:
    ``base * growth**i`` for ``i in range(count)``.  Log buckets give
    constant RELATIVE resolution — the right shape for latencies and
    sizes, whose interesting range spans decades."""
    return tuple(base * growth ** i for i in range(count))


#: default latency buckets: 100 µs .. ~210 s, ×2 per bucket (22
#: buckets + the implicit +Inf)
LATENCY_BOUNDS = log_bounds(1e-4, 2.0, 22)
#: default size buckets: 64 B .. ~1 GB, ×4 per bucket (13 buckets +
#: +Inf) — request/response payloads and flush batches.
SIZE_BOUNDS = log_bounds(64.0, 4.0, 13)


class Histogram:
    """One log-bucketed histogram series: cumulative bucket counts +
    sum + count, rendered in the classic Prometheus text format
    (``<name>_bucket{le=...}`` / ``<name>_sum`` / ``<name>_count``).
    NOT thread-safe on its own — the owning registry's lock guards
    every observe/render."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...] = LATENCY_BOUNDS):
        self.bounds = tuple(sorted(bounds))
        # one count per finite bound + the +Inf overflow bucket;
        # non-cumulative internally, accumulated at render time
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        value = float(value)
        self.sum += value
        self.count += 1
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the ``q`` quantile (0..1) from the
        bucket counts: the smallest bucket bound whose cumulative
        count reaches ``q * count``.  Observations past the last
        finite bound report that bound."""
        if self.count <= 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, bound in enumerate(self.bounds):
            cum += self.counts[i]
            if cum >= target:
                return bound
        return self.bounds[-1] if self.bounds else 0.0

    @staticmethod
    def _fmt_le(bound: float) -> str:
        return f"{bound:.9g}"

    def render_lines(self, name: str, inner_labels: str) -> List[str]:
        """The exposition lines for this series.  ``inner_labels`` is
        the pre-rendered ``k="v"`` list (may be empty); ``le`` is
        appended last."""
        lines = []
        cum = 0
        for i, bound in enumerate(self.bounds):
            cum += self.counts[i]
            le = f'le="{self._fmt_le(bound)}"'
            inner = f"{inner_labels},{le}" if inner_labels else le
            lines.append(f"{name}_bucket{{{inner}}} {cum}")
        le = 'le="+Inf"'
        inner = f"{inner_labels},{le}" if inner_labels else le
        lines.append(f"{name}_bucket{{{inner}}} {self.count}")
        suffix = f"{{{inner_labels}}}" if inner_labels else ""
        lines.append(f"{name}_sum{suffix} {self.sum:.9g}")
        lines.append(f"{name}_count{suffix} {self.count}")
        return lines


class MetricsRegistry:
    """Counters, gauges and histograms keyed by name and labels."""

    _NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

    def __init__(self, rank: Optional[int] = None):
        self._metrics: Dict[str, float] = {}
        #: (name, rendered-inner-labels) -> Histogram
        self._histograms: Dict[Tuple[str, str], Histogram] = {}
        self._lock = threading.Lock()
        self._rank = rank

    @staticmethod
    def _escape_label(value) -> str:
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def _inner_labels(self, labels: Optional[Dict] = None) -> str:
        """The rendered ``k="v"`` label list (no braces; "" when no
        labels survive the merge)."""
        merged = dict(labels or {})
        if self._rank is not None:
            merged.setdefault("rank", self._rank)
        if not merged:
            return ""
        return ",".join(
            f'{self._NAME_RE.sub("_", str(k))}="{self._escape_label(v)}"'
            for k, v in sorted(merged.items()))

    def _key(self, name: str, labels: Optional[Dict] = None) -> str:
        name = self._NAME_RE.sub("_", name)
        inner = self._inner_labels(labels)
        return f"{name}{{{inner}}}" if inner else name

    def set_gauge(self, name: str, value: float, labels=None):
        with self._lock:
            self._metrics[self._key(name, labels)] = float(value)

    def inc_counter(self, name: str, value: float = 1.0, labels=None):
        key = self._key(name, labels)
        with self._lock:
            self._metrics[key] = self._metrics.get(key, 0.0) + value

    def observe_duration(self, name: str, seconds: float, labels=None):
        """Simple duration tracking: _sum/_count pair."""
        self.inc_counter(name + "_seconds_sum", seconds, labels)
        self.inc_counter(name + "_count", 1.0, labels)

    def get(self, name: str, labels=None, default: float = 0.0) -> float:
        with self._lock:
            return self._metrics.get(self._key(name, labels), default)

    def observe_histogram(self, name: str, value: float, labels=None,
                          bounds: Optional[Tuple[float, ...]] = None):
        """Record one observation into a log-bucketed histogram series
        (created on first observe; ``bounds`` only applies then — a
        series' bucket layout is immutable)."""
        name = self._NAME_RE.sub("_", name)
        with self._lock:
            key = (name, self._inner_labels(labels))
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = Histogram(
                    bounds if bounds is not None else LATENCY_BOUNDS)
            hist.observe(value)

    def histogram(self, name: str, labels=None) -> Optional[Histogram]:
        """The live ``Histogram`` for a series (None before its first
        observe).  The returned object is shared; treat it as
        read-only."""
        with self._lock:
            return self._histograms.get(
                (self._NAME_RE.sub("_", name), self._inner_labels(labels)))

    def render_text(self) -> str:
        """The current metrics as Prometheus exposition text (the
        master's plain-HTTP ``/metrics``), with no timestamps: served
        samples carry the scrape time."""
        with self._lock:
            lines = [f"{k} {v:.9g}"
                     for k, v in sorted(self._metrics.items())]
            for (name, inner) in sorted(self._histograms):
                lines.extend(
                    self._histograms[(name, inner)].render_lines(
                        name, inner))
        return "\n".join(lines) + "\n"


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


def record_input_io(stage: str, nbytes: int, seconds: float):
    """Export one input data-plane measurement as gauges
    (``dlrover_tpu_input_gbps{stage=...}`` / ``_bytes{stage=...}``).
    ``stage``: ``host_fetch`` (what the consumer waited on) |
    ``read_batch`` (the loader producer pool's raw fetch bandwidth) |
    ``h2d``.  Never raises — metrics must not break the input
    pipeline."""
    try:
        reg = get_registry()
        gbps = nbytes / 1e9 / max(seconds, 1e-9)
        reg.set_gauge(
            "dlrover_tpu_input_gbps", gbps, labels={"stage": stage}
        )
        reg.set_gauge(
            "dlrover_tpu_input_bytes",
            float(nbytes),
            labels={"stage": stage},
        )
    except Exception as e:  # noqa: BLE001
        logger.warning("input io metric export failed: %s", e)


def record_offload_io(nbytes: int, seconds: float, buffered: bool):
    """One host-offload chunk-stream measurement as gauges
    (``dlrover_tpu_offload_gbps{buffered=...}`` / ``_bytes``): the
    optimizer state's host<->device traffic of one streamed update.
    ``buffered`` tells the rolling window from the serial stream
    (``DLROVER_TPU_OFFLOAD_BUFFERED=0``), so a lost overlap shows as a
    ratio between the two series.  Never raises."""
    try:
        reg = get_registry()
        gbps = nbytes / 1e9 / max(seconds, 1e-9)
        labels = {"buffered": "1" if buffered else "0"}
        reg.set_gauge("dlrover_tpu_offload_gbps", gbps, labels=labels)
        reg.set_gauge("dlrover_tpu_offload_bytes", float(nbytes),
                      labels=labels)
    except Exception as e:  # noqa: BLE001
        logger.warning("offload io metric export failed: %s", e)


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


def record_datastore_flush(rows: int, seconds: float):
    """One write-behind flush batch landed: its commit latency feeds
    the ``dlrover_tpu_datastore_flush_seconds`` histogram and the
    batch size the ``dlrover_tpu_datastore_flush_rows`` histogram.
    Gated by ``DLROVER_TPU_SELF_OBS=0``.  Never raises — telemetry must
    not break a flush."""
    from dlrover_tpu_torch.common.env import self_obs_enabled

    try:
        if not self_obs_enabled():
            return
        reg = get_registry()
        reg.observe_histogram(
            "dlrover_tpu_datastore_flush_seconds", seconds)
        reg.observe_histogram(
            "dlrover_tpu_datastore_flush_rows", float(rows),
            bounds=SIZE_BOUNDS)
    except Exception as e:  # noqa: BLE001
        logger.warning("datastore flush metric export failed: %s", e)


def record_dropped_reports(n: int = 1):
    """Count fire-and-forget reports dropped by the client-side
    ``ReportBuffer`` overflow cap during a master outage
    (``dlrover_tpu_control_dropped_reports``).  A nonzero rate means
    the outage outlived the buffer — telemetry from that window is
    gone (training state is unaffected; reports are advisory).  Never
    raises."""
    try:
        get_registry().inc_counter(
            "dlrover_tpu_control_dropped_reports", float(n)
        )
    except Exception as e:  # noqa: BLE001
        logger.warning("dropped-report metric export failed: %s", e)


#: windowed meter behind ``dlrover_tpu_control_rps``: the master's
#: servicer calls ``record_control_rpc`` per RPC; the rate gauge is
#: recomputed at most once per window so the metric itself cannot
#: become control-plane load
_CONTROL_RPS_WINDOW_S = 5.0
_control_rpc_lock = threading.Lock()
_control_rpc_window_start = 0.0
_control_rpc_window_count = 0


def record_control_rpc(n: int = 1):
    """Count one (or ``n``) master control-plane RPCs; exports the
    windowed rate as ``dlrover_tpu_control_rps`` and the lifetime tally
    as ``dlrover_tpu_control_rpc_total``.  Never raises."""
    global _control_rpc_window_start, _control_rpc_window_count
    try:
        reg = get_registry()
        reg.inc_counter("dlrover_tpu_control_rpc_total", float(n))
        now = time.monotonic()
        with _control_rpc_lock:
            if not _control_rpc_window_start:
                _control_rpc_window_start = now
            _control_rpc_window_count += n
            elapsed = now - _control_rpc_window_start
            if elapsed < _CONTROL_RPS_WINDOW_S:
                return
            rps = _control_rpc_window_count / elapsed
            _control_rpc_window_start = now
            _control_rpc_window_count = 0
        reg.set_gauge("dlrover_tpu_control_rps", rps)
    except Exception as e:  # noqa: BLE001
        logger.warning("control rpc metric export failed: %s", e)
