"""Control-plane SELF-telemetry: the master watching itself.

Copy of ``dlrover_tpu/observability/self_telemetry.py``.

The observatory (``observability/health.py``) can name a slow rank, a
hung rank, and why its device is slow — but every one of those signals
flows through the master, and the master itself was unobserved:
nothing reported RPC latency, how many pool threads parked long-polls
were silently holding, how far the write-behind journal lagged the
mutations it claims durable, or how big a job's control-plane state
had grown.  A shared multi-job control plane without self-telemetry is
the next outage's root cause you can't see (ROADMAP item 2's 256-512
agent fan-in depends on exactly these numbers).

:class:`MasterSelfTelemetry` is the per-master collector the servicer
feeds inline (one histogram observe + a couple of counter bumps per
RPC — no locks beyond the registry's):

- **per-RPC-kind latency + size histograms**
  (``dlrover_tpu_master_rpc_latency_seconds{kind}`` /
  ``_request_bytes{kind}`` / ``_response_bytes{kind}``, log-bucketed,
  classic Prometheus text rendering) — ``kind`` is the request message
  class name, a closed vocabulary;
- **in-flight / parked / pool gauges**: every in-flight RPC holds one
  gRPC pool thread, and a PARKED long-poll holds one for its whole
  wait — ``dlrover_tpu_master_busy_workers`` over
  ``dlrover_tpu_master_worker_pool_size`` is the saturation signal,
  ``dlrover_tpu_master_parked_waits`` says how much of it is parked
  waiters, and ``dlrover_tpu_master_rejected_waits`` counts the
  long-polls degraded to immediate answers at the parked-wait cap;
- **per-job state growth**: row counts of the KV store, rendezvous
  waitlists/world, shard task queues and the in-memory timeline ring
  (``dlrover_tpu_master_state_rows{kind}``);
- **journal & datastore health** (pulled from the components on the
  throttled refresh): write-behind queue depth vs bound, journal lag
  (rows enqueued − rows flushed), last snapshot age and duration.

The derived verdict lives in ``observability/health.py``
:class:`~dlrover_tpu_torch.observability.health.MasterHealth` — sustained
p99 / queue-near-bound / journal-lag / pool-saturation streaks become
a ``master_overload`` diagnosis conclusion + instant.

Everything is behind ``DLROVER_TPU_SELF_OBS=0`` (the master simply
never constructs a collector; the flush-latency record function gates
itself), which reproduces the pre-self-obs metric surface exactly —
pinned by ``tests/test_self_obs.py``.
"""

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from dlrover_tpu_torch.common.env import env_float, master_workers
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.observability.metrics import (
    SIZE_BOUNDS,
    get_registry,
)

#: rolling window for the deriver's p99 (seconds of recent RPCs)
RPC_WINDOW_ENV = "DLROVER_TPU_MASTER_RPC_WINDOW_S"

#: request kinds that can PARK in a long-poll: their measured latency
#: is the wait window they asked for, by design.  They keep their
#: per-kind histograms, but they are EXCLUDED from the windowed-p99
#: ring the MasterHealth deriver reads — a healthy idle fleet spends
#: most of its RPCs parked for seconds, and folding those in would
#: trip a permanent spurious rpc_p99 overload (the fleet bench's
#: fast-kind knee applies the same exclusion).
WAIT_KINDS = frozenset(
    {
        "KVWaitRequest",
        "WaitingNodeNumRequest",
        "TaskRequest",
        "CommWorldRequest",
        "TrainingStatusRequest",
    }
)


class MasterSelfTelemetry:
    """Collector for one master process.  All observe paths are
    O(1); the component sweeps (row counts, datastore health) run on
    the throttled ``refresh_gauges`` and at scrape time, never on the
    RPC path."""

    #: gauge refresh throttle (the component sweep is O(components))
    GAUGE_REFRESH_S = 5.0
    #: recent-latency ring for the windowed p99 (the cumulative
    #: histograms cannot answer "p99 over the last minute")
    WINDOW_SAMPLES = 4096
    #: below this many fast-kind samples in the window the p99 reads
    #: 0.0: with ≤100 samples ``int(n * 0.99)`` is the MAXIMUM, and
    #: one isolated outlier (a big status serialization) on a
    #: near-idle master must not sustain a spurious rpc_p99 overload
    #: verdict — a p99 needs a distribution, not two points
    MIN_P99_SAMPLES = 20

    def __init__(
        self,
        registry=None,
        pool_size: Optional[int] = None,
        window_s: Optional[float] = None,
    ):
        self._registry = registry if registry is not None else (
            get_registry()
        )
        self.pool_size = (
            pool_size if pool_size is not None else master_workers()
        )
        self.window_s = (
            window_s
            if window_s is not None
            else env_float(RPC_WINDOW_ENV, 60.0)
        )
        self._lock = threading.Lock()
        self._inflight = 0
        self._parked = 0
        self.rejected_waits = 0
        #: kind -> lifetime RPC count (the snapshot's kind roster —
        #: histogram reads key off this, so a kind never observed
        #: costs nothing)
        self._kind_counts: Dict[str, int] = {}
        #: (mono, latency_s) ring for the windowed p99
        self._recent: Deque[Tuple[float, float]] = deque(
            maxlen=self.WINDOW_SAMPLES
        )
        self._last_gauge_refresh = 0.0
        # components wired via attach() after construction (the
        # journal only exists once failover setup ran)
        self._kv = None
        self._rdzv: Dict[str, object] = {}
        self._tasks = None
        self._timeline = None
        self._datastore = None
        self._journal = None

    # ------------------------------------------------------------ wiring
    def attach(
        self,
        kv_store=None,
        rdzv_managers=None,
        task_manager=None,
        timeline_aggregator=None,
        datastore=None,
        journal=None,
    ):
        """Late-bind the components whose state the refresh sweeps;
        every argument is optional and only overwrites when given."""
        if kv_store is not None:
            self._kv = kv_store
        if rdzv_managers is not None:
            self._rdzv = dict(rdzv_managers)
        if task_manager is not None:
            self._tasks = task_manager
        if timeline_aggregator is not None:
            self._timeline = timeline_aggregator
        if datastore is not None:
            self._datastore = datastore
        if journal is not None:
            self._journal = journal

    # ---------------------------------------------------------- RPC path
    def rpc_begin(self):
        with self._lock:
            self._inflight += 1

    def rpc_end(
        self,
        kind: str,
        seconds: float,
        req_bytes: int,
        resp_bytes: Optional[int],
    ):
        """One RPC finished (success or raise): histogram the latency
        and sizes, release the in-flight slot.  Never raises — the
        finally-block caller must not lose the real answer."""
        try:
            with self._lock:
                self._inflight -= 1
                self._kind_counts[kind] = (
                    self._kind_counts.get(kind, 0) + 1
                )
                if kind not in WAIT_KINDS:
                    self._recent.append(
                        (time.monotonic(), seconds)
                    )
            labels = {"kind": kind}
            reg = self._registry
            reg.observe_histogram(
                "dlrover_tpu_master_rpc_latency_seconds",
                seconds,
                labels=labels,
            )
            reg.observe_histogram(
                "dlrover_tpu_master_rpc_request_bytes",
                float(req_bytes),
                labels=labels,
                bounds=SIZE_BOUNDS,
            )
            if resp_bytes is not None:
                reg.observe_histogram(
                    "dlrover_tpu_master_rpc_response_bytes",
                    float(resp_bytes),
                    labels=labels,
                    bounds=SIZE_BOUNDS,
                )
            self._maybe_refresh()
        except Exception as e:  # noqa: BLE001 - telemetry must not break RPCs
            logger.warning("self-telemetry rpc record failed: %s", e)

    def wait_parked(self):
        with self._lock:
            self._parked += 1

    def wait_unparked(self):
        with self._lock:
            self._parked -= 1

    def wait_rejected(self):
        """A long-poll degraded to an immediate answer because every
        parked-wait slot was taken — the saturation precursor."""
        with self._lock:
            self.rejected_waits += 1
        try:
            self._registry.inc_counter(
                "dlrover_tpu_master_rejected_waits"
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("rejected-wait counter failed: %s", e)

    # -------------------------------------------------------- derivations
    def occupancy(self) -> float:
        """Busy pool fraction: in-flight RPCs (each holds one worker,
        parked long-polls included) over the pool size."""
        with self._lock:
            return min(self._inflight / max(self.pool_size, 1), 1.0)

    def window_p99(self) -> float:
        """p99 latency (seconds) of the FAST kinds (``WAIT_KINDS``
        excluded — a parked long-poll's latency is its wait window)
        over the rolling window — the deriver's drift signal; 0.0
        below ``MIN_P99_SAMPLES`` recent samples (too few points to
        call a tail)."""
        horizon = time.monotonic() - self.window_s
        with self._lock:
            lats = sorted(
                lat for t, lat in self._recent if t >= horizon
            )
        if len(lats) < self.MIN_P99_SAMPLES:
            return 0.0
        return lats[min(len(lats) - 1, int(len(lats) * 0.99))]

    def state_rows(self) -> Dict[str, int]:
        """Per-component control-plane row counts (growth watch)."""
        rows: Dict[str, int] = {}
        try:
            if self._kv is not None:
                rows["kv"] = len(
                    getattr(self._kv, "_store", {}) or {}
                )
            for name, manager in self._rdzv.items():
                # read-only accessors on purpose: get_comm_world /
                # num_nodes_waiting run lazy round-completion, and a
                # telemetry sweep must never mutate rendezvous state
                n = 0
                for accessor in ("current_world_ranks",
                                 "fenced_ranks"):
                    fn = getattr(manager, accessor, None)
                    if callable(fn):
                        n += len(fn() or [])
                rows[f"rdzv/{name}"] = n
            if self._tasks is not None:
                rows["tasks"] = self._tasks.row_counts()
            if self._timeline is not None:
                rows["timeline"] = self._timeline.size()
        except Exception as e:  # noqa: BLE001 - a sweep must not break scrape
            logger.warning("state-row sweep failed: %s", e)
        return rows

    def datastore_health(self) -> dict:
        """The write-behind queue's live health (empty dict when no
        datastore is wired)."""
        if self._datastore is None:
            return {}
        try:
            return self._datastore.health()
        except Exception as e:  # noqa: BLE001
            logger.warning("datastore health read failed: %s", e)
            return {}

    def journal_health(self) -> dict:
        """Snapshot age/duration from the control-plane journal
        (empty dict when failover is off / no journal)."""
        if self._journal is None:
            return {}
        try:
            return self._journal.health()
        except Exception as e:  # noqa: BLE001
            logger.warning("journal health read failed: %s", e)
            return {}

    # ------------------------------------------------------------- gauges
    def _maybe_refresh(self):
        now = time.monotonic()
        if now - self._last_gauge_refresh < self.GAUGE_REFRESH_S:
            return
        self._last_gauge_refresh = now
        self.refresh_gauges()

    def refresh_gauges(self):
        """Export the sweep-derived gauges (also called directly at
        scrape time by the status server, so ``/metrics`` never reads
        values staler than the snapshot it could have computed)."""
        try:
            reg = self._registry
            with self._lock:
                inflight, parked = self._inflight, self._parked
            reg.set_gauge(
                "dlrover_tpu_master_inflight_rpcs", float(inflight)
            )
            reg.set_gauge(
                "dlrover_tpu_master_parked_waits", float(parked)
            )
            reg.set_gauge(
                "dlrover_tpu_master_busy_workers", float(inflight)
            )
            reg.set_gauge(
                "dlrover_tpu_master_worker_pool_size",
                float(self.pool_size),
            )
            for kind, n in self.state_rows().items():
                reg.set_gauge(
                    "dlrover_tpu_master_state_rows",
                    float(n),
                    labels={"kind": kind},
                )
            ds = self.datastore_health()
            if ds:
                reg.set_gauge(
                    "dlrover_tpu_datastore_queue_depth",
                    float(ds.get("queue_depth", 0)),
                )
                reg.set_gauge(
                    "dlrover_tpu_journal_lag_rows",
                    float(ds.get("lag_rows", 0)),
                )
            jh = self.journal_health()
            if jh and jh.get("snapshot_age_s") is not None:
                reg.set_gauge(
                    "dlrover_tpu_snapshot_age_seconds",
                    float(jh["snapshot_age_s"]),
                )
                reg.set_gauge(
                    "dlrover_tpu_snapshot_duration_seconds",
                    float(jh.get("snapshot_duration_s", 0.0)),
                )
        except Exception as e:  # noqa: BLE001 - gauges must not break scrape
            logger.warning("self-telemetry gauge refresh failed: %s", e)

    # ----------------------------------------------------------- snapshot
    def rpc_stats(self) -> Dict[str, dict]:
        """Per-kind latency summary from the live histograms:
        ``{kind: {count, p50_ms, p99_ms, mean_ms}}`` — what the fleet
        bench reads per N and the ``master`` status section serves."""
        out: Dict[str, dict] = {}
        with self._lock:
            kinds = dict(self._kind_counts)
        for kind, count in sorted(kinds.items()):
            hist = self._registry.histogram(
                "dlrover_tpu_master_rpc_latency_seconds",
                labels={"kind": kind},
            )
            if hist is None or hist.count == 0:
                out[kind] = {"count": count}
                continue
            out[kind] = {
                "count": hist.count,
                "p50_ms": round(hist.quantile(0.5) * 1e3, 3),
                "p99_ms": round(hist.quantile(0.99) * 1e3, 3),
                "mean_ms": round(
                    hist.sum / hist.count * 1e3, 3
                ),
            }
        return out

    def snapshot(self) -> dict:
        """The ``master`` section of ``/status`` and the
        ``JobStatusResponse``: everything an operator needs to judge
        the control plane's own health at a glance."""
        with self._lock:
            inflight, parked = self._inflight, self._parked
            rejected = self.rejected_waits
        snap = {
            "pool": {
                "size": self.pool_size,
                "busy": inflight,
                "parked_waits": parked,
                "rejected_waits": rejected,
                "occupancy": round(
                    inflight / max(self.pool_size, 1), 4
                ),
            },
            "rpc": self.rpc_stats(),
            "rpc_p99_window_ms": round(self.window_p99() * 1e3, 3),
            "state_rows": self.state_rows(),
        }
        ds = self.datastore_health()
        if ds:
            snap["datastore"] = ds
        jh = self.journal_health()
        if jh:
            snap["journal"] = jh
        return snap
