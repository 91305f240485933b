"""The job observatory: streaming health derivation from the timeline.

Copy of ``dlrover_tpu/observability/health.py`` (``dominant_category``
comes from the port's ``observability/attribution.py``), with one
change: of two nodes, the straggler score's across-node median is the
faster node's EWMA (the reference's upper middle is the slow node's
own, so no verdict could brand it); at any other count it is the
reference's.

PR-1 gave every process a structured event timeline and PR-5 batched
the agent->master reporting path — but nothing consumed them *live*:
the only way to see a running job was to export a Perfetto trace after
the fact, and ``master/diagnosis.py`` ran on its own isolated
``DiagnosisDataStore`` that almost nobody fed.  This module is the
missing consumer (the role the reference splits between
``DiagnosisManager``/``InferenceChain`` and xpu_timer's live kernel
watch): the master streams incoming timeline batches and agent
reports through a :class:`HealthEngine` that maintains rolling
per-node derivations —

- **step-rate and step-time EWMAs** from ``step`` spans (per node, on
  the span's own ``dur``, so a slow rank is visible even while the
  *global* step — the max over ranks the SpeedMonitor sees — still
  advances);
- **data-stall share by stage** (``host_fetch`` / ``h2d``) over a
  rolling window, from the same ``data_stall`` spans the goodput
  ledger charges;
- **restart / fault counts** from ``restart`` spans and
  ``fault_injected`` instants plus the servicer's ``NodeFailure``
  reports;
- a **relative straggler score**: each node's step-time EWMA over the
  across-node median, flagged past ``DLROVER_TPU_STRAGGLER_RATIO``
  (the xpu_timer "one chip is slow" signal, derived from spans
  instead of kernel interposition);
- a **span-heartbeat hang watchdog**: a node whose agent still
  heartbeats but whose processes have emitted *no timeline event* for
  ``DLROVER_TPU_HANG_WATCHDOG_S`` is flagged hung.  This works when
  the SpeedMonitor sees no steps at all (it needs ``GlobalStep``
  reports, and the global step keeps moving while one rank wedges in
  a collective); a node attributably busy inside an *open* non-step
  span (a long compile or restore emitted its ``B`` record) is NOT
  flagged — the ledger already charges that time.

``DiagnosisManager`` sits on top of these derivations through the
``StragglerOperator`` / ``DataStallOperator`` / ``HangWatchdogOperator``
in ``master/diagnosis.py``; the full derived snapshot is served by the
``JobStatusRequest`` RPC, the ``--status_port`` HTTP endpoints
(``observability/status_server.py``) and ``scripts/top.py``.  Gauges
``dlrover_tpu_node_health{node}`` / ``dlrover_tpu_straggler_score{node}``
mirror the snapshot for Prometheus.  Everything here is behind the
``DLROVER_TPU_OBSERVATORY=0`` kill-switch (the master simply never
constructs an engine).
"""

import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.env import env_float
from dlrover_tpu_torch.common.log import default_logger as logger

#: a node whose step-time EWMA exceeds the across-node median by this
#: ratio is a straggler (reference: the network-check manager's 2x
#: round-time rule; xpu_timer flags slow kernels the same way)
STRAGGLER_RATIO_ENV = "DLROVER_TPU_STRAGGLER_RATIO"
#: span-heartbeat watchdog: seconds of total timeline silence from a
#: still-heartbeating node before it is flagged hung
HANG_WATCHDOG_ENV = "DLROVER_TPU_HANG_WATCHDOG_S"
#: rolling derivation window (stall shares, step rates)
HEALTH_WINDOW_ENV = "DLROVER_TPU_HEALTH_WINDOW_S"

#: health gauge encoding (dlrover_tpu_node_health{node=...})
HEALTH_OK = 1.0
HEALTH_STRAGGLER = 0.5
HEALTH_STALLED = 0.4
HEALTH_HUNG = 0.0

#: snapshot status strings, worst wins
STATUS_OK = "healthy"
STATUS_STRAGGLER = "straggler"
STATUS_STALLED = "data_stalled"
STATUS_HUNG = "hung"


class _NodeState:
    """Mutable per-node rolling state (guarded by the engine lock)."""

    __slots__ = (
        "node",
        "step_time_ewma",
        "step_rate_ewma",
        "steps_seen",
        "last_step",
        "last_step_wall",
        "step_walls",
        "stall_windows",
        "restarts",
        "faults",
        "incarnation",
        "last_event_wall",
        "last_event_seen",
        "last_heartbeat",
        "open_spans",
        "rss_mb",
        "cpu_percent",
        "mfu",
        "tflops",
        "device_share",
        "profile_wall",
    )

    def __init__(self, node: int):
        self.node = node
        self.step_time_ewma = 0.0
        self.step_rate_ewma = 0.0
        self.steps_seen = 0
        self.last_step = -1
        self.last_step_wall = 0.0
        #: recent step-end walls for windowed rate
        self.step_walls: Deque[float] = deque(maxlen=256)
        #: stage -> deque[(end_wall, dur)] for windowed stall share
        self.stall_windows: Dict[str, Deque[Tuple[float, float]]] = {}
        self.restarts = 0
        self.faults = 0
        self.incarnation = 0
        #: newest event wall clock from this node (the span heartbeat)
        self.last_event_wall = 0.0
        #: master-local monotonic time the newest event ARRIVED — the
        #: watchdog compares against this, not the event's own wall,
        #: so a node-side clock skew cannot fake (or mask) a hang
        self.last_event_seen = 0.0
        self.last_heartbeat = 0.0
        #: (pid, name) -> (open B count, mono of the newest B) —
        #: suppresses the watchdog while the node is attributably
        #: busy in a long non-step phase that only emits B now and E
        #: much later.  The mono bounds the suppression: a B whose E
        #: never arrives (crashed writer, dropped batch) must not
        #: disarm hang detection forever.
        self.open_spans: Dict[Tuple[int, str], Tuple[int, float]] = {}
        self.rss_mb = 0.0
        self.cpu_percent = 0.0
        #: live attribution (newest step_profile span from this
        #: node): per-category device-time shares + achieved MFU —
        #: what turns "node 3 is slow" into "node 3 is 40% copy"
        self.mfu = 0.0
        self.tflops = 0.0
        self.device_share: Dict[str, float] = {}
        self.profile_wall = 0.0


class HealthEngine:
    """Streaming per-node/per-phase derivations over the live job.

    Fed by the master's report dispatch: ``observe_events`` taps the
    ``TimelineAggregator`` (every ``TimelineEventsReport`` batch, so
    the PR-5 ``BatchedReport`` path feeds it for free),
    ``observe_heartbeat`` / ``observe_step`` / ``observe_fault`` /
    ``observe_resource`` tap the corresponding report messages in the
    servicer.  All methods are thread-safe and O(batch) — the report
    RPC path pays a dict update, never a sweep; the sweeps happen in
    ``snapshot()`` / the throttled gauge refresh.
    """

    #: EWMA smoothing for step time/rate (per new step span)
    EWMA_ALPHA = 0.3
    #: a node must complete this many steps before its EWMA can brand
    #: it a straggler — one cold first step is not a verdict
    MIN_STEPS_FOR_STRAGGLER = 3
    #: gauge refresh throttle (the sweep is O(nodes))
    GAUGE_REFRESH_S = 5.0
    #: a heartbeat older than this no longer proves the node alive
    #: (the job manager's dead-node monitor owns that case)
    HEARTBEAT_FRESH_S = 90.0

    def __init__(
        self,
        job: str = "",
        registry=None,
        straggler_ratio: Optional[float] = None,
        hang_watchdog_s: Optional[float] = None,
        window_s: Optional[float] = None,
    ):
        self._job = job or os.getenv("DLROVER_TPU_JOB_NAME", "default")
        self._registry = registry
        self.straggler_ratio = (
            straggler_ratio
            if straggler_ratio is not None
            else env_float(STRAGGLER_RATIO_ENV, 1.5)
        )
        self.hang_watchdog_s = (
            hang_watchdog_s
            if hang_watchdog_s is not None
            else env_float(HANG_WATCHDOG_ENV, 60.0)
        )
        self.window_s = (
            window_s
            if window_s is not None
            else env_float(HEALTH_WINDOW_ENV, 600.0)
        )
        self._nodes: Dict[int, _NodeState] = {}
        self._lock = threading.Lock()
        self._last_gauge_refresh = 0.0
        #: monotonic instant the engine started observing — a node is
        #: only hang-eligible after it produced at least one event
        self._t0 = time.monotonic()

    @property
    def job(self) -> str:
        return self._job

    # ----------------------------------------------------------- ingest
    def _state(self, node: int) -> _NodeState:
        state = self._nodes.get(node)
        if state is None:
            state = self._nodes[node] = _NodeState(node)
        return state

    def observe_events(self, node_id: int, events: List[dict]):
        """Tap for one node's timeline batch (call with the SAME
        accepted list the ``TimelineAggregator`` merged)."""
        now_mono = time.monotonic()
        with self._lock:
            for e in events:
                if not isinstance(e, dict):
                    continue
                node = int(e.get("node", node_id) or 0)
                state = self._state(node)
                wall = float(e.get("wall", 0.0) or 0.0)
                if wall > state.last_event_wall:
                    state.last_event_wall = wall
                state.last_event_seen = now_mono
                inc = int(e.get("inc", 0) or 0)
                if inc > state.incarnation:
                    state.incarnation = inc
                    # the restart replaced this node's processes: any
                    # B the dead incarnation never closed must not
                    # keep suppressing the watchdog
                    state.open_spans.clear()
                name = e.get("name", "")
                ph = e.get("ph", "")
                if ph == "B":
                    key = (int(e.get("pid", 0) or 0), name)
                    count, _opened = state.open_spans.get(
                        key, (0, now_mono)
                    )
                    state.open_spans[key] = (count + 1, now_mono)
                elif ph == "E":
                    key = (int(e.get("pid", 0) or 0), name)
                    count, opened = state.open_spans.get(
                        key, (0, now_mono)
                    )
                    if count > 1:
                        state.open_spans[key] = (count - 1, opened)
                    else:
                        state.open_spans.pop(key, None)
                if name == "step":
                    self._observe_step_span(state, e, wall)
                elif name == "data_stall":
                    self._observe_stall_span(state, e, wall)
                elif name == "step_profile":
                    self._observe_profile_span(state, e, wall)
                elif name == "restart" and ph in ("B", "X"):
                    state.restarts += 1
                elif name == "fault_injected" and ph == "i":
                    state.faults += 1
        self._maybe_refresh_gauges()

    def _observe_step_span(self, state: _NodeState, e: dict, wall: float):
        """One ``step`` span: the X record carries ``dur``; B/E pairs
        are folded at the E (ends are what mark progress)."""
        ph = e.get("ph")
        dur = e.get("dur")
        if ph == "X" and dur is not None:
            dur = max(float(dur), 0.0)
            end = wall + dur
        elif ph == "E":
            dur = None
            end = wall
        else:
            return  # a B alone is not a completed step
        state.steps_seen += 1
        state.step_walls.append(end)
        if end > state.last_step_wall:
            state.last_step_wall = end
        labels = e.get("labels") or {}
        try:
            step = int(labels.get("step", -1))
        except (TypeError, ValueError):
            step = -1
        if step > state.last_step:
            state.last_step = step
        if dur is not None and dur > 0:
            a = self.EWMA_ALPHA
            if state.step_time_ewma <= 0:
                state.step_time_ewma = dur
            else:
                state.step_time_ewma = (
                    a * dur + (1 - a) * state.step_time_ewma
                )
            rate = 1.0 / dur
            if state.step_rate_ewma <= 0:
                state.step_rate_ewma = rate
            else:
                state.step_rate_ewma = (
                    a * rate + (1 - a) * state.step_rate_ewma
                )

    def _observe_stall_span(self, state: _NodeState, e: dict, wall: float):
        if e.get("ph") != "X" or e.get("dur") is None:
            return  # stalls are emitted as X records (data/prefetch.py)
        dur = max(float(e["dur"]), 0.0)
        stage = str((e.get("labels") or {}).get("stage", "") or "?")
        window = state.stall_windows.setdefault(
            stage, deque(maxlen=1024)
        )
        window.append((wall + dur, dur))

    def _observe_profile_span(
        self, state: _NodeState, e: dict, wall: float
    ):
        """One ``step_profile`` span (the live attribution profiler's
        continuous leg): newest-wins per-category shares + MFU for
        this node."""
        if e.get("ph") != "X":
            return  # emitted as X records (attribution.py)
        if wall < state.profile_wall:
            return  # an older batch arriving late must not regress
        labels = e.get("labels") or {}
        share = {}
        for key, value in labels.items():
            if not str(key).startswith("share_"):
                continue
            try:
                share[str(key)[len("share_"):]] = float(value)
            except (TypeError, ValueError):
                continue
        if not share:
            return
        state.device_share = share
        state.profile_wall = wall
        try:
            state.mfu = float(labels.get("mfu", 0.0) or 0.0)
        except (TypeError, ValueError):
            state.mfu = 0.0
        try:
            state.tflops = float(labels.get("tflops", 0.0) or 0.0)
        except (TypeError, ValueError):
            state.tflops = 0.0

    def observe_heartbeat(self, node_id: int, timestamp: float):
        """Agent heartbeat tap.  Freshness is judged on the master's
        monotonic clock at ARRIVAL, not the agent's ``timestamp`` —
        a skewed agent clock must not fake liveness."""
        del timestamp
        with self._lock:
            state = self._state(int(node_id))
            state.last_heartbeat = max(
                state.last_heartbeat, time.monotonic()
            )

    def observe_step(self, node_id: int, step: int, timestamp: float):
        """``GlobalStep`` report tap — progress evidence even from
        jobs that never emit timeline spans."""
        with self._lock:
            state = self._state(int(node_id))
            if step > state.last_step:
                state.last_step = step
            if timestamp > state.last_step_wall:
                state.last_step_wall = timestamp
            state.last_event_seen = max(
                state.last_event_seen, time.monotonic()
            )

    def observe_fault(self, node_id: int, kind: str = ""):
        del kind  # counted, not classified (the error monitor does that)
        with self._lock:
            self._state(int(node_id)).faults += 1

    def observe_resource(
        self, node_id: int, cpu_percent: float, memory_mb: float
    ):
        with self._lock:
            state = self._state(int(node_id))
            state.cpu_percent = float(cpu_percent)
            state.rss_mb = float(memory_mb)

    # ------------------------------------------------------ derivations
    def _evict_locked(self, state: _NodeState, now_wall: float):
        horizon = now_wall - self.window_s
        for window in state.stall_windows.values():
            while window and window[0][0] < horizon:
                window.popleft()
        while state.step_walls and state.step_walls[0] < horizon:
            state.step_walls.popleft()

    def _median_step_time_locked(self) -> float:
        ewmas = sorted(
            s.step_time_ewma
            for s in self._nodes.values()
            if s.step_time_ewma > 0
            and s.steps_seen >= self.MIN_STEPS_FOR_STRAGGLER
        )
        if not ewmas:
            return 0.0
        if len(ewmas) == 2:
            # of two nodes the reference's upper middle is the slow
            # node's own EWMA, which hides it from its own verdict: the
            # faster node is the yardstick
            return ewmas[0]
        return ewmas[len(ewmas) // 2]

    #: open-span suppression expires after this many watchdog windows
    #: — a B whose E never arrives (crashed writer, batch lost to a
    #: master outage or a file rotation) must not disarm the watchdog
    #: for the rest of the job
    OPEN_SPAN_GRACE_WINDOWS = 10.0

    def _hang_suspect_locked(
        self, state: _NodeState, now_mono: float
    ) -> bool:
        """The span-heartbeat watchdog verdict for one node."""
        if state.last_event_seen <= 0:
            return False  # never produced an event: not armed yet
        if now_mono - state.last_event_seen < self.hang_watchdog_s:
            return False
        # attributably busy: an open non-step span (compile, restore,
        # rendezvous...) emitted its B and will emit E when done —
        # the ledger charges that time, the watchdog stays quiet.
        # The suppression is BOUNDED (and stale entries purged): an
        # orphaned B only buys its phase a grace window, not immunity.
        grace = self.hang_watchdog_s * self.OPEN_SPAN_GRACE_WINDOWS
        for key in [
            k
            for k, (_n, opened) in state.open_spans.items()
            if now_mono - opened > grace
        ]:
            state.open_spans.pop(key)
        if any(name != "step" for _pid, name in state.open_spans):
            return False
        # dead vs hung: no fresh heartbeat means the agent is gone too
        # (the job manager's heartbeat monitor owns dead nodes); hung
        # means the agent answers while the workers emit nothing
        if state.last_heartbeat > 0 and (
            now_mono - state.last_heartbeat > self.HEARTBEAT_FRESH_S
        ):
            return False
        return True

    def _stall_share_locked(
        self, state: _NodeState, now_wall: float
    ) -> Dict[str, float]:
        """Windowed stall share by stage (caller holds the lock and
        has evicted): stalled seconds over the stretch of the window
        the oldest retained stall actually covers — ONE definition,
        consumed by both the snapshot and the DataStallOperator."""
        shares = {}
        for stage, window in state.stall_windows.items():
            if not window:
                continue
            span = max(
                now_wall - max(window[0][0] - window[0][1],
                               now_wall - self.window_s),
                1e-9,
            )
            shares[stage] = min(
                sum(d for _t, d in window) / span, 1.0
            )
        return shares

    def node_snapshot_locked(
        self, state: _NodeState, median: float, now_wall: float,
        now_mono: float,
    ) -> dict:
        self._evict_locked(state, now_wall)
        stall_share = {
            stage: round(share, 4)
            for stage, share in self._stall_share_locked(
                state, now_wall
            ).items()
        }
        score = 0.0
        if (
            median > 0
            and state.step_time_ewma > 0
            and state.steps_seen >= self.MIN_STEPS_FOR_STRAGGLER
        ):
            score = state.step_time_ewma / median
        straggler = bool(score >= self.straggler_ratio)
        hung = self._hang_suspect_locked(state, now_mono)
        stalled = any(
            share >= 0.5 for share in stall_share.values()
        )
        if hung:
            status, health = STATUS_HUNG, HEALTH_HUNG
        elif straggler:
            status, health = STATUS_STRAGGLER, HEALTH_STRAGGLER
        elif stalled:
            status, health = STATUS_STALLED, HEALTH_STALLED
        else:
            status, health = STATUS_OK, HEALTH_OK
        # windowed rate: completed steps per second over the window
        rate = 0.0
        if len(state.step_walls) >= 2:
            span = state.step_walls[-1] - state.step_walls[0]
            if span > 0:
                rate = (len(state.step_walls) - 1) / span
        snap = {
            "node": state.node,
            "status": status,
            "health": health,
            "step": state.last_step,
            "steps_seen": state.steps_seen,
            "step_time_s": round(state.step_time_ewma, 6),
            "step_rate": round(rate or state.step_rate_ewma, 6),
            "straggler_score": round(score, 4),
            "straggler": straggler,
            "hung": hung,
            "stall_share": stall_share,
            "restarts": state.restarts,
            "faults": state.faults,
            "inc": state.incarnation,
            "cpu_percent": state.cpu_percent,
            "rss_mb": state.rss_mb,
            "last_event_age_s": round(
                now_mono - state.last_event_seen, 3
            ) if state.last_event_seen > 0 else None,
            "last_step_wall": state.last_step_wall or None,
        }
        # live attribution fields only once a step_profile span
        # arrived: with the profiler off the snapshot is EXACTLY the
        # pre-profiling one (pinned by tests)
        if state.device_share:
            from dlrover_tpu_torch.observability.attribution import (
                dominant_category,
            )

            dom = dominant_category(state.device_share)
            snap["mfu"] = round(state.mfu, 4)
            snap["tflops"] = round(state.tflops, 3)
            snap["device_share"] = dict(state.device_share)
            snap["dominant"] = (
                {"category": dom[0], "share": dom[1]}
                if dom
                else None
            )
        return snap

    def snapshot(self) -> dict:
        """The full derived state — what ``JobStatusRequest``,
        ``/status`` and ``scripts/top.py`` serve."""
        now_wall = time.time()
        now_mono = time.monotonic()
        with self._lock:
            median = self._median_step_time_locked()
            nodes = [
                self.node_snapshot_locked(
                    state, median, now_wall, now_mono
                )
                for state in sorted(
                    self._nodes.values(), key=lambda s: s.node
                )
            ]
        return {
            "job": self._job,
            "t": now_wall,
            "median_step_time_s": round(median, 6),
            "straggler_ratio": self.straggler_ratio,
            "hang_watchdog_s": self.hang_watchdog_s,
            "window_s": self.window_s,
            "nodes": nodes,
            "stragglers": [
                n["node"] for n in nodes if n["straggler"]
            ],
            "hangs": [n["node"] for n in nodes if n["hung"]],
        }

    # ------------------------------------------------- operator queries
    def stragglers(self) -> List[Tuple[int, float]]:
        """``[(node, score)]`` for nodes past the ratio (the
        ``StragglerOperator``'s input)."""
        with self._lock:
            median = self._median_step_time_locked()
            if median <= 0:
                return []
            out = []
            for state in self._nodes.values():
                if (
                    state.step_time_ewma > 0
                    and state.steps_seen
                    >= self.MIN_STEPS_FOR_STRAGGLER
                ):
                    score = state.step_time_ewma / median
                    if score >= self.straggler_ratio:
                        out.append((state.node, round(score, 4)))
            return sorted(out, key=lambda t: -t[1])

    def hang_suspects(self) -> List[Tuple[int, float]]:
        """``[(node, silence_s)]`` flagged by the span-heartbeat
        watchdog (the ``HangWatchdogOperator``'s input)."""
        now_mono = time.monotonic()
        with self._lock:
            return [
                (
                    state.node,
                    round(now_mono - state.last_event_seen, 3),
                )
                for state in self._nodes.values()
                if self._hang_suspect_locked(state, now_mono)
            ]

    def median_step_time(self) -> float:
        """The across-node median step-time EWMA (0 until enough
        nodes have completed ``MIN_STEPS_FOR_STRAGGLER`` steps) — the
        Brain's per-world scaling-history sample."""
        with self._lock:
            return self._median_step_time_locked()

    def attribution(self) -> Dict[int, Tuple[str, float]]:
        """Per-node dominant device-time category from the newest
        ``step_profile`` span: ``{node: (category, share)}``.  The
        straggler/data-stall operators cite this so a conclusion says
        WHY — a straggler at 40% copy share is an offload problem,
        not a bad host.  Empty until the continuous profiling leg is
        on (``DLROVER_TPU_PROFILE_EVERY_N_STEPS`` > 0)."""
        from dlrover_tpu_torch.observability.attribution import (
            dominant_category,
        )

        with self._lock:
            out: Dict[int, Tuple[str, float]] = {}
            for state in self._nodes.values():
                dom = dominant_category(state.device_share)
                if dom is None:
                    continue  # no profile yet / all-zero CPU shares
                out[state.node] = (dom[0], round(dom[1], 4))
            return out

    def stall_shares(self) -> Dict[int, Dict[str, float]]:
        """Per-node windowed data-stall share by stage (the
        ``DataStallOperator``'s input)."""
        now_wall = time.time()
        out: Dict[int, Dict[str, float]] = {}
        with self._lock:
            for state in self._nodes.values():
                self._evict_locked(state, now_wall)
                shares = self._stall_share_locked(state, now_wall)
                if shares:
                    out[state.node] = shares
        return out

    # ------------------------------------------------------------ gauges
    def _maybe_refresh_gauges(self):
        if self._registry is None:
            return
        now = time.monotonic()
        if now - self._last_gauge_refresh < self.GAUGE_REFRESH_S:
            return
        self._last_gauge_refresh = now
        self.refresh_gauges()

    def refresh_gauges(self):
        """Export the per-node health + straggler-score gauges (also
        callable directly — the status server refreshes before
        rendering ``/metrics``)."""
        if self._registry is None:
            return
        try:
            snap = self.snapshot()
            for n in snap["nodes"]:
                labels = {"node": n["node"]}
                self._registry.set_gauge(
                    "dlrover_tpu_node_health",
                    n["health"],
                    labels=labels,
                )
                self._registry.set_gauge(
                    "dlrover_tpu_straggler_score",
                    n["straggler_score"],
                    labels=labels,
                )
                # attribution gauges only once a step_profile span
                # arrived — a profiler-off job exports EXACTLY the
                # pre-profiling series set (pinned by tests)
                if n.get("device_share"):
                    self._registry.set_gauge(
                        "dlrover_tpu_node_mfu",
                        n["mfu"],
                        labels=labels,
                    )
                    for cat, share in n["device_share"].items():
                        self._registry.set_gauge(
                            "dlrover_tpu_device_share",
                            share,
                            labels={
                                "node": n["node"],
                                "category": cat,
                            },
                        )
        except Exception as e:  # noqa: BLE001 - gauges must not break reports
            logger.warning("health gauge refresh failed: %s", e)

    # ------------------------------------------------------------- misc
    def to_json(self) -> str:
        return json.dumps(self.snapshot(), separators=(",", ":"))


#: MasterHealth thresholds (see class docstring)
MASTER_P99_ENV = "DLROVER_TPU_MASTER_OVERLOAD_P99_S"
MASTER_QUEUE_FRAC_ENV = "DLROVER_TPU_MASTER_OVERLOAD_QUEUE_FRAC"
MASTER_LAG_ROWS_ENV = "DLROVER_TPU_MASTER_OVERLOAD_LAG_ROWS"
MASTER_OCCUPANCY_ENV = "DLROVER_TPU_MASTER_OVERLOAD_OCCUPANCY"
MASTER_REJECTS_ENV = "DLROVER_TPU_MASTER_OVERLOAD_REJECTS"
MASTER_SUSTAIN_ENV = "DLROVER_TPU_MASTER_OVERLOAD_SUSTAIN"
MASTER_COOLDOWN_ENV = "DLROVER_TPU_MASTER_OVERLOAD_COOLDOWN_S"


class MasterHealth:
    """The master's own health deriver — the :class:`HealthEngine`
    watches the fleet, this watches the component every fleet signal
    flows through.  Each :meth:`evaluate` call (the DiagnosisManager's
    loop cadence is the derivation interval) reads the live
    self-telemetry (``observability/self_telemetry.py``) and keeps a
    per-reason STREAK; a breach sustained for ``sustain`` consecutive
    evaluations becomes one overload verdict:

    - ``rpc_p99``        — windowed p99 latency of the FAST RPC
      kinds (parked long-polls excluded — their latency is the wait
      window they asked for; ``self_telemetry.WAIT_KINDS``) past
      ``DLROVER_TPU_MASTER_OVERLOAD_P99_S`` (default 0.5 s: a healthy
      dispatch is single-digit ms, half a second means the master is
      the job's critical path);
    - ``queue_depth``    — write-behind queue past
      ``..._QUEUE_FRAC`` (0.8) of its bound: the next burst
      backpressures the report RPC path;
    - ``journal_lag``    — rows enqueued minus rows flushed past
      ``..._LAG_ROWS`` (5000): a crash now loses that much claimed
      durability;
    - ``pool_saturated`` — busy workers (parked long-polls included)
      past ``..._OCCUPANCY`` (0.9) of the pool: mutation RPCs are
      about to queue behind parked waiters;
    - ``parked_rejects`` — at least ``..._REJECTS`` (1) long-polls
      per interval degraded to immediate answers because every
      parked-wait slot was held: the pool is too small for this
      fleet's idle waits (raise ``DLROVER_TPU_MASTER_WORKERS``).
      Occupancy is an instantaneous sample and can flap; the
      rejection COUNTER only moves when the cap was genuinely hit,
      so this is the robust shrunken-pool signature.

    Firing emits a ``master_overload`` instant (labels lint-enforced)
    and starts a per-reason cooldown (``..._COOLDOWN_S``, 300 s); the
    ``MasterOverloadOperator`` in ``master/diagnosis.py`` turns the
    same verdicts into diagnosis conclusions, so the Brain's signal
    chain covers its own substrate.
    """

    def __init__(
        self,
        telemetry,
        p99_s: Optional[float] = None,
        queue_frac: Optional[float] = None,
        lag_rows: Optional[float] = None,
        occupancy: Optional[float] = None,
        sustain: Optional[int] = None,
        cooldown_s: Optional[float] = None,
    ):
        self._telemetry = telemetry
        self.p99_s = (
            p99_s if p99_s is not None
            else env_float(MASTER_P99_ENV, 0.5)
        )
        self.queue_frac = (
            queue_frac if queue_frac is not None
            else env_float(MASTER_QUEUE_FRAC_ENV, 0.8)
        )
        self.lag_rows = (
            lag_rows if lag_rows is not None
            else env_float(MASTER_LAG_ROWS_ENV, 5000.0)
        )
        self.occupancy = (
            occupancy if occupancy is not None
            else env_float(MASTER_OCCUPANCY_ENV, 0.9)
        )
        self.rejects = env_float(MASTER_REJECTS_ENV, 1.0)
        self.sustain = max(
            int(
                sustain if sustain is not None
                else env_float(MASTER_SUSTAIN_ENV, 2.0)
            ),
            1,
        )
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else env_float(MASTER_COOLDOWN_ENV, 300.0)
        )
        self._lock = threading.Lock()
        self._streaks: Dict[str, int] = {}
        self._last_fired: Dict[str, float] = {}
        self._last_verdicts: List[dict] = []
        #: rejected-waits counter at the previous evaluate — the
        #: per-interval delta is the parked_rejects signal
        self._last_rejected = 0

    def _breaches(self) -> List[Tuple[str, float, float]]:
        """Current ``(reason, value, threshold)`` breaches from one
        telemetry read."""
        tel = self._telemetry
        out: List[Tuple[str, float, float]] = []
        p99 = tel.window_p99()
        if p99 >= self.p99_s:
            out.append(("rpc_p99", p99, self.p99_s))
        ds = tel.datastore_health()
        if ds:
            cap = max(float(ds.get("queue_cap", 0) or 0), 1.0)
            depth = float(ds.get("queue_depth", 0) or 0)
            if depth / cap >= self.queue_frac:
                out.append(
                    ("queue_depth", depth, self.queue_frac * cap)
                )
            lag = float(ds.get("lag_rows", 0) or 0)
            if lag >= self.lag_rows:
                out.append(("journal_lag", lag, self.lag_rows))
        occ = tel.occupancy()
        if occ >= self.occupancy:
            out.append(("pool_saturated", occ, self.occupancy))
        rejected = getattr(tel, "rejected_waits", 0)
        delta = rejected - self._last_rejected
        self._last_rejected = rejected
        if delta >= self.rejects:
            out.append(("parked_rejects", float(delta), self.rejects))
        return out

    def evaluate(self) -> List[dict]:
        """One derivation interval: update streaks, fire sustained
        breaches past their cooldown.  Returns the verdicts fired
        THIS call (each also emitted as a ``master_overload``
        instant)."""
        now = time.monotonic()
        breaches = self._breaches()
        fired: List[dict] = []
        with self._lock:
            current = {r for r, _v, _t in breaches}
            for reason in list(self._streaks):
                if reason not in current:
                    self._streaks.pop(reason)
            for reason, value, threshold in breaches:
                streak = self._streaks.get(reason, 0) + 1
                self._streaks[reason] = streak
                if streak < self.sustain:
                    continue
                last = self._last_fired.get(reason, -1e18)
                if now - last < self.cooldown_s:
                    continue
                self._last_fired[reason] = now
                # acting consumes the streak (like the Brain's rules)
                self._streaks[reason] = 0
                fired.append(
                    {
                        "reason": reason,
                        "value": round(float(value), 6),
                        "threshold": round(float(threshold), 6),
                        "streak": streak,
                        "t": time.time(),
                    }
                )
            if fired:
                self._last_verdicts = fired
        for v in fired:
            try:
                from dlrover_tpu_torch.observability.events import (
                    get_event_logger,
                )

                get_event_logger().instant(
                    "master_overload",
                    reason=v["reason"],
                    value=v["value"],
                    threshold=v["threshold"],
                    streak=v["streak"],
                )
            except Exception as e:  # noqa: BLE001 - telemetry only
                logger.warning(
                    "master_overload instant emit failed: %s", e
                )
        return fired

    def status(self) -> dict:
        """Streaks + newest verdicts for the ``master`` status
        section."""
        with self._lock:
            return {
                "streaks": dict(self._streaks),
                "last_verdicts": list(self._last_verdicts),
                "sustain": self.sustain,
                "cooldown_s": self.cooldown_s,
            }


# --------------------------------------------------------------------------
# serving-plane health (ISSUE 16): the replica observatory
# --------------------------------------------------------------------------

SERVING_SLO_RATIO_ENV = "DLROVER_TPU_SERVING_SLO_RATIO"
SERVING_DEAD_AIR_ENV = "DLROVER_TPU_SERVING_DEAD_AIR_S"
SERVING_KV_PRESSURE_ENV = "DLROVER_TPU_SERVING_KV_PRESSURE"
SERVING_PREEMPT_RATE_ENV = "DLROVER_TPU_SERVING_PREEMPT_RATE"
SERVING_SUSTAIN_ENV = "DLROVER_TPU_SERVING_SUSTAIN"
SERVING_COOLDOWN_ENV = "DLROVER_TPU_SERVING_COOLDOWN_S"
SERVING_DERIVE_ENV = "DLROVER_TPU_SERVING_DERIVE_S"

#: Per-replica SLO samples kept for the rolling p99 (one sample per
#: completed request); enough for a stable tail, small enough that a
#: recovered replica sheds its bad history within ~2 windows.
SERVING_SAMPLE_WINDOW = 128
#: A p99 over fewer completions than this is noise, not a signal.
MIN_SLO_SAMPLES = 3


def _tail_q(samples, q: float) -> float:
    """Nearest-rank quantile of a small sample deque (0.0 when
    empty)."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))]


class _ServingReplicaState:
    """Per-replica derivation state (mirrors ``_NodeState``)."""

    __slots__ = (
        "idx",
        "ttft",
        "tbt",
        "e2e",
        "last_progress_t",
        "last_preempts",
        "preempt_delta",
        "kv_utilization",
        "prefix_hit_rate",
        "outstanding",
        "alive",
        "drained",
        "verdict",
        "why",
        "slo_score",
        "streaks",
        "role",
    )

    def __init__(self, idx: int, now: float):
        self.idx = idx
        self.ttft: Deque[float] = deque(maxlen=SERVING_SAMPLE_WINDOW)
        self.tbt: Deque[float] = deque(maxlen=SERVING_SAMPLE_WINDOW)
        self.e2e: Deque[float] = deque(maxlen=SERVING_SAMPLE_WINDOW)
        # seeded at first sight so a freshly spawned replica gets a
        # full dead-air grace window before the watchdog may name it
        self.last_progress_t = now
        self.last_preempts = 0
        self.preempt_delta = 0
        self.kv_utilization = 0.0
        self.prefix_hit_rate = 0.0
        self.outstanding = 0
        self.alive = True
        self.drained = False
        self.verdict = "ok"
        self.why = "ok"
        self.slo_score = 0.0
        self.streaks: Dict[str, int] = {}
        # fleet role (ISSUE 17): a designated prefill worker is
        # judged against PREFILL-fleet medians — it completes no
        # requests itself (no TTFT/TBT series) and must never read
        # as a decode straggler
        self.role = "decode"


class ServingHealthEngine:
    """Streaming per-replica health derivation for the serving plane —
    the :class:`HealthEngine` pattern (per-node state + fleet-median
    straggler scoring + a silence watchdog) crossed with
    :class:`MasterHealth`'s streak/sustain/cooldown verdict machinery,
    fed by the dispatcher instead of an RPC stream:

    - ``note_result`` per completed request (TTFT / request-level TBT
      p99 / e2e / queue-wait off the response ring);
    - ``note_stats`` per replica STATS window (KV pressure, cumulative
      preemptions, prefix hit rate; a window with tokens flowing
      refreshes the progress clock);
    - ``evaluate(fleet)`` once per derivation interval
      (``DLROVER_TPU_SERVING_DERIVE_S``, default 1 s; internally
      throttled so the dispatcher may call it every pump) with the
      dispatcher's live view (alive/drained/outstanding per replica).

    Derivations per replica:

    - **slo_straggler** — rolling TTFT or TBT p99 at least
      ``DLROVER_TPU_SERVING_SLO_RATIO`` (2.0) times the fleet median
      of the same quantile (needs >= 2 replicas with
      ``MIN_SLO_SAMPLES`` completions — a fleet of one has no peers
      to be slower than);
    - **dead_air** — outstanding requests, a live worker process, and
      no token progress (no completion, no tokens-flowing STATS
      window) for ``DLROVER_TPU_SERVING_DEAD_AIR_S`` (5 s) — the
      wedged-mid-decode signature a throughput gauge can't show;
    - **kv_pressure** — pool utilization at or past
      ``DLROVER_TPU_SERVING_KV_PRESSURE`` (0.95);
    - **preempt_storm** — at least ``DLROVER_TPU_SERVING_PREEMPT_RATE``
      (3) NEW preemptions within one derivation interval.

    A reason sustained ``DLROVER_TPU_SERVING_SUSTAIN`` (2) consecutive
    derivations becomes the replica's verdict (priority: dead_air >
    slo_straggler > kv_pressure > preempt_storm), emits one
    ``slo_breach`` instant per reason under a per-(replica, reason)
    cooldown (``DLROVER_TPU_SERVING_COOLDOWN_S``, 30 s), and every
    verdict CHANGE emits a ``serving_health`` instant — the trace
    shows the observatory naming the replica next to the spans that
    convicted it.  Fleet-level: median TTFT/TBT p99 and the weighted
    prefix hit rate."""

    _VERDICT_GAUGE = {
        "ok": 1.0,
        "preempt_storm": 0.7,
        "kv_pressure": 0.6,
        "slo_straggler": 0.4,
        "dead_air": 0.1,
    }

    def __init__(
        self,
        slo_ratio: Optional[float] = None,
        dead_air_s: Optional[float] = None,
        kv_pressure: Optional[float] = None,
        preempt_rate: Optional[float] = None,
        sustain: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        interval_s: Optional[float] = None,
    ):
        self.slo_ratio = (
            slo_ratio if slo_ratio is not None
            else env_float(SERVING_SLO_RATIO_ENV, 2.0)
        )
        self.dead_air_s = (
            dead_air_s if dead_air_s is not None
            else env_float(SERVING_DEAD_AIR_ENV, 5.0)
        )
        self.kv_pressure = (
            kv_pressure if kv_pressure is not None
            else env_float(SERVING_KV_PRESSURE_ENV, 0.95)
        )
        self.preempt_rate = (
            preempt_rate if preempt_rate is not None
            else env_float(SERVING_PREEMPT_RATE_ENV, 3.0)
        )
        self.sustain = max(
            int(
                sustain if sustain is not None
                else env_float(SERVING_SUSTAIN_ENV, 2.0)
            ),
            1,
        )
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else env_float(SERVING_COOLDOWN_ENV, 30.0)
        )
        self.interval_s = max(
            interval_s if interval_s is not None
            else env_float(SERVING_DERIVE_ENV, 1.0),
            0.05,
        )
        self._lock = threading.Lock()
        self._replicas: Dict[int, _ServingReplicaState] = {}
        self._last_eval = 0.0
        self._last_fired: Dict[Tuple[int, str], float] = {}
        self._fleet: Dict[str, float] = {}
        self.derivations = 0

    def _state(self, idx: int) -> _ServingReplicaState:
        st = self._replicas.get(idx)
        if st is None:
            st = self._replicas[idx] = _ServingReplicaState(
                idx, time.monotonic()
            )
        return st

    # ------------------------------------------------------- ingest
    def note_result(self, idx: int, ttft_s: float = 0.0,
                    tbt_p99_s: float = 0.0, e2e_s: float = 0.0,
                    queue_wait_s: float = 0.0):
        """One completed request from replica ``idx`` (dispatcher's
        RESULT path)."""
        with self._lock:
            st = self._state(idx)
            st.ttft.append(float(ttft_s))
            st.tbt.append(float(tbt_p99_s))
            st.e2e.append(float(e2e_s))
            st.last_progress_t = time.monotonic()

    def note_ship(self, idx: int):
        """One shipped-KV manifest from prefill worker ``idx``
        (dispatcher's SHIP path) — a ship IS the prefill worker's
        completion, so it refreshes the progress clock the same way a
        RESULT refreshes a decode replica's (without it a busy
        prefill worker would read as dead air: it never answers
        RESULT)."""
        with self._lock:
            self._state(idx).last_progress_t = time.monotonic()

    def note_stats(self, idx: int, stats: Dict):
        """One replica STATS window.  Tokens flowing refresh the
        progress clock; a zero-throughput window with work outstanding
        deliberately does NOT — that silence is the dead-air signal."""
        with self._lock:
            st = self._state(idx)
            now = time.monotonic()
            if float(stats.get("tokens_per_s", 0.0) or 0.0) > 0.0:
                st.last_progress_t = now
            st.kv_utilization = float(
                stats.get("kv_utilization", 0.0) or 0.0
            )
            st.prefix_hit_rate = float(
                stats.get("prefix_hit_rate", 0.0) or 0.0
            )
            preempts = int(stats.get("preemptions", 0) or 0)
            st.preempt_delta += max(preempts - st.last_preempts, 0)
            st.last_preempts = preempts

    # ----------------------------------------------------- derivation
    def _breaches(self, st: _ServingReplicaState, now: float,
                  med_ttft: float, med_tbt: float, peers: int):
        """Current (reason, value, threshold) breaches for one LIVE
        replica."""
        out: List[Tuple[str, float, float]] = []
        if (
            st.outstanding > 0
            and now - st.last_progress_t >= self.dead_air_s
        ):
            out.append(
                ("dead_air", now - st.last_progress_t,
                 self.dead_air_s)
            )
        score = 0.0
        if peers >= 2 and len(st.ttft) >= MIN_SLO_SAMPLES:
            if med_ttft > 0:
                score = _tail_q(st.ttft, 0.99) / med_ttft
            if med_tbt > 0:
                score = max(
                    score, _tail_q(st.tbt, 0.99) / med_tbt
                )
        st.slo_score = round(score, 3)
        if score >= self.slo_ratio:
            out.append(("slo_straggler", score, self.slo_ratio))
        if st.kv_utilization >= self.kv_pressure:
            out.append(
                ("kv_pressure", st.kv_utilization, self.kv_pressure)
            )
        if st.preempt_delta >= self.preempt_rate:
            out.append(
                ("preempt_storm", float(st.preempt_delta),
                 self.preempt_rate)
            )
        return out

    _PRIORITY = ("dead_air", "slo_straggler", "kv_pressure",
                 "preempt_storm")

    def evaluate(self, fleet: List[Dict]) -> List[dict]:
        """One derivation pass over the dispatcher's live fleet view
        (``[{idx, alive, drained, outstanding, ...stats}]``);
        internally throttled to the derivation interval, so callers
        may invoke it every dispatch pump.  Returns the ``slo_breach``
        verdicts fired THIS pass."""
        now = time.monotonic()
        fired: List[dict] = []
        instants: List[Tuple[str, Dict]] = []
        with self._lock:
            if now - self._last_eval < self.interval_s:
                return []
            self._last_eval = now
            self.derivations += 1
            live = []
            for row in fleet:
                st = self._state(int(row["idx"]))
                st.alive = bool(row.get("alive", True))
                st.drained = bool(row.get("drained", False))
                st.outstanding = int(row.get("outstanding", 0))
                st.role = str(row.get("role", "decode")) or "decode"
                if st.alive and not st.drained:
                    live.append(st)
            # straggler medians are ROLE-SPLIT (ISSUE 17): a prefill
            # worker's peers are the other prefill workers — judging
            # it against decode medians would convict it on series it
            # cannot have (it never completes a request itself)
            role_meds: Dict[str, Tuple[float, float, int]] = {}
            for role in {st.role for st in live}:
                pool = [st for st in live if st.role == role]
                ttft_p99s = [
                    _tail_q(st.ttft, 0.99) for st in pool
                    if len(st.ttft) >= MIN_SLO_SAMPLES
                ]
                tbt_p99s = [
                    _tail_q(st.tbt, 0.99) for st in pool
                    if len(st.tbt) >= MIN_SLO_SAMPLES
                ]
                role_meds[role] = (
                    _tail_q(ttft_p99s, 0.5),
                    _tail_q(tbt_p99s, 0.5),
                    len(ttft_p99s),
                )
            med_ttft, med_tbt, peers = role_meds.get(
                "decode", (0.0, 0.0, 0)
            )
            hit_rates = [st.prefix_hit_rate for st in live]
            self._fleet = {
                "ttft_p99_median_s": round(med_ttft, 4),
                "tbt_p99_median_s": round(med_tbt, 4),
                "prefix_hit_rate": round(
                    sum(hit_rates) / len(hit_rates), 4
                ) if hit_rates else 0.0,
                "replicas_alive": len(live),
            }
            for st in self._replicas.values():
                prev_verdict = st.verdict
                if not st.alive or st.drained:
                    st.verdict = "drained" if st.drained else "dead"
                    st.why = st.verdict
                    st.streaks.clear()
                    st.preempt_delta = 0
                    if st.verdict != prev_verdict:
                        instants.append(
                            (
                                "serving_health",
                                {
                                    "replica": st.idx,
                                    "verdict": st.verdict,
                                    "reason": st.verdict,
                                    "role": st.role,
                                },
                            )
                        )
                    continue
                r_ttft, r_tbt, r_peers = role_meds.get(
                    st.role, (0.0, 0.0, 0)
                )
                breaches = self._breaches(
                    st, now, r_ttft, r_tbt, r_peers
                )
                st.preempt_delta = 0
                current = {r for r, _v, _t in breaches}
                for reason in list(st.streaks):
                    if reason not in current:
                        st.streaks.pop(reason)
                sustained: Dict[str, Tuple[float, float]] = {}
                for reason, value, threshold in breaches:
                    streak = st.streaks.get(reason, 0) + 1
                    st.streaks[reason] = streak
                    if streak < self.sustain:
                        continue
                    sustained[reason] = (value, threshold)
                    key = (st.idx, reason)
                    last = self._last_fired.get(key, -1e18)
                    if now - last < self.cooldown_s:
                        continue
                    self._last_fired[key] = now
                    verdict = {
                        "replica": st.idx,
                        "reason": reason,
                        "value": round(float(value), 4),
                        "threshold": round(float(threshold), 4),
                        "streak": streak,
                        "role": st.role,
                        "t": time.time(),
                    }
                    fired.append(verdict)
                    instants.append(("slo_breach", dict(verdict)))
                st.verdict = next(
                    (r for r in self._PRIORITY if r in sustained),
                    "ok",
                )
                if st.verdict == "ok":
                    st.why = "ok"
                    st.slo_score = round(st.slo_score, 3)
                else:
                    value, threshold = sustained[st.verdict]
                    st.why = (
                        f"{st.verdict} {value:.3g} vs {threshold:.3g}"
                    )
                if st.verdict != prev_verdict:
                    instants.append(
                        (
                            "serving_health",
                            {
                                "replica": st.idx,
                                "verdict": st.verdict,
                                "reason": (
                                    st.verdict
                                    if st.verdict != "ok"
                                    else "recovered"
                                ),
                                "role": st.role,
                            },
                        )
                    )
            gauge_rows = [
                (st.idx, st.role,
                 self._VERDICT_GAUGE.get(st.verdict, 0.0))
                for st in self._replicas.values()
                if st.alive and not st.drained
            ]
        for name, labels in instants:
            try:
                from dlrover_tpu_torch.observability.events import (
                    get_event_logger,
                )

                # literal names so the schema lint can see them;
                # labels carry every required key (built above)
                if name == "slo_breach":
                    get_event_logger().instant("slo_breach", **labels)
                else:
                    get_event_logger().instant(
                        "serving_health", **labels
                    )
            except Exception as e:  # noqa: BLE001 - telemetry only
                logger.warning("%s instant emit failed: %s", name, e)
        try:
            from dlrover_tpu_torch.observability.metrics import get_registry

            reg = get_registry()
            for idx, role, value in gauge_rows:
                # the role label rides along; per-replica retirement
                # still matches (retire_series is a subset match)
                reg.set_gauge(
                    "dlrover_tpu_serving_health",
                    value,
                    labels={"replica": str(idx), "role": role},
                )
        except Exception as e:  # noqa: BLE001 - telemetry only
            logger.warning("serving health gauge export failed: %s", e)
        return fired

    def reset(self):
        """Forget all derivation history — per-replica SLO windows,
        streaks, verdicts, breach cooldowns.  For the moment a fleet's
        past stops being representative: after warmup (compile-era
        TTFTs would otherwise sit in the p99 windows for ~128
        requests) or a redeploy."""
        with self._lock:
            self._replicas.clear()
            self._last_fired.clear()
            self._fleet = {}

    # -------------------------------------------------------- readers
    def snapshot(self) -> Dict:
        """The ``health`` section of the serving status: per-replica
        verdict + why + the numbers behind them, plus the fleet
        medians."""
        with self._lock:
            return {
                "replicas": [
                    {
                        "replica": st.idx,
                        "verdict": st.verdict,
                        "why": st.why,
                        "role": st.role,
                        "slo_score": st.slo_score,
                        "ttft_p99_s": round(
                            _tail_q(st.ttft, 0.99), 4
                        ),
                        "tbt_p99_s": round(_tail_q(st.tbt, 0.99), 4),
                        "e2e_p99_s": round(_tail_q(st.e2e, 0.99), 4),
                        "kv_utilization": round(
                            st.kv_utilization, 4
                        ),
                        "prefix_hit_rate": round(
                            st.prefix_hit_rate, 4
                        ),
                        "outstanding": st.outstanding,
                        "silent_s": round(
                            max(
                                time.monotonic()
                                - st.last_progress_t,
                                0.0,
                            ),
                            2,
                        ),
                        "streaks": dict(st.streaks),
                    }
                    for st in sorted(
                        self._replicas.values(),
                        key=lambda s: s.idx,
                    )
                ],
                "fleet": dict(self._fleet),
                "derivations": self.derivations,
                "interval_s": self.interval_s,
                "sustain": self.sustain,
            }
