"""Unified job-event timeline: structured spans + goodput attribution.

Copy of ``dlrover_tpu/observability/events.py``: the same records on the
same ``DLROVER_TPU_EVENTS_FILE``, so one timeline reader merges both
packages' spans.  The master's ``TimelineAggregator`` writes into the
Brain datastore and feeds the health engine, as the reference's does.

The reference's headline metric is goodput (69% -> 95% under faults),
but a single ratio cannot say WHERE the lost wall clock went —
rendezvous, recompile, checkpoint stalls, restarts.  This module is
the repo-wide answer:

- every process (master, agent, trainer, launcher) appends structured
  begin/end span and instant events to one JSONL file — one
  ``os.write`` per line on an ``O_APPEND`` fd, so concurrent writers
  never interleave; each record carries BOTH clocks (``wall`` for
  cross-process merging, ``mono`` for drift-free durations) plus the
  job/node/rank/incarnation labels that correlate a restart's spans
  across worker generations;
- :func:`compute_ledger` partitions a merged timeline's wall clock
  into phases by priority sweep — the **goodput ledger**: phase losses
  sum EXACTLY to ``wall − useful`` (the invariant the tests assert),
  so ``1 − goodput`` is fully attributed, never hand-waved;
- :func:`export_chrome_trace` renders the same timeline as a
  Perfetto-loadable chrome trace (one track per node/rank);
- :class:`TimelineAggregator` is the master-side sink: per-node event
  batches arrive over the report RPC (``common/messages.py``
  ``TimelineEventsReport``), merge into the sqlite Brain datastore,
  and serve the live ledger through a get RPC and as gauges on the
  ``MetricsRegistry`` the native Prometheus exporter reads.

Phase names are a CLOSED set (``PHASES`` + ``INSTANT_EVENTS``);
``scripts/check_event_schema.py`` lints every emit site against it so
a typo'd phase can never silently drop out of the ledger.
"""

import io
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger

EVENTS_FILE_ENV = "DLROVER_TPU_EVENTS_FILE"

# One (wall, mono) anchor per process: every record's ``wall`` is
# derived from ``mono`` against this pair, so the two clocks carry a
# constant offset within a writer.  Sampling both clocks per event
# would let the offset jitter by microseconds between records, and
# span ends reconstructed as ``begin.wall + mono_delta`` could then
# land before a nested child's end.
_WALL_EPOCH = time.time()
_MONO_EPOCH = time.monotonic()


def anchored_now(mono: Optional[float] = None) -> float:
    """Wall-clock "now" on the same ``(wall, mono)`` anchor the
    emitted records use.  Callers that report a span after the fact
    (``complete()``) must sample its start through this — passing the
    ``time.monotonic()`` they already took, if any — so X-records stay
    on one clock with B/E records even across an NTP step."""
    if mono is None:
        mono = time.monotonic()
    return _WALL_EPOCH + (mono - _MONO_EPOCH)

#: Span phases, HIGHEST attribution priority first.  When spans
#: overlap, each instant of wall clock is charged to the
#: highest-priority covering phase.  ``step`` is the only USEFUL
#: phase; ``data_stall`` outranks it because a step span measured
#: step_done-to-step_done covers the between-step input wait — a
#: named 10s pipeline stall must surface as loss, not as useful time.
#: Everything below ``step`` loses to it on overlap: an ASYNC
#: checkpoint drain or a preemption flush running while steps
#: complete charges the step (training progressed, nothing was
#: lost), and a rendezvous nested inside a restart charges
#: rendezvous.
PHASE_DATA_STALL = "data_stall"
PHASE_STEP = "step"
PHASE_PREEMPTION_DRAIN = "preemption_drain"
PHASE_CHECKPOINT_RESTORE = "checkpoint_restore"
# restart-critical-path legs (trainer/restart_path.py): the restore
# byte stream, the background AOT compile, the device-world wait and
# the staged-bytes -> device finish.  They outrank their serial
# cousins' parent (restart_path) but rank BELOW checkpoint_restore /
# compile so a serial-path span that covers the same instant keeps
# its attribution.
PHASE_RESTORE_PREFETCH = "restore_prefetch"
# elastic-reshard data leg (trainer/checkpoint/reshard.py): the
# overlap-range reads that reassemble this rank's NEW slices from a
# checkpoint written by a DIFFERENT world size.  Ranks with the other
# restore legs: below checkpoint_restore (a covering serial-restore
# span keeps its attribution) and beside restore_prefetch (the leg it
# replaces when the world changed).
PHASE_RESHARD = "reshard"
PHASE_FINISH_RESTORE = "finish_restore"
PHASE_COMPILE = "compile"
PHASE_AOT_COMPILE = "aot_compile"
PHASE_RENDEZVOUS = "rendezvous"
PHASE_RENDEZVOUS_WAIT = "rendezvous_wait"
# the agent's health check of its cards before a rendezvous
# (agent/node_check.py): the payload processes' matmul and all-reduce.
# A port phase (the reference runs the check but emits no span); it
# ranks with the rendezvous it precedes
PHASE_NODE_CHECK = "node_check"
PHASE_CHECKPOINT_SAVE = "checkpoint_save"
# host-offload optimizer-state chunk stream (optimizers/host_offload):
# the D2H/H2D traffic of one streamed update.  Ranks BELOW step on
# purpose — the stream is designed to overlap the backward, so an
# instant covered by both charges the step (nothing was lost); a
# standalone offload_copy (the exposed tail) surfaces as its own loss
PHASE_OFFLOAD_COPY = "offload_copy"
# parent span covering one whole overlapped (or fallen-back serial)
# restart critical path; the child legs above carve their shares out
PHASE_RESTART_PATH = "restart_path"
PHASE_RESTART = "restart"
# live attribution profiler (observability/attribution.py): one
# traced-window span per continuous-leg capture, whose labels carry
# the per-category device-time shares + achieved TFLOP/s + MFU the
# HealthEngine derives per-node gauges from.  Ranks BELOW step on
# purpose: the window covers real train steps, which keep their
# ledger attribution; only standalone profiler overhead (trace
# start/stop outside a step span) surfaces as its own bucket.
PHASE_STEP_PROFILE = "step_profile"
# the inference plane (rl/scheduler.py + the multi-replica serving
# workers): one ``serve_step`` span per scheduler iteration, with
# ``prefill`` (prompt-chunk) and ``decode`` (token-step) legs inside
# it.  Serving processes run no train steps, so these never contend
# with ``step`` for attribution; they rank just below step_profile so
# a trainer-co-located rollout keeps its training attribution.
PHASE_SERVE_STEP = "serve_step"
PHASE_PREFILL = "prefill"
PHASE_DECODE = "decode"
# incremental-allocation serving (ISSUE 15): one ``preempt`` span per
# pool-pressure eviction (the victim's blocks return to the pool and
# the request requeues with its generated tail), one ``verify`` span
# per fused multi-token decode window (K drafted tokens scored by one
# batched verify forward).  Same attribution rank as the serving
# spans above.
PHASE_PREEMPT = "preempt"
PHASE_VERIFY = "verify"
# per-request lifecycle tracing (ISSUE 16): every served request gets
# a ``serve_request`` parent span covering submit→completion, with
# ``queue_wait`` (dispatcher submit → scheduler admission, measured
# from the wall-clock anchor that rides the shm request ring),
# ``admit`` (the admission bookkeeping itself) and — after a
# pool-pressure eviction — ``resume`` (re-admission of the preempted
# tail) children.  The children rank above the parent so a request's
# time attributes to the specific lifecycle stage, not the envelope.
PHASE_QUEUE_WAIT = "queue_wait"
PHASE_ADMIT = "admit"
PHASE_RESUME = "resume"
PHASE_SERVE_REQUEST = "serve_request"
# disaggregated prefill/decode (ISSUE 17): one ``kv_ship`` span per
# prefill-worker handoff — the staged block regions' copy into the
# ship arena, sized and timed like the checkpoint data-plane spans
# (the shm transfer IS the disaggregation tax; a throughput
# regression here shows up as decode-side TTFT, so it must be
# attributable from the timeline alone).
PHASE_KV_SHIP = "kv_ship"
# client-side control-plane wait (a long-poll RPC parked on the
# master, or the legacy polling loop it replaces).  LOWEST priority:
# these waits are almost always nested inside rendezvous/restart
# spans, which keep the attribution; a standalone control_wait still
# surfaces as its own loss bucket instead of vanishing into
# unattributed time.
PHASE_CONTROL_WAIT = "control_wait"

# one paged-kernel autotune sweep (ops/autotune.py): the tuner timed
# every legal (q-block, kv-block) candidate for one shape key and
# persisted the winner — the span is the audit record of WHY the
# cached config is what it is
PHASE_KERNEL_AUTOTUNE = "kernel_autotune"

# the flywheel's train->serve weight hop (rl/flywheel.py): one
# in-place publish of the policy (+ drafter) into the double-buffered
# shm snapshot segment — the span's duration IS the trainer stall the
# zero-copy path is supposed to bound
PHASE_WEIGHT_PUBLISH = "weight_publish"

# one rollout round of the RLHF flywheel: prompts submitted, every
# trajectory streamed back, the round's staleness verdicts settled
PHASE_ROLLOUT_ROUND = "rollout_round"

# one completed rollout crossing the serve->train boundary as a ready
# training sample (the shm trajectory stream's unit of account)
PHASE_TRAJECTORY = "trajectory"

PHASES: Tuple[str, ...] = (
    PHASE_DATA_STALL,
    PHASE_STEP,
    PHASE_PREEMPTION_DRAIN,
    PHASE_CHECKPOINT_RESTORE,
    PHASE_RESTORE_PREFETCH,
    PHASE_RESHARD,
    PHASE_FINISH_RESTORE,
    PHASE_COMPILE,
    PHASE_AOT_COMPILE,
    PHASE_RENDEZVOUS,
    PHASE_RENDEZVOUS_WAIT,
    PHASE_NODE_CHECK,
    PHASE_CHECKPOINT_SAVE,
    PHASE_OFFLOAD_COPY,
    PHASE_RESTART_PATH,
    PHASE_RESTART,
    PHASE_STEP_PROFILE,
    PHASE_SERVE_STEP,
    PHASE_PREFILL,
    PHASE_DECODE,
    PHASE_PREEMPT,
    PHASE_VERIFY,
    PHASE_QUEUE_WAIT,
    PHASE_ADMIT,
    PHASE_RESUME,
    PHASE_SERVE_REQUEST,
    PHASE_KV_SHIP,
    PHASE_CONTROL_WAIT,
    PHASE_KERNEL_AUTOTUNE,
    PHASE_WEIGHT_PUBLISH,
    PHASE_ROLLOUT_ROUND,
    PHASE_TRAJECTORY,
)

#: Phases that count as useful training time in the ledger.
USEFUL_PHASES = frozenset({PHASE_STEP})

#: Wall clock covered by no span at all (monitor-detection gaps,
#: wedged-in-collective survivors, scheduler noise).  Kept as its own
#: ledger bucket so the losses still sum exactly to ``wall − useful``.
UNATTRIBUTED = "unattributed"

#: Point events (``ph: "i"``) — markers, not ledger input.
#: ``fault_injected`` marks a chaos-harness fault (a plan-driven
#: SIGKILL or an RPC drop/delay/dup at the channel boundary) so an
#: injected fault and the recovery it provokes share one trace;
#: ``master_restart`` marks a master incarnation replaying its
#: journal+snapshot back to serving state.
#: ``diagnosis`` marks one fresh inference-chain conclusion (the
#: observatory's DiagnosisManager): the problem, the recovery action
#: and the node it names — the trace shows the verdict next to the
#: evidence that produced it.
#: ``scale_decision`` / ``scale_execute`` bracket one Brain planned
#: action (``master/auto_scaler.BrainAutoScaler``): the decision as it
#: was made (rule, direction, world transition) and its execution
#: outcome (done / fallback-fenced / abandoned) — a chaos trace shows
#: the autonomy loop's verdicts next to the drains and re-meshes they
#: caused, and a failover-resumed action keeps the SAME decision id.
INSTANT_EVENTS = frozenset(
    {
        "preemption_signal",
        "job_start",
        "job_end",
        "worker_kill",
        "fault_injected",
        "master_restart",
        "diagnosis",
        "scale_decision",
        "scale_execute",
        "capture",
        # the master's own overload deriver fired: sustained p99 /
        # queue-near-bound / journal-lag / pool-saturation streak
        # (observability/health.py MasterHealth)
        "master_overload",
        # the serving observatory fired (observability/health.py
        # ServingHealthEngine): a replica's derived verdict changed
        # (serving_health) or a per-replica SLO signal breached its
        # threshold for ``sustain`` consecutive derivations
        # (slo_breach)
        "serving_health",
        "slo_breach",
    }
)

#: Labels an ``instant()`` emit site must pass explicitly; enforced by
#: ``scripts/check_event_schema.py`` like ``REQUIRED_SPAN_LABELS``.
#: ``fault_injected`` without kind+target would be an unattributable
#: blip in a chaos trace — exactly the record that must be precise.
REQUIRED_INSTANT_LABELS: Dict[str, Tuple[str, ...]] = {
    "fault_injected": ("kind", "target"),
    "master_restart": ("incarnation",),
    # an anonymous conclusion is useless to the operator reading the
    # trace AND to scripts/top.py's conclusions pane
    "diagnosis": ("problem", "action", "node_rank"),
    # a scale record without the rule that fired and the world
    # transition it planned is unauditable — "drain_replace node 2,
    # straggler 3.9x, 3→2" is the whole story of a Brain action
    # ``plane`` names WHICH side of the train/serve boundary the
    # action moved capacity on ("train" for the classic Brain loop,
    # "serve" for flywheel device lending) — without it a lend and a
    # straggler drain-replace read as the same world transition
    "scale_decision": ("action", "reason", "from_world", "to_world",
                       "plane"),
    "scale_execute": ("action", "reason", "from_world", "to_world",
                      "plane"),
    # one deep capture fired at a node (the agent's xpu_timer
    # hang-dump analog): the trace must show WHICH node was captured
    # and WHY (hang / straggler / operator request), next to the
    # diagnosis conclusion that triggered it
    "capture": ("node_rank", "reason"),
    # an overload verdict without WHICH signal breached and by how
    # much is unactionable — "journal_lag 8200 rows vs 5000" tells
    # the operator to grow the flusher, "pool_saturated 0.97 vs 0.9"
    # to raise DLROVER_TPU_MASTER_WORKERS
    "master_overload": ("reason", "value", "threshold"),
    # a serving verdict without the replica it names and the reason it
    # fired is exactly the "a node is slow" blip the observatory
    # exists to replace with "this is why"
    "serving_health": ("replica", "verdict", "reason"),
    "slo_breach": ("replica", "reason", "value", "threshold"),
}

#: Labels an emit SITE must pass explicitly (beyond the automatic
#: job/node/rank/inc/pid identity labels); enforced by
#: ``scripts/check_event_schema.py``.
REQUIRED_SPAN_LABELS: Dict[str, Tuple[str, ...]] = {
    PHASE_STEP: ("step",),
    # input-pipeline stalls carry the stage that stalled
    # (host_fetch — producing the host batch — vs h2d — staging it
    # onto devices) so a slow storage read and a saturated transfer
    # link stay distinguishable in the ledger
    PHASE_DATA_STALL: ("stage",),
    # checkpoint data-plane spans carry their size and measured
    # bandwidth so throughput regressions surface in the ledger and
    # in bench_goodput's loss breakdown, not only in wall time
    PHASE_CHECKPOINT_SAVE: ("step", "bytes", "throughput_gbps"),
    PHASE_CHECKPOINT_RESTORE: ("step", "bytes", "throughput_gbps"),
    # host-offload chunk-stream spans carry the streamed bytes, the
    # measured wire throughput and whether the rolling double-buffered
    # window was active (vs the serial kill-switched stream) so DMA
    # pipeline regressions are attributable from the timeline alone
    PHASE_OFFLOAD_COPY: ("bytes", "throughput_gbps", "buffered"),
    # a reshard span without the world transition and the moved bytes
    # is uninterpretable: "8→4, 3.1 GB at 1.2 GB/s" is the whole story
    # of an elastic restore, and MTTR regressions key on it
    PHASE_RESHARD: ("from_world", "to_world", "bytes",
                    "throughput_gbps"),
    PHASE_RESTART: ("reason",),
    PHASE_PREEMPTION_DRAIN: ("event",),
    # the live attribution payload: a step_profile span without the
    # category shares + achieved TFLOP/s + MFU is just a blip — the
    # labels ARE the signal the HealthEngine's per-node gauges and the
    # "why" column in top.py are built from
    PHASE_STEP_PROFILE: (
        "step",
        "share_compute",
        "share_collective",
        "share_copy",
        "share_infeed",
        "share_idle",
        "tflops",
        "mfu",
    ),
    # which control-plane wait parked (kv | comm_world | task |
    # status) so rendezvous-bootstrap waits and shard starvation stay
    # distinguishable in the ledger
    PHASE_CONTROL_WAIT: ("kind",),
    # the serving loop's per-iteration record: prompt tokens
    # prefilled + tokens sampled + the iteration's token throughput —
    # without them a serve_step is an unactionable blip, with them
    # the trace alone answers "why did tokens/s dip" (prefill-heavy
    # interval vs starved slots)
    PHASE_SERVE_STEP: ("tokens", "new_tokens", "throughput_tps"),
    # a prefill leg without its chunk size can't distinguish a long
    # prompt's chunks from a trivial one (sites may additionally
    # carry ``prefix_hit_blocks`` — prompt blocks served from the
    # shared-block index instead of prefilled)
    PHASE_PREFILL: ("tokens",),
    # a decode leg's sampled-token count IS its progress record
    PHASE_DECODE: ("new_tokens",),
    # a preemption without its cost (blocks returned to the pool) and
    # its waste (tokens the victim must re-prefill) is just a blip —
    # the two numbers ARE the incremental-admission tradeoff
    PHASE_PREEMPT: ("blocks_freed", "tokens_generated"),
    # the speculative window's scoreboard: drafted vs accepted is the
    # whole story of a multi-token decode step (accept rate == the
    # dispatch amortization actually achieved)
    PHASE_VERIFY: ("drafted", "accepted"),
    # the request's whole life in one record: identity, where it ran,
    # its size, and the SLO numbers (TTFT, per-token-gap p99) plus the
    # efficiency story (preemptions suffered, prompt blocks served
    # from the prefix cache) — the serve_request span alone must
    # answer "was THIS request slow, and why".  The fleet layer
    # (ISSUE 17) adds the routing story: HOW the dispatcher picked
    # the replica (least_outstanding / affinity / ship — "local" for
    # in-process schedulers) and WHICH SLO lane the request rode —
    # without them an affinity miss and a lane-starved batch request
    # are indistinguishable blips
    PHASE_SERVE_REQUEST: (
        "req_id",
        "replica",
        "prompt_tokens",
        "gen_tokens",
        "ttft_s",
        "tbt_p99_s",
        "preempts",
        "prefix_hit_blocks",
        "route",
        "slo_class",
    ),
    # the disaggregation handoff, sized and timed like the
    # checkpoint/offload data-plane spans: staged blocks, moved
    # bytes, achieved shm throughput
    PHASE_KV_SHIP: ("blocks", "bytes", "throughput_gbps"),
    PHASE_QUEUE_WAIT: ("req_id",),
    PHASE_ADMIT: ("req_id",),
    # a resume without the restored tail size can't distinguish a
    # cheap re-admission from re-prefilling hundreds of tokens
    PHASE_RESUME: ("req_id", "resume_tokens"),
    # an autotune event without the shape's winner and the sweep size
    # is unauditable: which kernel, what config won, out of how many
    # legal candidates, at what best time — the four numbers let a
    # later regression be traced to "the cache picked THIS because"
    PHASE_KERNEL_AUTOTUNE: (
        "kernel",
        "best_config",
        "candidates",
        "best_us",
    ),
    # a publish without its generation, its moved bytes and the stall
    # it charged the trainer is unauditable — stall_s vs the step time
    # IS the flywheel's acceptance criterion
    PHASE_WEIGHT_PUBLISH: ("generation", "bytes", "stall_s"),
    # the round's scoreboard: how many trajectories came back and how
    # many the staleness policy refused — together they are the
    # on-policy/off-policy budget actually spent
    PHASE_ROLLOUT_ROUND: ("round", "trajectories",
                          "staleness_dropped"),
    # identity + provenance of one streamed sample: which request,
    # which policy generation sampled it, how many tokens it carries
    PHASE_TRAJECTORY: ("req_id", "generation", "tokens"),
}


class EventLogger:
    """Append structured events to a JSONL timeline file.

    Disabled (every call a cheap no-op) when no path is configured —
    library code can instrument unconditionally.  One ``os.write`` per
    line on an ``O_APPEND`` descriptor keeps concurrent writers from
    ever interleaving bytes (POSIX atomic append).
    """

    def __init__(
        self,
        path: str = "",
        job: str = "",
        node: Optional[int] = None,
        rank: Optional[int] = None,
        incarnation: Optional[int] = None,
    ):
        self._path = path or os.getenv(EVENTS_FILE_ENV, "")
        self._job = job or os.getenv("DLROVER_TPU_JOB_NAME", "default")
        self._node = (
            node
            if node is not None
            else int(os.getenv("DLROVER_TPU_NODE_RANK", "0") or 0)
        )
        # -1 = not a training process (agent / launcher / master)
        self._rank = (
            rank
            if rank is not None
            else int(os.getenv("DLROVER_TPU_PROCESS_RANK", "-1") or -1)
        )
        self._inc = (
            incarnation
            if incarnation is not None
            else int(os.getenv("DLROVER_TPU_RESTART_COUNT", "0") or 0)
        )
        self._fd: Optional[int] = None
        self._lock = threading.Lock()
        self._sid = 0
        # per-(thread, phase) open-span stack for begin/end pairing
        self._open: Dict[Tuple[int, str], List[dict]] = {}
        #: emits since the last rotation check (the size stat is not
        #: paid per line)
        self._emits_since_check = 0

    #: how many emitted lines between size checks for rotation
    ROTATE_CHECK_EVERY = 128

    def _maybe_rotate_locked(self):
        """Size-based rotation of the JSONL file (caller holds the
        lock, fd is open).  One ``.1`` backup is kept; the agent's
        ``TimelineReporter`` treats the recreated (smaller) file as a
        truncation and restarts its tail offset at 0.  Multi-writer
        safe: a writer whose fd no longer matches the path (someone
        else already rotated) just follows to the new file instead of
        rotating the fresh file away."""
        from dlrover_tpu_torch.common.env import (
            events_max_bytes,
            observatory_enabled,
        )

        if not observatory_enabled():
            return  # kill-switch: unbounded growth, exactly as before
        max_bytes = events_max_bytes()
        if max_bytes <= 0:
            return
        try:
            st_fd = os.fstat(self._fd)
            try:
                st_path = os.stat(self._path)
            except FileNotFoundError:
                st_path = None
            if st_path is None or st_path.st_ino != st_fd.st_ino:
                # rotated (or unlinked) under us: reopen on next emit
                os.close(self._fd)
                self._fd = None
                return
            if st_path.st_size < max_bytes:
                return
            os.close(self._fd)
            self._fd = None
            os.replace(self._path, self._path + ".1")
            logger.info(
                "rotated events file %s (%d bytes > %d)",
                self._path, st_path.st_size, max_bytes,
            )
        except OSError as e:
            logger.warning("events rotation failed: %s", e)

    @property
    def enabled(self) -> bool:
        return bool(self._path)

    @property
    def path(self) -> str:
        return self._path

    # ------------------------------------------------------------- emit
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
            rec["labels"] = {k: v for k, v in labels.items()}
        return rec

    def emit(self, record: dict):
        """Write one record as one atomic appended JSONL line."""
        if not self._path:
            return
        try:
            line = (
                json.dumps(record, separators=(",", ":"), default=str)
                + "\n"
            )
        except (TypeError, ValueError):
            return
        with self._lock:
            try:
                if self._fd is None:
                    parent = os.path.dirname(
                        os.path.abspath(self._path)
                    )
                    os.makedirs(parent, exist_ok=True)
                    self._fd = os.open(
                        self._path,
                        os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                        0o644,
                    )
                os.write(self._fd, line.encode())
                self._emits_since_check += 1
                if (
                    self._emits_since_check
                    >= self.ROTATE_CHECK_EVERY
                ):
                    self._emits_since_check = 0
                    self._maybe_rotate_locked()
            except OSError as e:
                logger.warning("event emit failed: %s", e)

    def begin(self, phase: str, **labels) -> int:
        """Open a span; returns the span id ``end`` pairs on."""
        if not self._path:
            return -1
        with self._lock:
            self._sid += 1
            sid = self._sid
        rec = self._record(phase, "B", **labels)
        rec["sid"] = sid
        key = (threading.get_ident(), phase)
        self._open.setdefault(key, []).append(rec)
        self.emit(rec)
        return sid

    def end(self, phase: str, sid: int = -1, **labels):
        if not self._path:
            return
        rec = self._record(phase, "E", **labels)
        key = (threading.get_ident(), phase)
        stack = self._open.get(key)
        if sid < 0 and stack:
            sid = stack[-1].get("sid", -1)
        if stack:
            stack.pop()
        rec["sid"] = sid
        self.emit(rec)

    def complete(
        self, phase: str, start_wall: float, duration_s: float, **labels
    ):
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

    @contextmanager
    def span(self, phase: str, **labels):
        """``with events.span("rendezvous"): ...`` — ends on exit,
        even on exception (the failed attempt's time is still loss)."""
        sid = self.begin(phase, **labels)
        try:
            yield sid
        finally:
            self.end(phase, sid=sid)

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
    (``DLROVER_TPU_EVENTS_FILE`` etc.); disabled no-op when unset."""
    global _default_logger
    with _default_logger_lock:
        if _default_logger is None:
            _default_logger = EventLogger()
        return _default_logger


def set_default_event_logger(event_logger: Optional[EventLogger]):
    """Install (or with ``None`` reset) the process default — tests
    and harnesses that flip the env mid-process need this."""
    global _default_logger
    with _default_logger_lock:
        _default_logger = event_logger


# --------------------------------------------------------------------------
# timeline reading / merging
# --------------------------------------------------------------------------


def read_events(path: str) -> List[dict]:
    """Parse a JSONL timeline file; skips torn/partial lines (a
    SIGKILLed writer's final line may be incomplete)."""
    if not os.path.exists(path):
        return []
    out = []
    with io.open(path, "r", errors="replace") as f:
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


def pair_spans(events: List[dict]) -> List[dict]:
    """Turn raw events into closed intervals on the WALL clock.

    ``X`` records map directly; ``B``/``E`` pairs match by
    ``(pid, sid)`` (falling back to a per-``(pid, name)`` LIFO stack
    for sid-less writers), and the duration comes from the MONOTONIC
    clock — a wall-clock step (NTP) cannot corrupt a span length, only
    shift its anchor.  A ``B`` whose writer died before ``E`` closes at
    the writer's last observed monotonic instant, so a killed worker's
    half-open span still lands in the ledger instead of vanishing.
    """
    intervals: List[dict] = []
    # writers are identified by (node, pid), never bare pid: in a
    # master-side MERGED stream, containers on different hosts reuse
    # the same pids (and per-process sid counters all start at 1) — a
    # bare-pid key would close node0's B with node1's E and subtract
    # monotonic clocks from different hosts
    open_by_sid: Dict[Tuple, dict] = {}
    open_stacks: Dict[Tuple, List[dict]] = {}
    last_mono: Dict[Tuple, float] = {}
    for e in sorted(events, key=lambda e: e.get("mono", 0.0)):
        ph = e.get("ph")
        pid = (e.get("node", 0), e.get("pid", 0))
        mono = float(e.get("mono", 0.0))
        last_mono[pid] = max(last_mono.get(pid, mono), mono)
        if ph == "X":
            start = float(e.get("wall", 0.0))
            dur = max(float(e.get("dur", 0.0)), 0.0)
            intervals.append(
                {
                    "phase": e.get("name", ""),
                    "start": start,
                    "end": start + dur,
                    **_identity(e),
                }
            )
        elif ph == "B":
            sid = e.get("sid", -1)
            if sid >= 0:
                open_by_sid[(pid, sid)] = e
            open_stacks.setdefault(
                (pid, e.get("name", "")), []
            ).append(e)
        elif ph == "E":
            b = open_by_sid.pop((pid, e.get("sid", -1)), None)
            stack = open_stacks.get((pid, e.get("name", "")))
            if b is None and stack:
                b = stack.pop()
            elif b is not None and stack and b in stack:
                stack.remove(b)
            if b is None:
                continue  # E without B: writer restarted mid-span
            dur = max(mono - float(b.get("mono", mono)), 0.0)
            start = float(b.get("wall", 0.0))
            labels = dict(b.get("labels") or {})
            labels.update(e.get("labels") or {})
            iv = {
                "phase": b.get("name", ""),
                "start": start,
                "end": start + dur,
                **_identity(b),
            }
            if labels:
                iv["labels"] = labels
            intervals.append(iv)
    # close writer-died spans at the writer's last seen instant
    leftovers = list(open_by_sid.values())
    seen = {id(b) for b in leftovers}
    for stack in open_stacks.values():
        leftovers.extend(b for b in stack if id(b) not in seen)
    for b in leftovers:
        pid = (b.get("node", 0), b.get("pid", 0))
        dur = max(
            last_mono.get(pid, 0.0) - float(b.get("mono", 0.0)), 0.0
        )
        start = float(b.get("wall", 0.0))
        intervals.append(
            {
                "phase": b.get("name", ""),
                "start": start,
                "end": start + dur,
                "truncated": True,
                **_identity(b),
            }
        )
    intervals.sort(key=lambda iv: (iv["start"], iv["end"]))
    return intervals


def _identity(e: dict) -> dict:
    out = {
        "job": e.get("job", ""),
        "node": e.get("node", 0),
        "rank": e.get("rank", -1),
        "inc": e.get("inc", 0),
        "pid": e.get("pid", 0),
    }
    if e.get("labels"):
        out["labels"] = e["labels"]
    return out


def compute_ledger(
    events: List[dict],
    window: Optional[Tuple[float, float]] = None,
) -> dict:
    """Partition wall clock into phases — the goodput ledger.

    Sweep-line over all span intervals: every elementary segment of
    the window is charged to the highest-priority covering phase
    (``PHASES`` order), or to ``unattributed`` when nothing covers it.
    Because the partition is exact,

        ``sum(loss_breakdown.values()) == wall_s − useful_s``

    holds to float precision — losses can never silently leak.
    """
    intervals = pair_spans(events)
    if window is None:
        if not intervals:
            return {
                "wall_s": 0.0,
                "useful_s": 0.0,
                "goodput": 0.0,
                "loss_breakdown": {},
                "spans": 0,
                "incarnations": [],
            }
        window = (
            min(iv["start"] for iv in intervals),
            max(iv["end"] for iv in intervals),
        )
    w0, w1 = float(window[0]), float(window[1])
    # priority index: declared phases first, then undeclared span names
    # (still attributable, ranked after every declared phase), then
    # the unattributed bucket
    order: List[str] = list(PHASES)
    for iv in intervals:
        if iv["phase"] not in order:
            order.append(iv["phase"])
    order.append(UNATTRIBUTED)
    idx = {p: i for i, p in enumerate(order)}
    unattr_idx = idx[UNATTRIBUTED]

    # boundary sweep with per-phase active counters
    bounds: List[Tuple[float, int, int]] = []  # (t, 0=end/1=start, phase)
    for iv in intervals:
        lo = max(iv["start"], w0)
        hi = min(iv["end"], w1)
        if hi <= lo:
            continue
        p = idx[iv["phase"]]
        bounds.append((lo, 1, p))
        bounds.append((hi, 0, p))
    bounds.sort(key=lambda b: (b[0], b[1]))
    active = [0] * len(order)
    acc = [0.0] * len(order)
    prev_t = w0
    covered = 0
    for t, kind, p in bounds:
        if t > prev_t:
            seg = t - prev_t
            if covered:
                winner = next(
                    i for i, n in enumerate(active) if n > 0
                )
            else:
                winner = unattr_idx
            acc[winner] += seg
            prev_t = t
        if kind == 1:
            active[p] += 1
            covered += 1
        else:
            active[p] -= 1
            covered -= 1
    if w1 > prev_t:
        acc[unattr_idx] += w1 - prev_t

    useful = sum(
        acc[idx[p]] for p in USEFUL_PHASES if p in idx
    )
    wall = max(w1 - w0, 0.0)
    loss = {
        order[i]: round(acc[i], 6)
        for i in range(len(order))
        if order[i] not in USEFUL_PHASES and acc[i] > 0.0
    }
    # the bucket is always present: "no unattributed time" is a
    # statement, not an omission
    loss.setdefault(UNATTRIBUTED, 0.0)
    return {
        "wall_s": round(wall, 6),
        "useful_s": round(useful, 6),
        "goodput": round(useful / wall, 6) if wall > 0 else 0.0,
        "loss_breakdown": loss,
        "spans": len(intervals),
        "incarnations": sorted(
            {iv.get("inc", 0) for iv in intervals}
        ),
    }


def export_chrome_trace(events: List[dict], path: str) -> dict:
    """Write the timeline as a chrome-trace JSON Perfetto loads
    directly: one process track per node, one thread per rank (the
    agent's rank ``-1`` renders as its own "agent" track).  Returns
    the trace dict."""
    intervals = pair_spans(events)
    t0 = min(
        (iv["start"] for iv in intervals), default=0.0
    )
    trace_events: List[dict] = []
    seen_tracks = set()
    for iv in intervals:
        pid = int(iv.get("node", 0))
        rank = int(iv.get("rank", -1))
        tid = rank + 1  # agent (-1) -> tid 0, rank r -> r+1
        if (pid, None) not in seen_tracks:
            seen_tracks.add((pid, None))
            trace_events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": f"node{pid}"},
                }
            )
        if (pid, tid) not in seen_tracks:
            seen_tracks.add((pid, tid))
            tname = "agent" if rank < 0 else f"rank{rank}"
            trace_events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        args = dict(iv.get("labels") or {})
        args["inc"] = iv.get("inc", 0)
        trace_events.append(
            {
                "name": iv["phase"],
                "ph": "X",
                "ts": round((iv["start"] - t0) * 1e6, 1),
                "dur": round((iv["end"] - iv["start"]) * 1e6, 1),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    for e in events:
        if e.get("ph") != "i":
            continue
        trace_events.append(
            {
                "name": e.get("name", ""),
                "ph": "i",
                "s": "g",
                "ts": round((float(e.get("wall", t0)) - t0) * 1e6, 1),
                "pid": int(e.get("node", 0)),
                "tid": int(e.get("rank", -1)) + 1,
                "args": dict(e.get("labels") or {}),
            }
        )
    trace = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return trace


# --------------------------------------------------------------------------
# master-side aggregation
# --------------------------------------------------------------------------


class TimelineAggregator:
    """Master-side sink merging per-node event streams.

    Batches arrive through the report RPC (``TimelineEventsReport``;
    the agent's ``TimelineReporter`` tails the node-local JSONL and
    ships deltas).  The merged stream is durable when a Brain
    datastore is wired (``timeline_events`` table) and the live ledger
    is served three ways: the ``TimelineQueryRequest`` get-RPC,
    :class:`MetricsRegistry` gauges (native Prometheus exporter), and
    the chrome-trace export.
    """

    MAX_EVENTS = 200_000  # in-memory ring bound (control-plane rates)
    #: gauge refresh cadence: the ledger sweep is O(ring log ring),
    #: so it must not run on every node's report RPC
    GAUGE_REFRESH_S = 5.0
    #: Brain timeline_events retention sweep cadence (age/row-cap;
    #: the sweep itself lives in the datastore)
    RETENTION_SWEEP_S = 300.0

    def __init__(
        self, job: str = "", registry=None, datastore=None,
        health=None,
    ):
        """``health``: an ``observability.health.HealthEngine`` — the
        observatory's streaming tap; every accepted batch is forwarded
        so per-node derivations update at report rate (None = no
        observatory, today's behavior)."""
        self._job = job or os.getenv(
            "DLROVER_TPU_JOB_NAME", "default"
        )
        self._registry = registry
        self._datastore = datastore
        self._health = health
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._last_gauge_refresh = 0.0
        self._last_retention_sweep = time.monotonic()

    @property
    def job(self) -> str:
        return self._job

    def add_events(self, node_id: int, events: List[dict]) -> int:
        """Merge one node's batch; returns the count accepted."""
        accepted = []
        for e in events:
            if not isinstance(e, dict) or "name" not in e:
                continue
            e.setdefault("node", node_id)
            e.setdefault("job", self._job)
            accepted.append(e)
        with self._lock:
            self._events.extend(accepted)
            if len(self._events) > self.MAX_EVENTS:
                self._events = self._events[-self.MAX_EVENTS:]
        if self._datastore is not None and accepted:
            try:
                self._datastore.record_timeline_events(
                    self._job, accepted
                )
            except Exception as e:  # noqa: BLE001 - durability is best-effort
                logger.warning("timeline persist failed: %s", e)
            self._maybe_sweep_retention()
        if self._health is not None and accepted:
            try:
                self._health.observe_events(node_id, accepted)
            except Exception as e:  # noqa: BLE001 - derivations are best-effort
                logger.warning("health derivation failed: %s", e)
        if accepted:
            now = time.monotonic()
            if (
                now - self._last_gauge_refresh
                >= self.GAUGE_REFRESH_S
            ):
                self._last_gauge_refresh = now
                self._refresh_gauges()
        return len(accepted)

    def _maybe_sweep_retention(self):
        """Throttled Brain ``timeline_events`` retention sweep — the
        durable timeline must not grow without bound on a week-long
        job (behind the observatory kill-switch like the rest of the
        growth bounds)."""
        from dlrover_tpu_torch.common.env import observatory_enabled

        if not observatory_enabled():
            return
        now = time.monotonic()
        if now - self._last_retention_sweep < self.RETENTION_SWEEP_S:
            return
        self._last_retention_sweep = now
        try:
            self._datastore.sweep_timeline(self._job)
        except Exception as e:  # noqa: BLE001 - hygiene is best-effort
            logger.warning("timeline retention sweep failed: %s", e)

    def events(self, limit: int = 0) -> List[dict]:
        with self._lock:
            if limit and limit > 0:
                return list(self._events[-limit:])
            return list(self._events)

    def size(self) -> int:
        """Ring occupancy without copying it (the self-telemetry
        state-rows sweep runs per scrape — ``len(events())`` would
        copy up to MAX_EVENTS dicts each time)."""
        with self._lock:
            return len(self._events)

    def ledger(self) -> dict:
        """Current goodput ledger over everything merged so far."""
        return compute_ledger(self.events())

    def export_chrome_trace(self, path: str) -> dict:
        return export_chrome_trace(self.events(), path)

    def _refresh_gauges(self):
        if self._registry is None:
            return
        try:
            ledger = self.ledger()
            self._registry.set_gauge(
                "dlrover_tpu_goodput", ledger["goodput"]
            )
            self._registry.set_gauge(
                "dlrover_tpu_timeline_useful_seconds",
                ledger["useful_s"],
            )
            self._registry.set_gauge(
                "dlrover_tpu_timeline_wall_seconds", ledger["wall_s"]
            )
            for phase, sec in ledger["loss_breakdown"].items():
                self._registry.set_gauge(
                    "dlrover_tpu_goodput_loss_seconds",
                    sec,
                    labels={"phase": phase},
                )
        except Exception as e:  # noqa: BLE001 - metrics must never break reports
            logger.warning("ledger gauge refresh failed: %s", e)
