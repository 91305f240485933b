"""Master failover: durable control-plane journaling and replay.

Copy of ``dlrover_tpu/master/failover.py``: the same journal ops, so
either package's master replays a db the other wrote.  The Brain
(``master/auto_scaler.BrainAutoScaler``) journals under ``brain``; the
deep-capture component stays None in the port (ROADMAP A7), and
``attach`` skips a None component.

A master crash must not be a job crash (ROADMAP item 1; DLRover's
ElasticJob controller recreates a failed master pod and agents simply
reattach, PAPER.md §1).  Everything the agents depend on — rendezvous
rounds, KV contents, in-flight shard leases, the node table — lives in
master memory; this module makes it durable:

- every state-changing mutation of ``KVStoreService``,
  ``RendezvousManager``, ``TaskManager`` and ``JobManager`` journals
  through :class:`ControlPlaneJournal` into the sqlite Brain
  (``control_journal`` table, write-behind — the mutating RPC never
  blocks on an fsync);
- a periodic COMPACTED snapshot (``control_snapshots``) folds the
  journal: recovery cost is bounded by one snapshot + one linger
  window of entries, not job lifetime;
- on startup :meth:`ControlPlaneJournal.recover` replays
  snapshot-then-journal into the live components BEFORE the gRPC
  server opens, so the first reconnecting agent already sees the same
  rendezvous round, the same KV keys and its shard leases re-queued
  (unacked leases go back to todo exactly like the timeout path).

Journal records are IDEMPOTENT by construction (full-state records
for rendezvous/tasks/nodes, result-valued sets for KV), so the
snapshot seq only needs to be a low-water mark: replaying an entry
the snapshot already contains is a no-op.

The whole subsystem is kill-switched by ``DLROVER_TPU_MASTER_FAILOVER=0``
and inert when no Brain db is configured.
"""

import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.env import control_snapshot_interval_s
from dlrover_tpu_torch.common.log import default_logger as logger

#: component keys as they appear in the journal/snapshot
KV = "kv"
RDZV_PREFIX = "rdzv/"
TASKS = "tasks"
NODES = "nodes"
#: the Brain auto-scaler's hysteresis/cooldown/in-flight state — a
#: failed-over master must not forget a just-issued shrink and
#: immediately re-grow (flip-flop), and an in-flight planned action
#: must resume or be safely abandoned, never silently dropped
BRAIN = "brain"
#: the deep-capture coordinator's cooldown anchors + in-flight
#: directives — a failed-over master re-arms a pending capture under
#: the SAME id instead of losing it (or double-firing a new one)
CAPTURE = "capture"


class ControlPlaneJournal:
    """Wires the master components to the datastore journal and owns
    the snapshot/recover lifecycle for one job."""

    def __init__(
        self,
        store,
        job: str,
        kv_store=None,
        rdzv_managers: Optional[Dict[str, object]] = None,
        task_manager=None,
        job_manager=None,
        brain=None,
        capture=None,
        snapshot_interval_s: Optional[float] = None,
    ):
        self._store = store
        self._job = job
        self._kv = kv_store
        self._rdzv = dict(rdzv_managers or {})
        self._tasks = task_manager
        self._nodes = job_manager
        self._brain = brain
        self._capture = capture
        self._interval = (
            control_snapshot_interval_s()
            if snapshot_interval_s is None
            else snapshot_interval_s
        )
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: journaling errors must never break the serving path; after
        #: the first failure the journal goes quiet (logged once)
        self._broken = False
        #: self-telemetry: when the last compacted snapshot landed
        #: (mono) and how long it took — a stale snapshot means the
        #: next failover replays a long journal tail
        self._last_snapshot_mono = 0.0
        self._last_snapshot_s = 0.0
        self._last_snapshot_seq = 0

    # ------------------------------------------------------ recording
    def record(self, component: str, op: str, args: dict):
        if self._broken:
            return
        try:
            self._store.journal_append(self._job, component, op, args)
        except Exception as e:  # noqa: BLE001
            self._broken = True
            logger.error(
                "control-plane journal broken (durability lost, "
                "serving continues): %s", e,
            )

    def _cb(self, component: str):
        return lambda op, args: self.record(component, op, args)

    def attach(self):
        """Hook every component's journal callback."""
        if self._kv is not None:
            self._kv.set_journal(self._cb(KV))
        for name, manager in self._rdzv.items():
            manager.set_journal(self._cb(RDZV_PREFIX + name))
        if self._tasks is not None:
            self._tasks.set_journal(self._cb(TASKS))
        if self._nodes is not None:
            self._nodes.set_journal(self._cb(NODES))
        if self._brain is not None:
            self._brain.set_journal(self._cb(BRAIN))
        if self._capture is not None:
            self._capture.set_journal(self._cb(CAPTURE))

    def detach(self):
        if self._kv is not None:
            self._kv.set_journal(None)
        for manager in self._rdzv.values():
            manager.set_journal(None)
        if self._tasks is not None:
            self._tasks.set_journal(None)
        if self._nodes is not None:
            self._nodes.set_journal(None)
        if self._brain is not None:
            self._brain.set_journal(None)
        if self._capture is not None:
            self._capture.set_journal(None)

    # ------------------------------------------------------- recovery
    def recover(self) -> dict:
        """Replay snapshot + journal into the live components; call
        BEFORE ``attach`` (replay must not re-journal itself) and
        before the gRPC server opens.  Returns replay stats."""
        t0 = time.monotonic()
        snapshot, snap_seq = self._store.load_control_snapshot(
            self._job
        )
        if snapshot:
            self._restore_component_states(snapshot)
        entries = self._store.journal_entries(
            self._job, since_seq=snap_seq
        )
        for _seq, component, op, args in entries:
            try:
                self._route(component, op, args)
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "journal replay: %s/%s failed (%s); skipped",
                    component, op, e,
                )
        stats = {
            "snapshot_seq": snap_seq,
            "replayed": len(entries),
            "recover_s": round(time.monotonic() - t0, 4),
        }
        if snapshot or entries:
            logger.info(
                "control plane recovered: snapshot@%s + %s journal "
                "records in %.3fs",
                snap_seq, len(entries), stats["recover_s"],
            )
        return stats

    def _restore_component_states(self, snapshot: dict):
        states = snapshot.get("components") or {}
        for key, state in states.items():
            target = self._component(key)
            if target is None:
                logger.warning(
                    "snapshot names unknown component %r; skipped", key
                )
                continue
            try:
                target.restore_state(state)
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "snapshot restore for %s failed: %s", key, e
                )

    def _component(self, key: str):
        if key == KV:
            return self._kv
        if key == TASKS:
            return self._tasks
        if key == NODES:
            return self._nodes
        if key == BRAIN:
            return self._brain
        if key == CAPTURE:
            return self._capture
        if key.startswith(RDZV_PREFIX):
            return self._rdzv.get(key[len(RDZV_PREFIX):])
        return None

    def _route(self, component: str, op: str, args: dict):
        target = self._component(component)
        if target is None:
            logger.warning(
                "journal names unknown component %r; skipped",
                component,
            )
            return
        if hasattr(target, "apply_journal_op"):
            target.apply_journal_op(op, args)
        elif op == "state":
            target.restore_state(args)

    # ------------------------------------------------------- snapshot
    def snapshot_now(self):
        """One compacted snapshot: capture the pre-export journal seq
        as the low-water mark (mutations racing the export are both in
        the export AND replayed — harmless, records are idempotent),
        export every component, persist, prune."""
        if self._broken:
            return
        t0 = time.monotonic()
        try:
            seq = self._store.journal_seq(self._job)
            components = {}
            if self._kv is not None:
                components[KV] = self._kv.export_state()
            for name, manager in self._rdzv.items():
                components[RDZV_PREFIX + name] = (
                    manager.export_state()
                )
            if self._tasks is not None:
                components[TASKS] = self._tasks.export_state()
            if self._nodes is not None:
                components[NODES] = self._nodes.export_state()
            if self._brain is not None:
                components[BRAIN] = self._brain.export_state()
            if self._capture is not None:
                components[CAPTURE] = self._capture.export_state()
            self._store.save_control_snapshot(
                self._job, {"components": components}, seq
            )
            self._last_snapshot_mono = time.monotonic()
            self._last_snapshot_s = (
                self._last_snapshot_mono - t0
            )
            self._last_snapshot_seq = seq
        except Exception as e:  # noqa: BLE001
            logger.warning("control snapshot failed: %s", e)

    def health(self) -> dict:
        """Snapshot vitals for the master's self-telemetry: age (how
        long the journal tail a failover would replay has been
        growing) and duration of the last compacted snapshot.  Age is
        None until the first snapshot landed."""
        last = self._last_snapshot_mono
        return {
            "snapshot_age_s": (
                round(time.monotonic() - last, 3) if last > 0
                else None
            ),
            "snapshot_duration_s": round(self._last_snapshot_s, 4),
            "snapshot_seq": self._last_snapshot_seq,
            "interval_s": self._interval,
            "broken": self._broken,
        }

    def _loop(self):
        while not self._stopped.wait(self._interval):
            self.snapshot_now()

    def start(self):
        self._thread = threading.Thread(
            target=self._loop,
            name="control-plane-snapshot",
            daemon=True,
        )
        self._thread.start()

    def stop(self, retire: bool = False):
        """Stop the snapshot loop.  ``retire=False`` (master-only
        shutdown, e.g. a handover): final compacted snapshot, the next
        incarnation resumes this state.  ``retire=True`` (the JOB
        ended): drop the journal/snapshot and bump the job epoch so a
        future run under the same Brain db + job name starts FRESH —
        replaying a finished job's exhausted datasets and stale KV
        keys into a new job would silently end it at step 0 — and any
        straggler agent of the old run is fenced into a refresh.  A
        crash skips this method entirely; that's what the journal is
        for."""
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if not retire:
            self.snapshot_now()
            return
        try:
            self._store.bump_job_epoch(self._job)
            logger.info(
                "control-plane state for job %r retired (job ended)",
                self._job,
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("control-plane retire failed: %s", e)
