"""Environment helpers: the port's own copy of the readers in
``dlrover_tpu/common/env.py`` that port code calls, with the same
variable names, defaults, clamping and parsing, so one environment
configures either package.  Process identity, the control plane's
long-poll and batching, the master's pool size and reconnect deadline,
the events file's rotation, the checkpoint close timeout, the drain
grace, the restart overlap and the previous world, the serving readers
(``kv_incremental_enabled`` .. ``decode_steps``), the master's durable
state and observatory (the datastore's write-behind switch, the timeline
retention, the snapshot cadence, the observatory and self-telemetry
switches) and ``get_free_port``.

One difference: the switch of the master's subsystem that the port
does not have yet (the live profiler and deep capture,
``DLROVER_TPU_PROFILE``, ROADMAP A7) defaults to off here; turned on,
the master raises ``NotImplementedError`` naming it rather than running
without it.  The Brain (``DLROVER_TPU_BRAIN``) defaults to on, as in the
reference, and every master builds it (``brain_enabled``).  Each other
reader comes with the slice that calls it.
"""

import os

from dlrover_tpu_torch.common.constants import NodeEnv


def _get_int(name: str, default: int = 0) -> int:
    value = os.getenv(name, "")
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def get_node_id() -> int:
    return _get_int(NodeEnv.NODE_ID, 0)


def get_node_rank() -> int:
    return _get_int(NodeEnv.NODE_RANK, get_node_id())


def get_node_index() -> int:
    """The node's index in this rendezvous round's world (set by the
    agent); the node rank where no agent set it."""
    return _get_int(NodeEnv.NODE_INDEX, get_node_rank())


def get_process_rank() -> int:
    return _get_int(NodeEnv.PROCESS_RANK, 0)


def get_process_count() -> int:
    return _get_int(NodeEnv.PROCESS_COUNT, 1)


def get_local_process_count() -> int:
    return _get_int(NodeEnv.LOCAL_PROCESS_COUNT, 1)


INPUT_PIPELINE_ENV = "DLROVER_TPU_INPUT_PIPELINE"


def input_pipeline_enabled() -> bool:
    """Kill-switch for the pipelined input plane (background host
    fetch in ``ElasticDataLoader``/``device_prefetch`` and the
    shard-task RPC prefetch).  ``DLROVER_TPU_INPUT_PIPELINE=0``
    reproduces the serial path — same batch order, byte-identical
    batches (pinned by tests).  Default: enabled."""
    return os.getenv(INPUT_PIPELINE_ENV, "1").lower() not in (
        "0", "false", "off",
    )


CONTROL_LONGPOLL_ENV = "DLROVER_TPU_CONTROL_LONGPOLL"
CONTROL_BATCH_ENV = "DLROVER_TPU_CONTROL_BATCH"


def control_longpoll_enabled() -> bool:
    """Kill-switch for the control-plane fast path: server-side
    long-poll waits (KV store, comm world, shard tasks, training
    status, master-ready).  ``DLROVER_TPU_CONTROL_LONGPOLL=0``
    reproduces the client-side polling loops exactly (the bench
    reference and the rollback path).  Default: enabled."""
    return os.getenv(CONTROL_LONGPOLL_ENV, "1").lower() not in (
        "0", "false", "off",
    )


def control_batch_enabled() -> bool:
    """Kill-switch for coalesced delta reporting: with
    ``DLROVER_TPU_CONTROL_BATCH=0`` every ``ReportBuffer.add``
    degenerates to the old one-RPC-per-report path.  Default:
    enabled."""
    return os.getenv(CONTROL_BATCH_ENV, "1").lower() not in (
        "0", "false", "off",
    )


DATASTORE_SYNC_ENV = "DLROVER_TPU_DATASTORE_SYNC"


def datastore_sync_enabled() -> bool:
    """``DLROVER_TPU_DATASTORE_SYNC=1`` keeps every Brain datastore
    write a synchronous INSERT+commit; default is the write-behind
    flusher."""
    return os.getenv(DATASTORE_SYNC_ENV, "").lower() in (
        "1", "true", "on",
    )


OBSERVATORY_ENV = "DLROVER_TPU_OBSERVATORY"
EVENTS_MAX_MB_ENV = "DLROVER_TPU_EVENTS_MAX_MB"
TIMELINE_MAX_AGE_ENV = "DLROVER_TPU_TIMELINE_MAX_AGE_S"
TIMELINE_MAX_ROWS_ENV = "DLROVER_TPU_TIMELINE_MAX_ROWS"


def observatory_enabled() -> bool:
    """Kill-switch for the master-side observatory: the streaming
    health-derivation engine (``observability/health.py``), the
    derived-signal diagnosis operators (straggler / data-stall / hang
    watchdog), the ``JobStatusRequest`` RPC, the ``--status_port``
    HTTP endpoints, and the timeline growth bounds.
    ``DLROVER_TPU_OBSERVATORY=0`` leaves the diagnosis chain on its
    own data store, hang detection on the ``SpeedMonitor`` alone, and
    the timeline unbounded.  Default: enabled."""
    return os.getenv(OBSERVATORY_ENV, "1").lower() not in (
        "0", "false", "off",
    )


def env_float(name: str, default: float) -> float:
    """Float env knob with a default (malformed values fall back) —
    the one parser behind every tunable threshold."""
    try:
        return float(os.getenv(name, "") or default)
    except ValueError:
        return default


def events_max_bytes() -> int:
    """Size-based rotation threshold for the agent-side JSONL events
    file (0 = never rotate).  Generous default: a week-long job at
    control-plane event rates stays far below it."""
    return int(env_float(EVENTS_MAX_MB_ENV, 256.0) * 1024 * 1024)


def timeline_max_age_s() -> float:
    """Brain ``timeline_events`` retention age (rows older than this
    are swept; 0 = age-unbounded)."""
    return env_float(TIMELINE_MAX_AGE_ENV, 7 * 24 * 3600.0)


def timeline_max_rows() -> int:
    """Brain ``timeline_events`` per-job row cap (newest rows win;
    0 = row-unbounded)."""
    return int(env_float(TIMELINE_MAX_ROWS_ENV, 500_000))


CKPT_CLOSE_TIMEOUT_ENV = "DLROVER_TPU_CKPT_CLOSE_TIMEOUT_S"
PREEMPT_DRAIN_GRACE_ENV = "DLROVER_TPU_PREEMPT_DRAIN_GRACE_S"


def ckpt_close_timeout_s() -> float:
    """How long ``CheckpointEngine.close()`` waits for an in-flight
    snapshot drain before deliberately LEAKING the shm/lock/queue
    handles (closing under a live drain would corrupt the persist —
    the leak is the safe outcome, now observable via the
    ``dlrover_tpu_ckpt_drain_stuck`` counter)."""
    return env_float(CKPT_CLOSE_TIMEOUT_ENV, 300.0)


def preempt_drain_grace_s() -> float:
    """How long the agent waits, after asking workers to drain
    (SIGUSR1 -> snapshot-every-step), for a fresh common step to land
    in shm before flushing to storage.  Bounded by the preemption
    notice lead (~60 s on GCE) and the pod's SIGTERM grace."""
    return env_float(PREEMPT_DRAIN_GRACE_ENV, 5.0)


RESTART_OVERLAP_ENV = "DLROVER_TPU_RESTART_OVERLAP"
PREV_WORLD_ENV = "DLROVER_TPU_PREV_WORLD"


def restart_overlap_enabled() -> bool:
    """The overlapped restart critical path (restore prefetch beside the
    state build, ``trainer/restart_path.py``); "0"/"false"/"off" forces
    the serial restore (the launcher's ``--no_restart_overlap``)."""
    return os.getenv(RESTART_OVERLAP_ENV, "1").strip().lower() not in (
        "0", "false", "off",
    )


def prev_world_size() -> int:
    """The world size of the agent's previous rendezvous round (0 on
    the first): a restarted worker whose world changed cannot use a
    prefetch that staged the old world's shard."""
    return _get_int(PREV_WORLD_ENV, 0)


KV_INCREMENTAL_ENV = "DLROVER_TPU_KV_INCREMENTAL"
KV_GROW_BLOCKS_ENV = "DLROVER_TPU_KV_GROW_BLOCKS"
KV_ADMIT_WATERMARK_ENV = "DLROVER_TPU_KV_ADMIT_WATERMARK"
KV_PREFIX_CACHE_ENV = "DLROVER_TPU_KV_PREFIX_CACHE"
DECODE_STEPS_ENV = "DLROVER_TPU_DECODE_STEPS"


def kv_incremental_enabled() -> bool:
    """Kill-switch for the incremental-allocation serving discipline
    (watermark admission + on-demand block growth + lowest-priority
    sequence preemption + prefix caching in ``rl/scheduler.py`` /
    ``rl/kv_cache.py``).  ``DLROVER_TPU_KV_INCREMENTAL=0`` reproduces
    the PR-13 worst-case reservation admission byte-for-byte (admit
    only when ``ceil((prompt + max_new) / block_size)`` blocks are
    free; no growth, no preemption, no shared blocks — pinned by
    tests).  Default: enabled."""
    return os.getenv(KV_INCREMENTAL_ENV, "1").lower() not in (
        "0", "false", "off",
    )


def kv_grow_blocks() -> int:
    """Decode-time growth quantum: how many blocks an admitted
    sequence reserves as headroom beyond its prompt, and the chunk its
    block table grows by when decode crosses a block boundary (>= 1 —
    the first decode position can sit past the prompt's last block)."""
    return max(1, int(env_float(KV_GROW_BLOCKS_ENV, 2)))


def kv_admit_watermark() -> float:
    """Watermark admission (incremental mode): a new sequence is
    admitted only if, after its initial allocation, at least this
    FRACTION of the usable pool stays free as growth headroom for the
    sequences already running.  0 = admit whenever the initial
    allocation fits (maximum admission, maximum preemption churn).
    The first sequence always admits regardless (progress)."""
    return min(max(env_float(KV_ADMIT_WATERMARK_ENV, 0.1), 0.0), 0.9)


def kv_prefix_cache_enabled() -> bool:
    """Prefix caching (incremental mode only): content-hash full
    prompt blocks into a ref-counted shared-block index so requests
    with a common prompt prefix map the same physical blocks.
    ``DLROVER_TPU_KV_PREFIX_CACHE=0`` disables sharing while keeping
    incremental allocation.  Default: enabled (inert unless
    ``kv_incremental_enabled()``)."""
    return os.getenv(KV_PREFIX_CACHE_ENV, "1").lower() not in (
        "0", "false", "off",
    )


def decode_steps() -> int:
    """Multi-token decode: K decode steps fused into ONE compiled
    scheduler iteration (K-greedy self-drafting + one batched verify
    forward; ``rl/scheduler.py``).  ``DLROVER_TPU_DECODE_STEPS=1``
    (the default) is exactly the PR-13 one-token-per-dispatch loop."""
    return max(1, int(env_float(DECODE_STEPS_ENV, 1)))


PROFILE_ENV = "DLROVER_TPU_PROFILE"


def profile_enabled() -> bool:
    """Switch of the live attribution profiler and the master's deep
    capture coordinator.  Not ported yet: on, the master raises
    ``NotImplementedError`` naming ROADMAP A7.  Default in the port:
    off; the JAX package's default is on."""
    return os.getenv(PROFILE_ENV, "0").lower() not in (
        "0", "false", "off",
    )


BRAIN_ENV = "DLROVER_TPU_BRAIN"
BRAIN_INTERVAL_ENV = "DLROVER_TPU_BRAIN_INTERVAL_S"
BRAIN_COOLDOWN_ENV = "DLROVER_TPU_BRAIN_COOLDOWN_S"
BRAIN_SUSTAIN_ENV = "DLROVER_TPU_BRAIN_SUSTAIN"


def brain_enabled() -> bool:
    """Kill-switch for the autonomy loop: the observatory-fed Brain
    (``master/resource_optimizer.ObservatoryBrainOptimizer`` +
    ``master/auto_scaler.BrainAutoScaler`` + the planned-action
    executor in ``master/brain.py``), its node directives riding the
    ``WaitingNodeNum`` response, its journal component, and the
    ``scale_decision``/``scale_execute`` telemetry.
    ``DLROVER_TPU_BRAIN=0`` leaves the master without it: no
    directives on the wire, nothing journaled.  Default: enabled, as
    in the reference."""
    return os.getenv(BRAIN_ENV, "1").lower() not in (
        "0", "false", "off",
    )


def brain_interval_s() -> float:
    """Cadence of the Brain decision cycle."""
    return env_float(BRAIN_INTERVAL_ENV, 30.0)


def brain_cooldown_s() -> float:
    """Minimum quiet time after an executed decision before the next
    same-direction decision; opposite-direction decisions wait twice
    this (hysteresis)."""
    return env_float(BRAIN_COOLDOWN_ENV, 120.0)


def brain_sustain_cycles() -> int:
    """Consecutive decision cycles a signal (straggler verdict, hang
    verdict, chronic stall share) must persist before the Brain acts
    on it: one noisy snapshot is not a verdict."""
    return max(int(env_float(BRAIN_SUSTAIN_ENV, 2.0)), 1)


SELF_OBS_ENV = "DLROVER_TPU_SELF_OBS"
MASTER_WORKERS_ENV = "DLROVER_TPU_MASTER_WORKERS"


def self_obs_enabled() -> bool:
    """Kill-switch for the master's control-plane self-telemetry: the
    per-RPC-kind latency / request-size / response-size histograms,
    the in-flight / parked-long-poll / thread-pool-occupancy gauges,
    the per-job state row counts, the datastore write-behind health
    gauges (queue depth, flush-latency histogram, journal lag), the
    snapshot age/duration gauges, the ``master`` section of
    ``/status`` + ``JobStatusResponse``, and the ``MasterHealth``
    overload deriver.  ``DLROVER_TPU_SELF_OBS=0`` leaves no
    ``dlrover_tpu_master_*`` / ``dlrover_tpu_datastore_*`` /
    ``dlrover_tpu_journal_*`` / ``dlrover_tpu_snapshot_*`` series.
    Default: enabled."""
    return os.getenv(SELF_OBS_ENV, "1").lower() not in (
        "0", "false", "off",
    )


def master_workers() -> int:
    """gRPC thread-pool size of the master server
    (``DLROVER_TPU_MASTER_WORKERS``).  Each PARKED long-poll holds a
    pool thread for its whole wait, so the ceiling bounds the fleet a
    single master can serve — it must be raisable without a code
    change, and the occupancy gauge
    (``dlrover_tpu_master_busy_workers`` over
    ``dlrover_tpu_master_worker_pool_size``) is derived from this
    same value so the two can never disagree."""
    return max(int(env_float(MASTER_WORKERS_ENV, 64.0)), 1)


MASTER_FAILOVER_ENV = "DLROVER_TPU_MASTER_FAILOVER"
RECONNECT_DEADLINE_ENV = "DLROVER_TPU_MASTER_RECONNECT_DEADLINE_S"
SNAPSHOT_INTERVAL_ENV = "DLROVER_TPU_CONTROL_SNAPSHOT_INTERVAL_S"


def master_failover_enabled() -> bool:
    """Kill-switch for the master-failover subsystem: durable
    control-plane journaling/replay (with a Brain db), transparent
    ``MasterChannel`` reconnection, and ``(job_epoch,
    master_incarnation)`` fencing.  ``DLROVER_TPU_MASTER_FAILOVER=0``
    gives the fail-fast behavior: a dead master raises
    ``ConnectionError`` after ``max_retry`` attempts, no epochs ride
    the envelope, and the master journals nothing.  Default:
    enabled."""
    return os.getenv(MASTER_FAILOVER_ENV, "1").lower() not in (
        "0", "false", "off",
    )


def master_reconnect_deadline_s() -> float:
    """Total time a client keeps retrying/reconnecting across a
    master outage before giving up (failover mode only)."""
    try:
        return float(os.getenv(RECONNECT_DEADLINE_ENV, "120"))
    except ValueError:
        return 120.0


def control_snapshot_interval_s() -> float:
    """Cadence of the master's compacted control-plane snapshot
    (journal entries at or below the snapshot seq are pruned)."""
    try:
        return float(os.getenv(SNAPSHOT_INTERVAL_ENV, "20"))
    except ValueError:
        return 20.0


def get_free_port(host: str = "127.0.0.1") -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]
