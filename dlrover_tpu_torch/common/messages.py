"""Control-plane message dataclasses + serialization envelope.

Copy of ``dlrover_tpu/common/messages.py``.

Reference parity: ``dlrover/python/common/grpc.py:150-496`` — the whole
agent<->master protocol is two RPCs (``report`` fire-and-forget with a
bool ack, ``get`` request/response) carrying serialized dataclasses in an
envelope ``Message{node_id, node_type, data}``
(``dlrover/proto/elastic_training.proto:19-29``).  The full dispatch
tables are reproduced in SURVEY.md Appendix A; every request/report type
there has an equivalent here (TF-PS-only types are kept for parity since
the master-side services are cheap).

Serialization is pickle restricted to the classes registered in this
module (the reference pickles arbitrarily; we at least pin the class
table).
"""

import io
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


#: Pinned wire protocol.  ``pickle.dumps`` without a protocol argument
#: uses DEFAULT_PROTOCOL, which lags HIGHEST by a version or two on
#: every interpreter — pinning HIGHEST keeps (de)serialization cost
#: minimal AND makes the choice explicit so the ``BatchedReport``
#: nesting (messages inside a message) can't silently fall back to a
#: slower encoding.  Parity is enforced by a round-trip test over
#: every message type in ``tests/test_control_plane.py``.
WIRE_PICKLE_PROTOCOL = pickle.HIGHEST_PROTOCOL


class Message:
    """Base class; every control-plane dataclass derives from it."""

    def serialize(self) -> bytes:
        return pickle.dumps(self, protocol=WIRE_PICKLE_PROTOCOL)


#: builtins actually needed to unpickle our dataclasses (container and
#: scalar constructors only — never eval/exec/getattr).
_SAFE_BUILTINS = {
    "set",
    "frozenset",
    "bytearray",
    "complex",
    "slice",
    "range",
}
_ALLOWED_MODULE_PREFIXES = ("dlrover_tpu_torch.", "collections")


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "builtins":
            if name in _SAFE_BUILTINS:
                return super().find_class(module, name)
        elif module.startswith(_ALLOWED_MODULE_PREFIXES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"forbidden class in control-plane message: {module}.{name}"
        )


def serialize_message(message: Optional[Message]) -> bytes:
    if message is None:
        return b""
    return pickle.dumps(message, protocol=WIRE_PICKLE_PROTOCOL)


def deserialize_message(data: bytes):
    if not data:
        return None
    return _RestrictedUnpickler(io.BytesIO(data)).load()


@dataclass
class Envelope(Message):
    """The on-wire unit: who sent it + the payload message.

    ``job_epoch`` / ``master_incarnation`` are the failover fencing
    pair: the epoch identifies the JOB generation (stable across
    master restarts of the same job; bumped when the job itself is
    reborn), the incarnation identifies the serving MASTER process
    (bumped on every master start).  ``-1`` = "not speaking the
    fencing protocol" (old clients, or failover kill-switched) and is
    never fenced."""

    node_id: int = 0
    node_type: str = ""
    data: bytes = b""
    job_epoch: int = -1
    master_incarnation: int = -1


@dataclass
class BoolResponse(Message):
    success: bool = False
    reason: str = ""


# --------------------------------------------------------------------------
# `get` requests (master/servicer get-dispatch parity)
# --------------------------------------------------------------------------


@dataclass
class TaskRequest(Message):
    dataset_name: str = ""
    #: long-poll: >0 blocks the master up to this many seconds while
    #: the dataset would only hand out WAIT tasks (0 = classic
    #: immediate answer)
    wait_timeout: float = 0.0


@dataclass
class DataShard(Message):
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: Optional[List[int]] = None


@dataclass
class Task(Message):
    task_id: int = -1
    task_type: str = ""  # TRAINING / EVALUATION / WAIT / NONE
    shard: DataShard = field(default_factory=DataShard)

    @property
    def is_empty(self) -> bool:
        return self.task_id < 0 and self.task_type != TaskType.WAIT


class TaskType:
    NONE = "none"
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"


@dataclass
class ShardCheckpointRequest(Message):
    dataset_name: str = ""


@dataclass
class ShardCheckpoint(Message):
    dataset_name: str = ""
    content: str = ""  # JSON from DatasetSplitter.checkpoint()


@dataclass
class RunningNodesRequest(Message):
    #: delta protocol: the version of the client's cached copy; the
    #: master answers ``NotModified`` when nothing changed (-1 = always
    #: send the full list)
    version: int = -1


@dataclass
class RunningNodes(Message):
    nodes: List = field(default_factory=list)
    version: int = 0


@dataclass
class JoinRendezvousRequest(Message):
    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    rdzv_name: str = ""
    node_ip: str = ""


@dataclass
class RendezvousState(Message):
    round: int = 0
    waiting_num: int = 0


@dataclass
class WaitingNodeNumRequest(Message):
    rdzv_name: str = ""
    #: long-poll: >0 blocks until the waiting count differs from
    #: ``last_num`` (or the timeout elapses); 0 = immediate answer
    wait_timeout: float = 0.0
    last_num: int = -1


@dataclass
class WaitingNodeNum(Message):
    waiting_num: int = 0
    #: Brain node directive piggybacked on the monitor-pacing poll
    #: (zero extra RPCs): "" = nothing for this node; ``drain`` = run
    #: the graceful-drain protocol (snapshot → flush → report
    #: preempted → exit) — the Brain planned this node out of the
    #: world.  Consumed on delivery; old masters simply never set it.
    action: str = ""
    action_reason: str = ""
    action_id: int = 0


@dataclass
class NetworkReadyRequest(Message):
    pass


@dataclass
class NetworkCheckResult(Message):
    nodes: List[int] = field(default_factory=list)
    reason: str = ""


@dataclass
class StragglerExistRequest(Message):
    pass


@dataclass
class CommWorldRequest(Message):
    node_id: int = 0
    rdzv_name: str = ""
    #: delta protocol: rendezvous state version of the client's cached
    #: world (-1 = no cache); when the version still matches the master
    #: answers ``NotModified`` instead of re-shipping the world
    version: int = -1
    #: long-poll: >0 blocks until the world is complete AND newer than
    #: ``version`` (or the timeout elapses); 0 = immediate answer
    wait_timeout: float = 0.0


@dataclass
class CommWorld(Message):
    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    world: Dict[int, int] = field(default_factory=dict)  # node_rank -> lws
    version: int = 0


@dataclass
class KeyValuePair(Message):
    key: str = ""
    value: bytes = b""


@dataclass
class KVWaitRequest(Message):
    """Long-poll ``get``: block on the master until ``key`` is set (or
    ``wait_timeout`` elapses — the response then carries an empty
    value).  One RPC replaces a ``timeout/interval`` polling loop."""

    key: str = ""
    wait_timeout: float = 0.0


@dataclass
class KeyValuePairs(Message):
    kvs: Dict[str, bytes] = field(default_factory=dict)


@dataclass
class PsNodesRequest(Message):
    pass


@dataclass
class PsNodes(Message):
    nodes: List = field(default_factory=list)
    new_ps_ready: bool = False
    ps_failure: bool = False


@dataclass
class TrainingStatusRequest(Message):
    #: long-poll: >0 blocks until training has started (or the timeout
    #: elapses); 0 = immediate answer
    wait_timeout: float = 0.0


@dataclass
class TrainingStatus(Message):
    status: int = 3  # TrainingLoopStatus.PENDING


@dataclass
class NotModified(Message):
    """Delta-protocol answer: the client's cached copy (at ``version``)
    is still current — nothing to ship."""

    version: int = 0


@dataclass
class StaleEpoch(Message):
    """Typed fencing answer: the request's ``job_epoch`` does not
    match the serving master's.  Carries the CURRENT pair so the
    client can refresh its caches and re-issue instead of crashing."""

    job_epoch: int = 0
    incarnation: int = 0


@dataclass
class ControlEpochRequest(Message):
    """Fetch the master's current ``(job_epoch, incarnation)`` pair —
    the client-side refresh after a ``StaleEpoch`` answer or a
    reconnect.  Never fenced (it IS the refresh path)."""


@dataclass
class ControlEpoch(Message):
    job_epoch: int = 0
    incarnation: int = 0


@dataclass
class ParallelConfigRequest(Message):
    pass


@dataclass
class DataLoaderConfig(Message):
    dataloader_name: str = ""
    batch_size: int = 0
    num_workers: int = 0
    prefetch_count: int = 0


@dataclass
class OptimizerConfig(Message):
    learning_rate: float = 0.0
    micro_batch_size: int = 0


@dataclass
class ParallelConfig(Message):
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    restart: bool = False


@dataclass
class CheckHardwareResetRequest(Message):
    pass


@dataclass
class ClusterVersionRequest(Message):
    task_type: str = ""
    task_id: int = 0
    version_type: str = ""


@dataclass
class ClusterVersion(Message):
    version: int = 0


@dataclass
class ElasticRunConfigRequest(Message):
    pass


@dataclass
class ElasticRunConfig(Message):
    configs: Dict[str, str] = field(default_factory=dict)


# --------------------------------------------------------------------------
# `report` messages (master/servicer report-dispatch parity)
# --------------------------------------------------------------------------


@dataclass
class BatchedReport(Message):
    """Coalesced delta reporting: one envelope carrying several report
    messages (heartbeats, speed/metric samples, node events, timeline
    batches) accumulated by the client-side ``ReportBuffer``.  The
    master dispatches the items IN ORDER through the ordinary report
    table; the ack is true only when every item succeeded."""

    items: List[Message] = field(default_factory=list)


@dataclass
class DatasetShardParams(Message):
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    task_type: str = TaskType.TRAINING
    storage_type: str = "table"


@dataclass
class ResourceStats(Message):
    cpu_percent: float = 0.0
    memory_mb: int = 0
    tpu_stats: List[Dict] = field(default_factory=list)  # per-chip stats


@dataclass
class ModelInfo(Message):
    num_params: int = 0
    flops_per_step: float = 0.0
    hidden_size: int = 0
    num_layers: int = 0
    seq_len: int = 0
    extra: Dict = field(default_factory=dict)


@dataclass
class GlobalStep(Message):
    step: int = 0
    timestamp: float = 0.0
    elapsed_time_per_step: float = 0.0


@dataclass
class TaskResult(Message):
    dataset_name: str = ""
    task_id: int = 0
    err_message: str = ""


@dataclass
class NodeAddress(Message):
    addr: str = ""
    node_type: str = ""
    node_id: int = 0


@dataclass
class NodeTopology(Message):
    """Interconnect position of a node (outermost level first, e.g.
    superpod/pod/slice) — feeds topology-aware rank sorting
    (reference ``net_topology.py:20`` NodeTopologyMeta)."""

    node_rank: int = 0
    levels: Tuple = ()


@dataclass
class NetworkStatus(Message):
    node_rank: int = 0
    succeeded: bool = False
    elapsed_time: float = 0.0


@dataclass
class NodeEventMessage(Message):
    event_type: str = ""
    node_type: str = ""
    node_id: int = 0
    reason: str = ""


@dataclass
class SyncJoin(Message):
    sync_name: str = ""
    worker_type: str = ""
    worker_id: int = 0


@dataclass
class SyncFinish(Message):
    sync_name: str = ""


@dataclass
class SyncBarrier(Message):
    barrier_name: str = ""
    notify: bool = False


@dataclass
class NodeFailure(Message):
    error_data: str = ""
    level: str = ""
    restart_count: int = 0


@dataclass
class RendezvousParams(Message):
    min_nodes: int = 1
    max_nodes: int = 1
    waiting_timeout: int = 600
    node_unit: int = 1
    joint_timeout: int = 600


@dataclass
class PsReady(Message):
    pass


@dataclass
class HeartBeat(Message):
    timestamp: float = 0.0


@dataclass
class NodeCheckpointState(Message):
    step: int = 0


@dataclass
class DiagnosisReportData(Message):
    data_cls: str = ""
    data_content: str = ""
    node_rank: int = -1


@dataclass
class Event(Message):
    event_type: str = ""
    instance: str = ""
    action: str = ""
    msg: str = ""
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class SucceededRequest(Message):
    pass


@dataclass
class TimelineEventsReport(Message):
    """One node's batch of timeline events (the JSONL records from
    ``observability/events.py``, shipped by the agent's
    ``TimelineReporter``) for the master's ``TimelineAggregator``."""

    events: List[Dict] = field(default_factory=list)


@dataclass
class TimelineQueryRequest(Message):
    """Get the master's merged goodput ledger (and optionally the
    newest ``limit`` raw events; 0 = ledger only)."""

    job: str = ""
    limit: int = 0


@dataclass
class TimelineQueryResponse(Message):
    ledger: Dict = field(default_factory=dict)
    events: List[Dict] = field(default_factory=list)
    available: bool = False  # False = no aggregator on this master


@dataclass
class JobStatusRequest(Message):
    """Fetch the master observatory's full derived snapshot: per-node
    health (step-rate/step-time EWMAs, stall shares, straggler scores,
    hang verdicts), the live goodput ledger, and the newest diagnosis
    conclusions.  ``scripts/top.py`` and the chaos scenario read this."""

    job: str = ""
    #: include the newest N diagnosis conclusions (0 = none)
    conclusions: int = 16


@dataclass
class JobStatusResponse(Message):
    #: {"health": HealthEngine.snapshot(), "ledger": ...,
    #:  "conclusions": [...], "speed": {...}, "epoch": {...}}
    status: Dict = field(default_factory=dict)
    available: bool = False  # False = observatory off / absent


@dataclass
class ProfileReport(Message):
    """One node's deep-capture result (the agent answering a
    ``capture`` directive): the parsed profile summary — top ops,
    category shares, GEMM clusters, stack-dump inventory — plus the
    path of the artifact written under the events dir.  The master's
    ``CaptureCoordinator`` exposes it on ``/status`` and persists a
    row to the Brain ``profiles`` table."""

    node_rank: int = -1
    kind: str = "capture"
    reason: str = ""
    capture_id: int = 0
    summary: Dict = field(default_factory=dict)
    artifact: str = ""


@dataclass
class BrainQueryRequest(Message):
    """Query the master's durable Brain datastore (speed history /
    node events / measured workloads) — the TPU analog of the Go
    Brain's query RPCs over its MySQL recorders."""

    # speed | node_events | workloads | measurements (the last
    # returns calibration history for ``workload`` — what lets a
    # DIFFERENT job's master adopt this fleet's measurements over RPC
    # instead of mounting the db file)
    kind: str = "speed"
    job: str = "default"
    limit: int = 100
    workload: str = ""  # measurements: a workload_signature string


@dataclass
class BrainQueryResponse(Message):
    # speed: {worker_count: records_per_sec}; node_events: list of
    # dicts; workloads: list of workload-signature strings
    payload: Dict = field(default_factory=dict)
    available: bool = False  # False = no datastore configured


# --------------------------------------------------------------------------
# scale plans (master -> scaler; also CRD-shaped for the k8s path)
# --------------------------------------------------------------------------


@dataclass
class ScalePlan(Message):
    node_group_resources: Dict = field(default_factory=dict)
    launch_nodes: List = field(default_factory=list)
    remove_nodes: List = field(default_factory=list)
    migrate_nodes: Dict = field(default_factory=dict)

    def is_empty(self) -> bool:
        return not (
            self.node_group_resources
            or self.launch_nodes
            or self.remove_nodes
            or self.migrate_nodes
        )
