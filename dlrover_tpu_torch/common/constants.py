"""Every enum / constant used across the framework.

Copy of ``dlrover_tpu/common/constants.py``: both packages speak the
same control-plane vocabulary (node types and states, rendezvous names,
exit codes, the ``DLROVER_TPU_*`` environment contract) and write the
same checkpoint layout.

Reference parity: ``dlrover/python/common/constants.py:1-308``.
"""


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "k8s"
    RAY = "ray"


class Accelerators:
    TPU = "tpu"
    CPU = "cpu"  # virtual-device CI runs


class NodeType:
    """On TPU there is one training node type (a TPU-VM worker) plus the
    per-job master.  PS/chief/evaluator from the TF lineage are kept as
    names for API parity with PS-style jobs."""

    MASTER = "master"
    WORKER = "worker"
    CHIEF = "chief"
    EVALUATOR = "evaluator"
    PS = "ps"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"  # hardware-level failure (chip / host)
    UNKNOWN = "unknown"

    @classmethod
    def end_states(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED, cls.BREAKDOWN}


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"
    ERROR = "error"


class NodeExitReason:
    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"
    PREEMPTED = "preempted"  # TPU maintenance event / spot reclaim
    UNKNOWN_ERROR = "unknown_error"


class JobExitReason:
    SUCCEEDED = "succeeded"
    CODE_ERROR = "code_error"
    WORKER_OOM = "worker_oom"
    WORKER_ERROR = "worker_error"
    PENDING_TIMEOUT = "pending_timeout"
    RDZV_TIMEOUT = "rdzv_timeout"
    HANG_ERROR = "hang_error"
    UNKNOWN_ERROR = "unknown_error"


class DistributionStrategy:
    """Only SPMD (allreduce-family) training exists on TPU; PS is kept
    for API parity."""

    ALLREDUCE = "AllreduceStrategy"
    PS = "ParameterServerStrategy"
    LOCAL = "Local"
    CUSTOM = "CustomStrategy"


class RendezvousName:
    ELASTIC_TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class RendezvousConstant:
    MAX_WAIT_SECS = 600
    PENDING_TIMEOUT = 900


class NetworkFailureReason:
    NO_INIT = "Not initialized"
    NODE_FAILURE = "Node failure"
    WAITING_NODE = "Waiting node"


class TrainingExceptionLevel:
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    RDZV_ERROR = "rdzv_error"
    # the node received a preemption notice / SIGTERM and has DRAINED
    # (fresh shm snapshot flushed): the master should fence it out of
    # the next rendezvous immediately so survivors reshard without
    # waiting for its heartbeat to go stale
    NODE_PREEMPTED = "node_preempted"
    # the master left this node out of the completed comm world
    # (fault / straggler verdict): a scheduling decision, not a crash
    NODE_EXCLUDED = "node_excluded"
    WARNING = "warning"
    INFO = "info"


class AgentExitCode:
    """Distinct agent process exit codes: the supervising controller
    (and the chaos harness) keys recovery policy on WHY the agent
    exited — an excluded node must not be rescheduled into the same
    job the way a generic failure is."""

    SUCCESS = 0
    ERROR = 1
    #: the master excluded this node from the comm world
    NODE_EXCLUDED = 3
    #: the node was preempted and exited after a graceful drain
    NODE_PREEMPTED = 43


class TrainingLoopStatus:
    START = 1
    END = 2
    PENDING = 3


class CheckpointConstant:
    """Flash-checkpoint layout names (reference:
    ``common/constants.py`` ``CheckpointConstant`` +
    ``elastic_agent/torch/ckpt_saver.py`` stage-dir protocol)."""

    CKPT_DIR_PREFIX = "checkpoint-"
    STAGE_DIR = "._dlrover_ckpt_stage"
    STEP_FILE = "latest_step.txt"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    STATE_DICT_NAME = "state.msgpack"
    ARRAY_FILE = "arrays.bin"
    METADATA_NAME = "ckpt_meta.json"
    SAVE_TIMEOUT = 600


class SharedMemoryConstant:
    SHM_PREFIX = "dlrover_tpu_shm_"
    LOCK_PREFIX = "dlrover_tpu_lock_"
    QUEUE_PREFIX = "dlrover_tpu_queue_"
    DICT_PREFIX = "dlrover_tpu_dict_"


class NodeEnv:
    """Environment-variable contract between agent and training procs.

    Reference parity: ``common/constants.py`` ``NodeEnv`` (e.g.
    DLROVER_MASTER_ADDR / NODE_RANK).  ``COORDINATOR_ADDR`` is the
    ``host:port`` the port's workers hand to
    ``torch.distributed.init_process_group`` as ``tcp://`` (the
    agent's ``torch_coordinator/<round>`` KV key).
    """

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    # the node's index in this round's world (the order that assigns
    # process ranks): the checkpoint engine's node rank, which the node
    # rank is not once a node before it has left the world
    NODE_INDEX = "DLROVER_TPU_NODE_INDEX"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    NODE_TYPE = "DLROVER_TPU_NODE_TYPE"
    # training-process side
    PROCESS_RANK = "DLROVER_TPU_PROCESS_RANK"
    PROCESS_COUNT = "DLROVER_TPU_PROCESS_COUNT"
    LOCAL_RANK = "DLROVER_TPU_LOCAL_RANK"
    LOCAL_PROCESS_COUNT = "DLROVER_TPU_LOCAL_PROCESS_COUNT"
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    # the port's kernel build directory (ops/_build.py): the agent
    # points every incarnation at one, so a restart loads, not builds
    KERNEL_BUILD_DIR = "DLROVER_TPU_TORCH_BUILD_DIR"
    # platform
    PLATFORM = "DLROVER_TPU_PLATFORM"
    ACCELERATOR = "DLROVER_TPU_ACCELERATOR"
    DEVICES_PER_PROC = "DLROVER_TPU_DEVICES_PER_PROC"
    GRACE_PERIOD = "DLROVER_TPU_GRACE_PERIOD"
    # testing / fault injection
    FAKE_DEVICE_COUNT = "DLROVER_TPU_FAKE_DEVICE_COUNT"
    MOCK_ERROR_RATE = "DLROVER_TPU_MOCK_ERROR_RATE"
    # monitoring
    MONITOR_INTERVAL = "DLROVER_TPU_MONITOR_INTERVAL"
    CONFIG_DIR = "DLROVER_TPU_CONFIG_DIR"


class ConfigPath:
    """Runtime-tunable config files shared agent<->trainer (reference:
    ``elastic_agent/config/paral_config_tuner.py``)."""

    ENV_PARAL_CONFIG = "DLROVER_TPU_PARAL_CONFIG_PATH"
    PARAL_CONFIG = "/tmp/dlrover_tpu/auto_paral_config.json"
    ENV_RUNTIME_METRICS = "DLROVER_TPU_RUNTIME_METRICS_PATH"
    RUNTIME_METRICS = "/tmp/dlrover_tpu/runtime_metrics.json"


class JobConstant:
    RDZV_JOIN_TIMEOUT_DEFAULT = 600
    MASTER_CLIENT_TIMEOUT = 10
    MASTER_CLIENT_MAX_RETRY = 3
    TRAINING_AGENT_LOOP_INTERVAL = 5
    NODE_HEARTBEAT_INTERVAL = 15
    NODE_HEARTBEAT_TIMEOUT = 120


class GRPC:
    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024
    SERVICE_NAME = "dlrover_tpu_torch.Master"
    REPORT_METHOD = "report"
    GET_METHOD = "get"


class MeshAxis:
    """Canonical named mesh axes for the parallel layer.  Matches the
    reference's parallel-group names (``atorch/distributed/distributed.py``
    ``create_parallel_group`` names "data"/"tensor"/"pipe"/"sequence"/
    "expert") so strategy configs translate 1:1."""

    DATA = "data"
    FSDP = "fsdp"
    TENSOR = "tensor"
    SEQUENCE = "sequence"
    PIPE = "pipe"
    EXPERT = "expert"


class CustomMetricKeys:
    TRAINING_SPEED = "training_speed"
    GLOBAL_STEP = "global_step"
    STEP_TIME = "step_time"


class EventReportConstants:
    TYPE_INFO = "info"
    TYPE_WARN = "warn"
    TYPE_ERROR = "error"
    ACTION_RESTART_TRAIN = "restart_train"
    ACTION_RELAUNCH_NODE = "relaunch_node"
    ACTION_STOP_JOB = "stop_job"
