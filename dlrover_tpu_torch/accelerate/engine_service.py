"""Strategy-generation service: acceleration decisions as an RPC.

Copy of ``dlrover_tpu/accelerate/engine_service.py`` over the port's
``common/comm.py`` and ``common/messages.py``, with the durable
history of measurements in the port's ``master/datastore.py`` when
``DLROVER_TPU_BRAIN_DB`` is set (the same table and workload
signatures, so either package's service reads the other's history).

Reference parity: ``atorch/atorch/auto/engine/acceleration_engine.py:13``
— the reference spawns a gRPC service (``engine/servicer.py`` +
``engine/client.py``) whose executor walks ANALYSE → candidate
generation → DRYRUN tasks so a whole cluster shares one strategy
brain.  The TPU form rides the same 2-RPC pickled-dataclass transport
the master uses (``common/comm.py``): a client submits a model profile
(abstract shapes — no weights cross the wire), the service answers
with ranked, memory-fit, workload-aware candidates; timed dry runs
stay client-side where the devices are (the reference's dry-run
workers are device-local too).
"""

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.accelerate.analyser import ModelProfile
from dlrover_tpu_torch.accelerate.strategy import (
    Strategy,
    generate_candidates,
)
from dlrover_tpu_torch.common.comm import MasterChannel, build_master_server
from dlrover_tpu_torch.common.env import get_free_port
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import (
    BoolResponse,
    Message,
    deserialize_message,
)


@dataclass
class StrategyRequest(Message):
    """Client -> service: the analysed model + workload shape."""

    num_params: int = 0
    param_bytes: int = 0
    optimizer_bytes: int = 0
    activation_bytes_per_sample: int = 0
    num_layers: int = 0
    n_devices: int = 1
    batch_per_replica: int = 1
    seq_len: int = 2048
    # the client's REAL global batch (None = unknown): candidates
    # whose batch sharding can't divide it are useless to serve
    global_batch: Optional[int] = None
    long_context: bool = False
    moe: bool = False
    max_candidates: int = 8


@dataclass
class StrategyResponse(Message):
    """Ranked candidates as Strategy kwargs dicts (wire-stable)."""

    candidates: List = field(default_factory=list)
    # true when the ranking used fleet-measured timings (the service's
    # calibrated planner had data for this workload)
    calibrated: bool = False


@dataclass
class StrategyMeasurement(Message):
    """Client -> service: one measured dry-run/production step time.

    The Brain role (reference ``persist_metrics`` RPC +
    ``optimize_job_worker_resource.go``'s learned throughput model):
    clients report what a strategy actually cost; the service
    calibrates its per-term cost model per workload and ranks BETTER
    for the next requester of the same workload."""

    # workload key (same fields the request carries — byte fields
    # included: two jobs with equal param counts but different
    # activation/optimizer footprints are DIFFERENT workloads)
    num_params: int = 0
    param_bytes: int = 0
    optimizer_bytes: int = 0
    activation_bytes_per_sample: int = 0
    num_layers: int = 0
    batch_per_replica: int = 1
    seq_len: int = 2048
    # what was measured
    strategy: Dict = field(default_factory=dict)
    step_time_s: float = 0.0


def _strategy_to_dict(s: Strategy) -> Dict:
    # asdict stays exact as Strategy grows fields (a hand-rolled list
    # would silently drop e.g. pipe_microbatches on the wire)
    import dataclasses

    return dataclasses.asdict(s)


# warn once per distinct unknown-field set: steady-state version skew
# during a rolling upgrade would otherwise log per RPC at fleet scale
_warned_unknown_fields: set = set()


def _strategy_from_dict(kw: Dict) -> Optional[Strategy]:
    """Version-skew-tolerant Strategy reconstruction (both directions
    of a rolling upgrade put unknown fields on the wire).  Unknown
    keys are dropped WITH a (once-per-set) warning — a silently
    defaulted renamed field would corrupt whatever consumes the
    result — and an unconstructible dict returns None."""
    import dataclasses

    known = {f.name for f in dataclasses.fields(Strategy)}
    unknown = tuple(sorted(set(kw) - known))
    if unknown and unknown not in _warned_unknown_fields:
        _warned_unknown_fields.add(unknown)
        logger.warning(
            "strategy wire dict has unknown fields %s (version "
            "skew?); dropping them", list(unknown),
        )
    try:
        return Strategy(**{k: v for k, v in kw.items() if k in known})
    except (TypeError, ValueError) as e:
        logger.warning("unusable strategy dict: %s", e)
        return None


def _workload_key(msg) -> Tuple:
    """Workload identity from a request OR measurement (both carry the
    same profile fields)."""
    return (
        msg.num_params,
        msg.param_bytes,
        msg.optimizer_bytes,
        msg.activation_bytes_per_sample,
        msg.num_layers,
        msg.batch_per_replica,
        msg.seq_len,
    )


class StrategyService:
    """The in-process brain behind the RPC surface (usable directly —
    the service wrapper only adds the wire).

    Reported measurements accumulate per workload; once any exist, the
    ranking for that workload runs through a
    :class:`~dlrover_tpu_torch.accelerate.dim_planner.CalibratedPlanner`
    fitted on them — the fleet teaches the service its real
    compute/comm balance (the reference Brain's datastore + learned
    throughput model)."""

    # newest measurements win; older fleet history ages out (bounds
    # service memory AND keeps the fit tracking current hardware)
    MAX_MEASUREMENTS_PER_WORKLOAD = 64

    def __init__(self, datastore=None, job: str = ""):
        """``datastore``: a
        :class:`~dlrover_tpu_torch.master.datastore.BrainDatastore` making
        the fleet calibration durable across master restarts
        (reference: the Go Brain's MySQL recorders,
        ``dbbase/recorder.go:280``).  None = in-memory only; defaults
        to the process datastore when ``DLROVER_TPU_BRAIN_DB`` is
        set.  ``job`` tags this master's measurements so a SHARED db
        file serves as a multi-job Brain: measurements are keyed by
        workload signature, so job B's planner adopts job A's
        calibration on first touch (defaults to
        ``DLROVER_TPU_JOB_NAME``)."""
        import threading

        # one lock over both maps: the gRPC pool serves record() and
        # generate() concurrently, and a stale planner stored after a
        # concurrent record() would silently drop that measurement
        self._lock = threading.Lock()
        self._measurements: Dict[Tuple, List] = {}
        # fitted planner per workload, invalidated by record()
        self._planners: Dict[Tuple, object] = {}
        if datastore is None:
            from dlrover_tpu_torch.master.datastore import (
                get_default_datastore,
            )

            datastore = get_default_datastore()
        self._datastore = datastore
        self._job = job or os.getenv("DLROVER_TPU_JOB_NAME", "")

    def _load_persisted(self, key: Tuple) -> List:
        """History for ``key`` from the datastore (restart recovery);
        [] when no store, nothing recorded, or the store is broken —
        durability is best-effort, never load-bearing for the RPCs."""
        if self._datastore is None:
            return []
        from dlrover_tpu_torch.master.datastore import workload_signature

        out = []
        try:
            rows = self._datastore.load_measurements(
                workload_signature(key),
                limit=self.MAX_MEASUREMENTS_PER_WORKLOAD,
            )
        except Exception as e:  # noqa: BLE001 - degrade to in-memory
            logger.warning("measurement history load failed: %s", e)
            return []
        for kw, step_time in rows:
            strategy = _strategy_from_dict(kw)
            if strategy is not None:
                out.append((strategy, step_time))
        return out

    def record(self, m: StrategyMeasurement) -> None:
        if m.step_time_s <= 0:
            return
        strategy = _strategy_from_dict(m.strategy)
        if strategy is None:
            return
        key = _workload_key(m)
        with self._lock:
            hist = self._measurements.get(key)
            if hist is None:
                # first touch since (re)start: adopt persisted history
                # so the refit sees the whole fleet record
                hist = self._measurements[key] = self._load_persisted(
                    key
                )
            hist.append((strategy, m.step_time_s))
            del hist[: -self.MAX_MEASUREMENTS_PER_WORKLOAD]
            self._planners.pop(key, None)  # refit on next request
        if self._datastore is not None:
            from dlrover_tpu_torch.master.datastore import (
                workload_signature,
            )

            try:
                self._datastore.record_measurement(
                    workload_signature(key), dict(m.strategy),
                    m.step_time_s, job=self._job,
                )
            except Exception as e:  # noqa: BLE001 - best-effort
                logger.warning("measurement persist failed: %s", e)

    def generate(self, req: StrategyRequest) -> StrategyResponse:
        profile = ModelProfile(
            num_params=req.num_params,
            param_bytes=req.param_bytes,
            largest_leaf=0,
            leaf_count=0,
            optimizer_bytes=req.optimizer_bytes,
            activation_bytes_per_sample=(
                req.activation_bytes_per_sample
            ),
            num_layers=req.num_layers,
        )
        cands = generate_candidates(
            profile,
            req.n_devices,
            long_context=req.long_context,
            moe=req.moe,
            batch_per_replica=req.batch_per_replica,
            seq_len=req.seq_len,
            global_batch=req.global_batch,
        )
        key = _workload_key(req)
        calibrated = False
        with self._lock:
            measured = self._measurements.get(key)
            if measured is None:
                # a restarted master serves calibrated rankings from
                # the durable history before any new reports arrive
                measured = self._measurements[key] = (
                    self._load_persisted(key)
                )
            if measured:
                planner = self._planners.get(key)
                if planner is None:
                    from dlrover_tpu_torch.accelerate.dim_planner import (
                        CalibratedPlanner,
                    )

                    planner = CalibratedPlanner(
                        profile,
                        batch_per_replica=req.batch_per_replica,
                        seq_len=req.seq_len,
                    )
                    planner.calibrate(list(measured))
                    self._planners[key] = planner
                calibrated = True
        if calibrated:
            cands = [s for s, _ in planner.rank(cands)]
        cands = cands[: req.max_candidates]
        return StrategyResponse(
            candidates=[_strategy_to_dict(s) for s in cands],
            calibrated=calibrated,
        )


def start_strategy_service(
    port: int = 0,
) -> Tuple[object, int]:
    """Start the service; returns (grpc server, port)."""
    port = port or get_free_port()
    brain = StrategyService()

    def report_fn(envelope):
        msg = deserialize_message(envelope.data)
        if isinstance(msg, StrategyMeasurement):
            brain.record(msg)
        return BoolResponse(success=True)

    def get_fn(envelope):
        req = deserialize_message(envelope.data)
        if isinstance(req, StrategyRequest):
            return brain.generate(req)
        return None

    server = build_master_server(port, report_fn, get_fn)
    server.start()
    logger.info("strategy service on port %d", port)
    return server, port


class StrategyClient:
    """Client side: profile in, ranked Strategy list out."""

    def __init__(self, addr: str):
        self._channel = MasterChannel(addr)

    def request_candidates(
        self,
        profile: ModelProfile,
        n_devices: int,
        batch_per_replica: int = 1,
        seq_len: int = 2048,
        global_batch: Optional[int] = None,
        long_context: bool = False,
        moe: bool = False,
    ) -> List[Strategy]:
        resp = self._channel.get(
            StrategyRequest(
                num_params=profile.num_params,
                param_bytes=profile.param_bytes,
                optimizer_bytes=profile.optimizer_bytes,
                activation_bytes_per_sample=(
                    profile.activation_bytes_per_sample
                ),
                num_layers=profile.num_layers,
                n_devices=n_devices,
                batch_per_replica=batch_per_replica,
                seq_len=seq_len,
                global_batch=global_batch,
                long_context=long_context,
                moe=moe,
            )
        )
        if resp is None:
            return []
        out = []
        for kw in resp.candidates:
            s = _strategy_from_dict(kw)
            if s is not None:
                out.append(s)
        return out

    def report_measurement(
        self,
        profile: ModelProfile,
        strategy: Strategy,
        step_time_s: float,
        batch_per_replica: int = 1,
        seq_len: int = 2048,
    ) -> bool:
        """Teach the service what this strategy actually cost."""
        return self._channel.report(
            StrategyMeasurement(
                num_params=profile.num_params,
                param_bytes=profile.param_bytes,
                optimizer_bytes=profile.optimizer_bytes,
                activation_bytes_per_sample=(
                    profile.activation_bytes_per_sample
                ),
                num_layers=profile.num_layers,
                batch_per_replica=batch_per_replica,
                seq_len=seq_len,
                strategy=_strategy_to_dict(strategy),
                step_time_s=step_time_s,
            )
        )

    def close(self):
        self._channel.close()
