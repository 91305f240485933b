"""Strategy representation + candidate generation.

Copy of ``dlrover_tpu/accelerate/strategy.py``.  The port reads one
entry of ``Strategy.extras``, ``("dcn", axes)``: the axes a hybrid mesh
lays across nodes.

Reference parity: ``atorch/atorch/auto/strategy.py:4`` (``Strategy`` =
ordered opt-method list), ``auto/engine/optimization_method.py``
(candidate generation) and the semi-auto ``load_strategy`` path of
``auto_accelerate`` (``auto/accelerate.py:406``).

A TPU strategy is fully described by (mesh dims, rule flags, remat,
micro-steps) — there is no module surgery; candidates are mesh
factorizations that pass the memory-fit model, ranked by a simple
cost model and optionally re-ranked by a timed dry run.
"""

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.accelerate.analyser import ModelProfile, fits_in_memory
from dlrover_tpu_torch.parallel.mesh import AxisName


@dataclass(frozen=True)
class Strategy:
    """One parallelization plan."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1
    remat: str = "full"
    num_micro_steps: int = 1
    # GPipe microbatch count when pipe > 1 (0 -> auto: 2 x pipe)
    pipe_microbatches: int = 0
    # ``(("dcn", (axis, ...)),)``: the axes a hybrid mesh lays across
    # nodes (``parallel.mesh.create_hybrid_parallel_mesh``, outermost, in
    # that order); the others stay inside a node
    extras: Tuple = ()

    @property
    def n_devices(self) -> int:
        return (
            self.data
            * self.fsdp
            * self.tensor
            * self.seq
            * self.expert
            * self.pipe
        )

    def mesh_dims(self) -> List[Tuple[str, int]]:
        return [
            (AxisName.PIPELINE, self.pipe),
            (AxisName.DATA, self.data),
            (AxisName.FSDP, self.fsdp),
            (AxisName.EXPERT, self.expert),
            (AxisName.SEQUENCE, self.seq),
            (AxisName.TENSOR, self.tensor),
        ]

    def rule_flags(self) -> Dict[str, bool]:
        return {
            "fsdp": self.fsdp > 1,
            "tensor_parallel": self.tensor > 1,
            "sequence_parallel": self.seq > 1,
            "expert_parallel": self.expert > 1,
            "pipeline": self.pipe > 1,
        }

    def describe(self) -> str:
        parts = [
            f"{k}={v}"
            for k, v in [
                ("dp", self.data),
                ("fsdp", self.fsdp),
                ("tp", self.tensor),
                ("sp", self.seq),
                ("ep", self.expert),
                ("pp", self.pipe),
            ]
            if v > 1
        ]
        return "x".join(parts) if parts else "single-device"


def load_strategy(config: Dict) -> Strategy:
    """Semi-auto: user supplies the plan (reference ``load_strategy``)."""
    return Strategy(**config)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


# coarse v5e-class hardware constants for RANKING (not prediction):
# only the ordering of candidates matters, so absolute calibration is
# irrelevant as long as the compute/comm ratio is in the right regime
_PEAK_FLOPS = 197e12
_ICI_BW = 4.5e10  # bytes/sec one direction, per link


# ordered addends of the step-cost model; the calibrated dim planner
# (accelerate/dim_planner.py) fits a per-term coefficient to each
FEATURE_NAMES = (
    "compute",
    "dp_reduce",
    "fsdp_gather",
    "tp_reduce",
    "pipe_hop",
    "sp_hop",
    "ep_hop",
)


def strategy_cost_terms(
    s: Strategy,
    profile: ModelProfile,
    batch_per_replica: int = 1,
    seq_len: int = 2048,
) -> List[float]:
    """Per-term second estimates, ordered as ``FEATURE_NAMES``:

    - compute: 6N FLOPs/token shard, scaled by the GPipe bubble
      (1 + (P-1)/M) when pipe > 1
    - DP/FSDP grad reduce: ~2x grad bytes over ICI when dp*fsdp > 1
    - FSDP param all-gathers: ~2x param bytes more (fwd + bwd)
    - TP: per-layer activation reductions (4 per layer, bf16)
    - pipe: stage-boundary activation hops (every microbatch crosses
      P-1 boundaries forward and backward)
    - seq/expert: all-to-all / ring hops on activations
    """
    # fixed global token count (pure-DP framing: per-device batch x
    # devices); any constant works — only the ordering matters
    global_tokens = batch_per_replica * seq_len * max(s.n_devices, 1)
    model_shard = max(s.tensor * s.pipe, 1)
    compute = (
        6.0 * profile.num_params * global_tokens
        / max(s.n_devices, 1) / _PEAK_FLOPS
    )
    if s.pipe > 1:
        micro = s.pipe_microbatches or 2 * s.pipe
        compute *= 1.0 + (s.pipe - 1) / max(micro, 1)
    tokens = batch_per_replica * seq_len  # per-device activation traffic

    grad_bytes = profile.num_params * 4.0 / model_shard
    # one layer-boundary activation tensor [tokens, hidden] in bf16:
    # the whole-model census is ~7 live tensors per layer, so divide
    # it back out; floor at a 1k-hidden model
    hidden_bytes = max(
        profile.activation_bytes_per_sample
        / max(seq_len, 1) / max(profile.num_layers, 1) / 7.0,
        2.0 * 1024,
    )
    act_bytes = tokens * hidden_bytes

    terms = [compute, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    if s.data * s.fsdp > 1:
        terms[1] = 2.0 * grad_bytes / _ICI_BW
    if s.fsdp > 1:
        terms[2] = 2.0 * profile.num_params * 4.0 / model_shard / _ICI_BW
    if s.tensor > 1:
        terms[3] = 4.0 * max(profile.num_layers, 1) * act_bytes / _ICI_BW
    if s.pipe > 1:
        terms[4] = 4.0 * (s.pipe - 1) / s.pipe * act_bytes / _ICI_BW
    if s.seq > 1:
        terms[5] = 2.0 * s.seq * act_bytes / _ICI_BW
    if s.expert > 1:
        terms[6] = 2.0 * act_bytes / _ICI_BW
    return terms


def estimate_step_cost(
    s: Strategy,
    profile: ModelProfile,
    batch_per_replica: int = 1,
    seq_len: int = 2048,
) -> float:
    """Relative per-step wall-clock estimate for ranking candidates
    (reference role: the Brain's throughput model + the MIP planner's
    objective, ``mip_tp_planner.py:496``, collapsed to the terms that
    matter on a TPU mesh — see :func:`strategy_cost_terms`).

    Configs are compared at a FIXED global batch (the user's effective
    batch): per-token compute is then identical across factorizations
    (6N/n_devices per device), so the ranking is decided by what each
    strategy ADDS."""
    return float(
        sum(strategy_cost_terms(s, profile, batch_per_replica, seq_len))
    )


def generate_candidates(
    profile: ModelProfile,
    n_devices: int,
    max_tensor: int = 8,
    long_context: bool = False,
    moe: bool = False,
    batch_per_replica: int = 1,
    seq_len: int = 2048,
    global_batch: Optional[int] = None,
) -> List[Strategy]:
    """Mesh factorizations that fit memory, ranked by the workload
    cost model (:func:`estimate_step_cost` — compute shard + grad
    reduce + FSDP gathers + TP reductions + pipe bubble, evaluated at
    the actual batch/seq).

    A factorization whose activations overflow at micro_steps=1 is
    retried with gradient accumulation (2/4/8 micro steps) — the
    reference searches micro-batching as part of the strategy space,
    not as a user afterthought.

    With ``global_batch`` set, factorizations whose batch sharding
    (data x fsdp) doesn't divide it are dropped (they'd fail at the
    first ``device_put``) and each candidate's MEMORY fit is evaluated
    at ITS OWN per-device batch (``global_batch / (data*fsdp)``).
    The cost RANKING keeps a
    constant per-device basis (``global_batch / n_devices``): the
    model's compute term assumes a fixed global batch, and feeding
    each candidate its own bpd would charge model-parallel plans
    tensor*pipe-times the compute of data-parallel ones."""
    if global_batch is not None and global_batch < 1:
        raise ValueError(
            f"global_batch must be >= 1, got {global_batch}"
        )
    rank_bpr = (
        global_batch / n_devices
        if global_batch is not None
        else batch_per_replica
    )
    candidates = []
    for tensor, fsdp_d, pipe in itertools.product(
        _divisors(n_devices), _divisors(n_devices), (1, 2, 4)
    ):
        if tensor > max_tensor:
            continue
        if n_devices % (tensor * fsdp_d * pipe) != 0:
            continue
        if pipe > 1 and (
            profile.num_layers == 0 or profile.num_layers % pipe != 0
        ):
            # stage dim must split a detected layer stack evenly; with
            # no stack (num_layers=0) the LAYERS->PIPELINE rule shards
            # nothing, so the pipe memory fold would be fictitious
            continue
        rest = n_devices // (tensor * fsdp_d * pipe)
        seq = 1
        expert = 1
        if long_context and rest % 2 == 0 and rest > 1:
            seq = 2
            rest //= 2
        if moe and rest % 2 == 0 and rest > 1:
            expert = 2
            rest //= 2
        batch_shard = rest * fsdp_d  # batch dim shards over data x fsdp
        if global_batch is not None:
            if global_batch % batch_shard != 0:
                continue  # would fail at the first device_put
            bpd = global_batch // batch_shard
        else:
            bpd = batch_per_replica
        for micro in (1, 2, 4, 8):
            # micro | bpd also guarantees the accumulation reshape's
            # global divisibility: global = bpd * batch_shard
            if micro > 1 and bpd % micro != 0:
                continue
            fits, util = fits_in_memory(
                profile,
                n_devices,
                fsdp=fsdp_d,
                tensor=tensor,
                batch_per_device=bpd,
                pipe=pipe,
                micro_steps=micro,
            )
            if fits:
                s = Strategy(
                    data=rest,
                    fsdp=fsdp_d,
                    tensor=tensor,
                    seq=seq,
                    expert=expert,
                    pipe=pipe,
                    num_micro_steps=micro,
                )
                candidates.append((s, util))
                break  # smallest micro count that fits wins

    # rank by modeled step time at the CONSTANT per-device basis
    # rank_bpr = global_batch / n_devices (memory fit above used each
    # candidate's own per-device batch); ranking at per-candidate
    # batches would charge model-parallel plans tensor*pipe-times the
    # compute of data-parallel ones — see
    # test_global_batch_keeps_model_parallel_competitive.  Memory
    # utilization breaks ties.
    candidates.sort(
        key=lambda su: (
            estimate_step_cost(su[0], profile, rank_bpr, seq_len),
            su[1],
        )
    )
    seen = set()
    unique = []
    for s, _ in candidates:
        key = (s.data, s.fsdp, s.tensor, s.seq, s.expert, s.pipe)
        if key not in seen:
            seen.add(key)
            unique.append(s)
    return unique
