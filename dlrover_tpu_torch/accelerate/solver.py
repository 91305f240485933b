"""Joint constraint solver over (mesh × remat × microbatch × tiles).

Copy of ``dlrover_tpu/accelerate/solver.py``.

Reference parity: ``atorch/atorch/auto/opt_lib/shard_planners/
mip_tp_planner.py:496`` — a MIP over operator placement + resource
constraints.  On TPU, GSPMD already solves op placement, so the joint
decision that remains is the one the bench is hand-tuned over today:

    mesh factorization × remat policy × micro-batch count
    × flash-attention tile shape

under a per-device HBM model and a VMEM model for the kernel tiles.
The space is tiny (≈10^3–10^4 points after pruning), so the "MIP" is
an exact pruned-exhaustive solve — deterministic, dependency-free, and
auditable, which a real ILP encoding of the same objective would not
be.  The objective reuses the calibrated per-term cost model
(``dim_planner.CalibratedPlanner`` fits its coefficients from timed
dry runs), extended with remat recompute and an attention HBM-traffic
term, so measurements improve the solve the same way they improve
plain ranking.

Validation anchor (tests + chip): for the v5e bench workload
(llama-0.6b, batch 8, seq 2048, one 16 GB chip) the solver must
reproduce the measured-best hand tuning from its model alone:
``remat=dots`` (none does not fit, full recomputes more), micro=1,
flash tiles 1024×512 (block_q = seq/2 keeps ≥2 pipeline steps per
(batch, head) grid row; block_kv = block_q/2 halves the bwd
accumulation conflict window; both bounded by VMEM).
"""

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.accelerate.analyser import (
    ModelProfile,
    device_memory_bytes,
)
from dlrover_tpu_torch.accelerate.strategy import (
    Strategy,
    generate_candidates,
    strategy_cost_terms,
)

# remat policy -> (retained-activation fraction, step-FLOP multiplier).
# fwd:bwd ≈ 1:2; full remat re-runs the forward (+1/3 of step FLOPs),
# "dots" recomputes only matmul/attention internals (~half the fwd)
# while keeping ~35% of activation bytes resident (norms + boundaries).
REMAT_POLICIES: Dict[str, Tuple[float, float]] = {
    "none": (1.00, 1.0),
    "dots": (0.35, 1.0 + 1.0 / 6.0),
    "full": (0.08, 1.0 + 1.0 / 3.0),
}

# v5e-class VMEM budget available to one kernel's working set (the
# hardware has ~128 MiB; Mosaic reserves space for double buffering
# and spills — beyond ~half, compilation degrades or fails)
DEFAULT_VMEM_BUDGET = 64 * (1 << 20)


@dataclass(frozen=True)
class JointPlan:
    """One point of the joint space (what the bench hand-tunes)."""

    strategy: Strategy
    remat: str
    block_q: int
    block_kv: int
    predicted_step_s: float
    memory_utilization: float

    def describe(self) -> Dict:
        return {
            "mesh": {
                "data": self.strategy.data,
                "fsdp": self.strategy.fsdp,
                "tensor": self.strategy.tensor,
                "seq": self.strategy.seq,
                "expert": self.strategy.expert,
                "pipe": self.strategy.pipe,
            },
            "micro_steps": self.strategy.num_micro_steps,
            "remat": self.remat,
            "flash_tiles": [self.block_q, self.block_kv],
            "predicted_step_s": round(self.predicted_step_s, 4),
            "memory_utilization": round(self.memory_utilization, 3),
        }


@dataclass(frozen=True)
class OffloadGroupPlan:
    """Grouped-backward plan for the host-offload path: how many
    backward passes per step (``n_groups``) and where the stacked
    layer dim splits (``boundaries`` — the ``init_ngrouped_params``
    input)."""

    n_groups: int
    boundaries: Tuple[int, ...]
    group_params: Tuple[int, ...]
    predicted_peak_bytes: int
    budget_bytes: int

    def describe(self) -> Dict:
        return {
            "n_groups": self.n_groups,
            "boundaries": list(self.boundaries),
            "group_params_m": [
                round(p / 1e6, 1) for p in self.group_params
            ],
            "predicted_peak_gb": round(
                self.predicted_peak_bytes / 1e9, 2
            ),
            "budget_gb": round(self.budget_bytes / 1e9, 2),
        }


def balanced_boundaries(
    layer_params: Sequence[int],
    n_groups: int,
    embed_params: int = 0,
    head_params: int = 0,
) -> Tuple[int, ...]:
    """Layer split points giving ``n_groups`` contiguous segments of
    near-equal parameter weight.  ``embed_params``/``head_params``
    are charged to the first/last layer (group 0 carries the
    embedding, the last group the lm head — the
    ``loss_fn_ngrouped`` contract), so a heavy head pushes the last
    boundary earlier instead of silently unbalancing the tail
    group.  Handles odd (non-divisible) layer counts; every group
    keeps at least one layer."""
    n_layers = len(layer_params)
    if not 1 <= n_groups <= n_layers:
        raise ValueError(
            f"cannot split {n_layers} layers into {n_groups} groups"
        )
    weights = [float(w) for w in layer_params]
    weights[0] += float(embed_params)
    weights[-1] += float(head_params)
    total = sum(weights)
    cum = [0.0]
    for w in weights:
        cum.append(cum[-1] + w)
    bounds: List[int] = []
    prev = 0
    for k in range(1, n_groups):
        target = total * k / n_groups
        lo = prev + 1
        hi = n_layers - (n_groups - k)  # leave >=1 layer per group
        best = min(
            range(lo, hi + 1), key=lambda b: abs(cum[b] - target)
        )
        bounds.append(best)
        prev = best
    return tuple(bounds)


def solve_offload_groups(
    profile: ModelProfile,
    batch_per_replica: int = 1,
    remat: str = "full",
    headroom: float = 0.85,
    max_groups: int = 8,
    hbm_bytes: Optional[int] = None,
    layer_params: Optional[Sequence[int]] = None,
    embed_params: int = 0,
    head_params: int = 0,
    transient_bytes: int = 768 << 20,
) -> OffloadGroupPlan:
    """Pick the grouped-backward split for the host-offload path.

    The offloaded step's HBM peak is ``bf16 params + retained
    activations + ONE group's bf16 dW tree + the chunk-stream
    transient`` — the dW term is the only one N shrinks, so the solve
    is: smallest N whose balanced split fits the budget (every extra
    group costs a full extra backward pass, so more groups than
    needed is pure slowdown).  ``layer_params`` is the per-layer
    parameter count (uniform split of the stacked params by default);
    ``embed_params``/``head_params`` weight the first/last groups the
    way ``loss_fn_ngrouped`` assigns the unstacked leaves.  Raises
    ``ValueError`` when even ``max_groups`` does not fit."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    budget = float(hbm_bytes or device_memory_bytes()) * headroom
    act_frac = REMAT_POLICIES[remat][0]
    acts = (
        profile.activation_bytes_per_sample
        * batch_per_replica
        * act_frac
    )
    n_layers = max(profile.num_layers, 1)
    if layer_params is None:
        stacked = max(
            profile.num_params - embed_params - head_params, 0
        )
        layer_params = [stacked / n_layers] * n_layers
    resident = 2.0 * profile.num_params + acts + transient_bytes
    peak = None
    for n in range(1, min(max_groups, len(layer_params)) + 1):
        bounds = balanced_boundaries(
            layer_params, n, embed_params, head_params
        )
        edges = [0, *bounds, len(layer_params)]
        group_params = []
        for lo, hi in zip(edges, edges[1:]):
            w = sum(layer_params[lo:hi])
            if lo == 0:
                w += embed_params
            if hi == len(layer_params):
                w += head_params
            group_params.append(int(w))
        peak = resident + 2.0 * max(group_params)
        if peak <= budget:
            return OffloadGroupPlan(
                n_groups=n,
                boundaries=bounds,
                group_params=tuple(group_params),
                predicted_peak_bytes=int(peak),
                budget_bytes=int(budget),
            )
    raise ValueError(
        f"no grouped split fits: {max_groups} groups still need "
        f"{(peak or resident) / 1e9:.2f} GB of "
        f"{budget / 1e9:.2f} GB"
    )


def strategy_device_count(strategy: Strategy) -> int:
    """Devices a strategy's mesh factorization consumes."""
    return (
        strategy.data
        * strategy.fsdp
        * strategy.tensor
        * strategy.seq
        * strategy.expert
        * strategy.pipe
    )


def resolve_for_world(
    profile: ModelProfile,
    n_devices: int,
    batch_per_replica: int,
    seq_len: int,
    prior: Optional[Strategy] = None,
    **solve_kwargs,
) -> JointPlan:
    """Re-solve the parallelism strategy for a CHANGED device count
    (the elastic re-mesh: a preempted host shrank the world, or a
    replacement grew it back).

    The prior strategy's tunables are preserved where still legal —
    the calibration that picked them came from measurements of this
    very workload — but the mesh factorization is re-solved from
    scratch: a strategy sized for 8 hosts is structurally illegal on
    4 (its mesh product no longer matches), and even legal survivors
    may be far from optimal at the new scale.  Returns the best
    :class:`JointPlan` for the new world; raises ``ValueError`` when
    nothing fits (the job genuinely cannot run at this size — better
    a loud scheduling failure than an OOM loop)."""
    if prior is not None:
        solve_kwargs.setdefault(
            "pipe_microbatches", prior.pipe_microbatches
        )
        if prior.expert > 1:
            solve_kwargs.setdefault("moe", True)
    plans = solve(
        profile,
        n_devices,
        batch_per_replica,
        seq_len,
        top_k=1,
        **solve_kwargs,
    )
    best = plans[0]
    if prior is not None:
        from dlrover_tpu_torch.common.log import default_logger

        default_logger.info(
            "world change re-solve: %s devices -> mesh %s (was "
            "data=%s fsdp=%s tensor=%s seq=%s expert=%s pipe=%s "
            "for %s devices)",
            n_devices, best.describe()["mesh"], prior.data,
            prior.fsdp, prior.tensor, prior.seq, prior.expert,
            prior.pipe, strategy_device_count(prior),
        )
    return best


def candidate_tiles(
    seq_len: int,
    head_dim: int = 128,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
) -> List[Tuple[int, int]]:
    """Feasible (block_q, block_kv) pairs.

    Constraints (each encodes a hardware fact, not a fit-to-answer):
    - blocks are multiples of 128 covering the sequence evenly;
    - ≥2 q-blocks per (batch, head) grid row: with one q block the
      kernel's KV stream cannot overlap the next row's prologue
      (block_q ≤ seq/2) — validated on chip: forcing 2048×512 at
      seq 2048 measures 0.521 MFU vs 0.530 at 1024×512 (r4);
    - bwd VMEM working set fits the budget: two bq×bk f32 score/
      dscore tiles + ~7 tile×head_dim f32 operands (q, k, v, o, do,
      dq, partial dk/dv);
    - block_kv ≤ block_q/2 (when blocks are big enough to halve):
      the bwd accumulates dk/dv across the whole q loop, so each kv
      block's accumulator stays live for the full pass — halving the
      kv block halves that conflict window, measured faster on v5e
      than square tiles at every size ≥256 (r3 tile sweep).
    """
    sizes = [s for s in (128, 256, 512, 1024, 2048) if s <= seq_len]
    out = []
    for bq, bk in itertools.product(sizes, sizes):
        if seq_len % bq or seq_len % bk:
            continue
        if seq_len >= 256 and seq_len // bq < 2:
            continue
        if bk > max(bq // 2, 128):
            continue
        scores = 2 * bq * bk * 4
        operands = 4 * (5 * bq * head_dim + 2 * bk * head_dim)
        if scores + operands > vmem_budget:
            continue
        out.append((bq, bk))
    return out


def attention_traffic_s(
    bq: int,
    bk: int,
    batch: int,
    seq_len: int,
    n_heads: int,
    n_layers: int,
    head_dim: int = 128,
    hbm_gbps: float = 800.0,
) -> float:
    """HBM seconds spent re-streaming K/V per step: every q block
    reads the (causal) half of the KV sequence, so traffic scales
    with seq/bq; the bwd re-streams similarly with roles swapped
    (seq/bk).  This is the term that makes tiny tiles slow."""
    kv_bytes = 2 * seq_len * head_dim * 2  # K+V, bf16
    q_passes = seq_len / bq  # fwd: each q block streams ~S/2 of KV
    kv_passes = seq_len / bk  # bwd: each kv block streams the q side
    per_head = kv_bytes * 0.5 * (q_passes + kv_passes)
    total = per_head * n_heads * batch * n_layers
    return total / (hbm_gbps * 1e9)


def solve(
    profile: ModelProfile,
    n_devices: int,
    batch_per_replica: int,
    seq_len: int,
    n_heads: int = 16,
    head_dim: int = 128,
    global_batch: Optional[int] = None,
    long_context: bool = False,
    moe: bool = False,
    weights: Optional[Sequence[float]] = None,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
    headroom: float = 0.85,
    top_k: int = 5,
    pipe_microbatches: int = 0,
) -> List[JointPlan]:
    """Exact solve over the pruned joint space; best plan first.

    ``weights``: calibrated per-term coefficients from
    ``CalibratedPlanner.calibrate`` (None = analytic prior) — the
    solver and the measured calibration share one objective.

    ``pipe_microbatches``: the GPipe microbatch count the job will
    actually run (``MeshContext.pipeline_microbatches``); 0 keeps the
    module_replace auto default of ``2*pipe``.  The activation
    residency of pipe>1 candidates scales with it.
    """
    hbm = device_memory_bytes() * headroom
    w = (
        np.ones(7)
        if weights is None
        else np.asarray(weights, dtype=float)
    )
    # tile feasibility depends on the PER-DEVICE sequence: a
    # seq-sharded strategy's kernel sees seq_len / s.seq, and tiles
    # legal globally can violate the >=2-q-blocks rule locally
    tiles_by_seq: Dict[int, List[Tuple[int, int]]] = {}

    def tiles_for(local_seq: int) -> List[Tuple[int, int]]:
        if local_seq not in tiles_by_seq:
            tiles_by_seq[local_seq] = candidate_tiles(
                local_seq, head_dim, vmem_budget
            )
        return tiles_by_seq[local_seq]

    if not tiles_for(seq_len):
        raise ValueError(
            f"no feasible flash tile for seq_len={seq_len} under "
            f"vmem_budget={vmem_budget}"
        )
    # mesh × micro candidates from the shared generator.  Its internal
    # memory gate assumes FULL resident activations (remat=none); a
    # profile copy with activations scaled to the strongest remat
    # keeps remat-rescuable candidates alive — the solver's own
    # per-policy gate below does the real pruning.
    min_act_frac = min(f for f, _ in REMAT_POLICIES.values())
    permissive = dataclasses.replace(
        profile,
        activation_bytes_per_sample=int(
            profile.activation_bytes_per_sample * min_act_frac
        ),
    )
    mesh_cands = generate_candidates(
        permissive,
        n_devices,
        long_context=long_context,
        moe=moe,
        batch_per_replica=batch_per_replica,
        seq_len=seq_len,
        global_batch=global_batch,
    )
    plans: List[JointPlan] = []
    expanded: List[Strategy] = []
    seen_keys = set()
    for s0 in mesh_cands:
        batch_shard = max(s0.data * s0.fsdp, 1)
        bpd0 = (
            global_batch // batch_shard
            if global_batch is not None
            else batch_per_replica
        )
        # the generator keeps only the SMALLEST fitting micro count;
        # the joint solve re-opens the micro axis — accumulation can
        # rescue a cheaper remat policy (none/dots) that the smallest
        # micro cannot hold
        for m in (1, 2, 4, 8):
            if m < s0.num_micro_steps or (m > 1 and bpd0 % m):
                continue
            s = dataclasses.replace(
                s0,
                num_micro_steps=m,
                # stamp the configured GPipe depth so the residency
                # estimate below tracks what the executor will run
                pipe_microbatches=(
                    pipe_microbatches
                    if s0.pipe > 1 and pipe_microbatches
                    else s0.pipe_microbatches
                ),
            )
            key = (
                s.data, s.fsdp, s.tensor, s.seq, s.expert, s.pipe,
                s.num_micro_steps, s.pipe_microbatches,
            )
            if key not in seen_keys:
                seen_keys.add(key)
                expanded.append(s)
    for s in expanded:
        shard = max(s.fsdp * s.tensor * s.pipe, 1)
        batch_shard = max(s.data * s.fsdp, 1)
        if global_batch is not None:
            bpd = global_batch // batch_shard
        else:
            bpd = batch_per_replica
        base_terms = np.asarray(
            strategy_cost_terms(
                s, profile, batch_per_replica, seq_len
            )
        )
        state = profile.train_state_bytes() / shard
        if s.num_micro_steps > 1:
            state += profile.num_params * 4.0 / shard
        full_acts = (
            profile.activation_bytes_per_sample
            * bpd
            / max(s.num_micro_steps, 1)
        )
        if s.pipe > 1:
            # chunked-1F1B pipeline executor (parallel/pipeline.py):
            # a stage holds only ITS layer shard's activations
            # (1/pipe) for a window of `pipe` in-flight microbatches
            # out of the num_mb-deep stream — residency is
            # act * (pipe/num_mb) * (1/pipe) = act/num_mb.  num_mb is
            # the strategy's ACTUAL microbatch count (0 = the
            # module_replace auto default of 2*pipe); hard-coding
            # 2*pipe made the memory estimate wrong by the ratio for
            # any other configured count.
            num_mb = s.pipe_microbatches or 2 * s.pipe
            full_acts /= float(num_mb)
        # accumulation is not free: every extra micro step re-reads
        # and re-writes the fp32 grad_sum (8 bytes/param over HBM) and
        # fragments the fused backward
        accum_s = (
            8.0
            * (profile.num_params / shard)
            * (s.num_micro_steps - 1)
            / (800.0 * 1e9)
        )
        for remat, (act_frac, flop_mult) in REMAT_POLICIES.items():
            used = state + full_acts * act_frac
            if used > hbm:
                continue
            terms = base_terms.copy()
            terms[0] *= flop_mult  # recompute lands on the compute term
            base_s = float(terms @ w) + accum_s
            local_seq = seq_len // max(s.seq, 1)
            # per-DEVICE attention traffic: heads shard over tensor,
            # layers over pipe, sequence over seq (charging unsharded
            # totals would overbill model-parallel plans by
            # tensor*pipe against the already-sharded compute terms)
            model_shard = max(s.tensor * s.pipe, 1)
            for bq, bk in tiles_for(local_seq):
                t = base_s + attention_traffic_s(
                    bq,
                    bk,
                    bpd,
                    local_seq,
                    n_heads,
                    profile.num_layers or 1,
                    head_dim,
                ) / model_shard
                plans.append(
                    JointPlan(
                        strategy=s,
                        remat=remat,
                        block_q=bq,
                        block_kv=bk,
                        predicted_step_s=t,
                        memory_utilization=used / hbm,
                    )
                )
    if not plans:
        raise ValueError(
            "no (mesh, remat, micro) point fits device memory"
        )
    plans.sort(key=lambda p: (p.predicted_step_s, p.memory_utilization))
    # one best tile/remat per strategy first, then runners-up: the
    # caller usually dry-runs the top few DISTINCT meshes
    seen = set()
    unique: List[JointPlan] = []
    rest: List[JointPlan] = []
    for p in plans:
        key = (
            p.strategy.data, p.strategy.fsdp, p.strategy.tensor,
            p.strategy.seq, p.strategy.expert, p.strategy.pipe,
            p.strategy.num_micro_steps,
        )
        if key in seen:
            rest.append(p)
        else:
            seen.add(key)
            unique.append(p)
    return (unique + rest)[:top_k]
