"""Strategy-driven attention and layer execution: the module-replace
pass of the port.

Port of ``dlrover_tpu/accelerate/module_replace.py`` (``sp_kernel_choice``
:91, ``select_attention`` :108, ``select_layer_executor`` :187,
``_scan_layers``, ``_pipeline_executor`` :216-290 and
``_sp_under_shard_map`` :293-387).  The model's forward takes a
pluggable ``attention_fn`` and runs its stacked layers through an
executor; this pass picks both from the mesh:

- seq axis > 1: Ulysses (one all-to-all each way around the flash
  kernels) when the local head counts divide the axis, ring attention
  (the K/V chunks rotate, ``flash_attention_lse`` per block) otherwise;
  ``DLROVER_TPU_SP_KERNEL`` ("ring" / "ulysses") picks the algorithm;
- otherwise the flash kernels (their plain versions on the CPU: the
  device decides; there is no ``DLROVER_TPU_FLASH_ATTENTION`` switch,
  and the TPU tile knobs ``DLROVER_TPU_FLASH_BLOCKS`` and
  ``round_block_to_tile`` have no counterpart);
- pipe axis > 1: the GPipe executor (``parallel.pipeline``) over the
  stage's layers; otherwise a plain loop over the layers.

There is no ``shard_map`` here: each rank already holds its local
tensors (its heads under ``tensor``, its chunk of the sequence under
``seq``), so the head counts the attention sees are the local ones.
"""

import os
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.mesh import AxisName, MeshContext
from dlrover_tpu_torch.parallel.sharding import LogicalAxisRules

# "auto" | "ring" | "ulysses"
SP_KERNEL_ENV = "DLROVER_TPU_SP_KERNEL"


def sp_kernel_choice(seq_size: int, n_heads: int, n_kv_heads: int) -> str:
    """Which sequence-parallel attention to run: "ulysses" when both
    head counts divide the seq axis (one all-to-all exchanging seq and
    heads each way), "ring" otherwise (any head count).
    ``DLROVER_TPU_SP_KERNEL`` forces one."""
    env = os.getenv(SP_KERNEL_ENV, "auto").lower()
    if env in ("ring", "ulysses"):
        return env
    if n_heads % seq_size == 0 and n_kv_heads % seq_size == 0:
        return "ulysses"
    return "ring"


def select_attention(mesh_ctx: Optional[MeshContext],
                     rules: Optional[LogicalAxisRules],
                     inner: Optional[Callable] = None) -> Callable:
    """The attention for the current strategy, with the model's
    signature ``(q [B,S,H,D], k [B,S,KV,D], v, causal=True) ->
    [B,S,H,D]`` on the rank's local tensors.  ``inner`` is the attention
    over a whole sequence (default ``ops.flash_attention``), which
    Ulysses wraps."""
    if inner is None:
        from dlrover_tpu_torch.ops.flash_attention import flash_attention

        inner = flash_attention
    seq_size = mesh_ctx.axis_size(AxisName.SEQUENCE) if mesh_ctx else 1
    if seq_size <= 1 or rules is None:
        return inner
    return _sp_attention(mesh_ctx, inner)


def _sp_attention(mesh_ctx: MeshContext, inner_attention: Callable):
    """Sequence-parallel attention over the seq group: q, k, v are the
    rank's chunk of the sequence and its heads (already cut by tensor),
    so the local head counts decide Ulysses or ring."""
    from dlrover_tpu_torch.parallel.collectives import (
        ring_attention,
        ulysses_attention,
    )

    group = mesh_ctx.group(AxisName.SEQUENCE)
    seq_size = mesh_ctx.axis_size(AxisName.SEQUENCE)

    def attention(q, k, v, causal: bool = True):
        choice = sp_kernel_choice(seq_size, q.shape[2], k.shape[2])
        if choice == "ulysses":
            return ulysses_attention(q, k, v, group,
                                     inner_attention=inner_attention,
                                     causal=causal)
        return ring_attention(q, k, v, group, causal=causal)

    return attention


#: ``block(layer_params, x, *extras) -> x``; ``layers`` maps each leaf
#: name to its list of per-layer tensors
Block = Callable
Layers = Dict[str, List]


def select_layer_executor(mesh_ctx: Optional[MeshContext]) -> Callable:
    """How the model's stacked layers run: a plain loop, or the GPipe
    pipeline over the pipe axis when it has more than one stage.
    Executor signature ``(block, layers, x, *extras) -> x``."""
    pipe = mesh_ctx.axis_size(AxisName.PIPELINE) if mesh_ctx else 1
    if pipe <= 1:
        return _scan_layers
    return _pipeline_executor(mesh_ctx)


def _scan_layers(block: Block, layers: Layers, x, *extras):
    n = len(next(iter(layers.values())))
    for i in range(n):
        x = block({k: v[i] for k, v in layers.items()}, x, *extras)
    return x


def _pipeline_executor(mesh_ctx: MeshContext, schedule: str = "chunked"):
    """GPipe over the pipe axis: this rank's layers are its stage, the
    rank's rows go through in ``pipeline_microbatches`` microbatches
    (default 2 x stages).  The input is the same on every stage and only
    stage 0 reads it, so its gradient is summed over the stages (the
    transpose of the reference's replicated ``P()`` input)."""
    from dlrover_tpu_torch.parallel.collectives import copy_to
    from dlrover_tpu_torch.parallel.pipeline import (
        merge_microbatches,
        pipeline_spmd,
        split_microbatches,
    )

    n_stages = mesh_ctx.axis_size(AxisName.PIPELINE)
    num_mb = mesh_ctx.pipeline_microbatches or 2 * n_stages
    group = mesh_ctx.group(AxisName.PIPELINE)
    logger.debug("module_replace: GPipe executor, %d stages x %d "
                "microbatches", n_stages, num_mb)

    def execute(block: Block, layers: Layers, x, *extras):
        def stage_fn(stage_layers, x_mb):
            return _scan_layers(block, stage_layers, x_mb, *extras)

        mbs = split_microbatches(copy_to(x, group), num_mb)
        out = pipeline_spmd(stage_fn, layers, mbs, mesh_ctx,
                            schedule=schedule)
        return merge_microbatches(out)

    return execute
