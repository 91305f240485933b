"""One rank of a multi-axis gloo step on the CPU, driven by
``tests/test_torch_mixed_mesh.py`` and ``tests/test_torch_remat.py``.

    python tests/torch_mixed_mesh_worker.py <inputs.npz> <out_dir> <case>

with ``DLROVER_TPU_PROCESS_RANK``/``_COUNT``/``_COORDINATOR_ADDR`` set.
``case`` names a ``Strategy`` over the whole world and the model's
remat policy:

- ``mixed``: ``{pipe 2, fsdp 2, seq 2, tensor 2}`` (16 ranks), 2
  pipeline microbatches, ``LlamaConfig.tiny(n_heads=8, n_kv_heads=4,
  remat="none")``;
- ``p2t2dots``: ``{pipe 2, tensor 2}`` (4 ranks), 4 microbatches,
  ``LlamaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=4,
  remat="dots")``;
- ``hybrid8``: the hybrid mesh ``dcn {data 2} x ici {fsdp 2, tensor 2}``
  (8 ranks, two nodes of four by ``DLROVER_TPU_NODE_INDEX``),
  ``LlamaConfig.tiny(n_heads=8, n_kv_heads=4, remat="none")``; first
  in bf16 (the dry run's compute: one step, its loss in ``bf16_loss``),
  then in fp32;
- ``hybrid32``: ``dcn {data 2} x ici {pipe 2, fsdp 2, seq 2, tensor 2}``
  (32 ranks, two nodes of 16), 2 microbatches, the same model;
- ``one``: the same model on one device (``tests/test_torch_hybrid_mesh.py``
  calls ``run`` in its own process).

In fp32 from the params in ``inputs.npz`` (``p/<leaf>``), through
``auto_accelerate``, AGD(lr=1e-3), a step per global batch of
``batches`` (every rank feeds its rows): rank 0 writes the losses and
grad norms and the reassembled params to ``<out_dir>/<case>.pt``.
Imports torch and the port only.
"""

import collections
import contextlib
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

CASES = {
    "mixed": (dict(pipe=2, fsdp=2, seq=2, tensor=2, pipe_microbatches=2),
              dict(n_heads=8, n_kv_heads=4, remat="none")),
    "p2t2dots": (dict(pipe=2, tensor=2, pipe_microbatches=4),
                 dict(n_heads=8, n_kv_heads=4, n_layers=4, remat="dots")),
    "hybrid8": (dict(data=2, fsdp=2, tensor=2, extras=(("dcn", ("data",)),)),
                dict(n_heads=8, n_kv_heads=4, remat="none")),
    "one": (dict(), dict(n_heads=8, n_kv_heads=4, remat="none")),
    "hybrid32": (dict(data=2, pipe=2, fsdp=2, seq=2, tensor=2,
                      pipe_microbatches=2, extras=(("dcn", ("data",)),)),
                 dict(n_heads=8, n_kv_heads=4, remat="none")),
}


class _CountProducts(TorchDispatchMode):
    """Counts the ``aten.mm`` calls that reach it into
    ``counts[key]``."""

    def __init__(self, counts, key: str):
        super().__init__()
        self.counts, self.key = counts, key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.counts[self.key] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _within(outer, inner):
    with outer, inner:
        yield


@contextlib.contextmanager
def counting_dots(llama):
    """``llama._dots_contexts`` wrapped for the block: a Counter of the
    projection products each dots checkpoint sees, ``saved`` (run and
    kept in its forward) and ``replayed`` (handed back from its cache in
    the recompute, not run).  The counting mode is entered above the
    selective checkpoint's own, so it sees what the cache hands back."""
    counts = collections.Counter()
    contexts = llama._dots_contexts

    def counted():
        forward, recompute = contexts()
        return (_within(forward, _CountProducts(counts, "saved")),
                _within(recompute, _CountProducts(counts, "replayed")))

    llama._dots_contexts = counted
    try:
        yield counts
    finally:
        llama._dots_contexts = contexts


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _paths(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def run(case, z, out_dir, rank, dtype=torch.float32, steps=None,
        save=True):
    from dlrover_tpu_torch.accelerate import Strategy, auto_accelerate
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.parallel.collectives import all_gather_dim
    from dlrover_tpu_torch.parallel.mesh import destroy_parallel_mesh
    from dlrover_tpu_torch.parallel.train_step import param_leaves

    sizes, model = CASES[case]
    flat = {k[2:]: z[k] for k in z.files if k.startswith("p/")}

    def init_fn(gen, dev):
        out = {"layers": {}}
        for k, v in flat.items():
            # a fresh tensor each call: the optimizer updates in place
            t = (torch.empty(v.shape, device=dev) if dev.type == "meta"
                 else torch.tensor(v, device=dev))
            if k.startswith("layers/"):
                out["layers"][k[len("layers/"):]] = t
            else:
                out[k] = t
        return out

    cfg = tl.LlamaConfig.tiny(dtype=dtype, **model)
    result = auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=init_fn,
        param_axes=tl.param_logical_axes(cfg),
        load_strategy=Strategy(**sizes),
        device="cpu")
    fns, ctx = result.fns, result.mesh_ctx
    st = fns.init_state(0)
    metrics = []
    with counting_dots(tl) as dots_counts:
        for b in z["batches"][:steps]:
            local = fns.batch_sharding.local({"tokens": b})
            st, m = fns.train_step(
                st, {k: torch.from_numpy(v) for k, v in local.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    full = {}
    with torch.no_grad():
        for (path, t), p in zip(_paths(st["params"]),
                                param_leaves(fns.placements)):
            t = t.detach()
            for shard in p.shards:
                t = all_gather_dim(t, shard.dim, ctx.group(shard.axis))
            full[path] = t.clone()
    destroy_parallel_mesh(ctx)
    if rank == 0 and save:
        torch.save({"metrics": metrics, "params": full,
                    "dims": dict(ctx.dims),
                    "dots_counts": dict(dots_counts)},
                   os.path.join(out_dir, f"{case}.pt"))
    return metrics


def main(inputs: str, out_dir: str, case: str):
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist

    from dlrover_tpu_torch.trainer.elastic.context import (
        init_distributed,
        shutdown_distributed,
    )

    z = np.load(inputs)
    ctx = init_distributed("cpu")
    if case == "hybrid8":
        # the dry run's compute first: its loss is the recorded one
        bf16 = run(case, z, out_dir, ctx.rank, dtype=torch.bfloat16,
                   steps=1, save=False)
        if ctx.rank == 0:
            torch.save(bf16[0][0], os.path.join(out_dir, "bf16_loss.pt"))
    run(case, z, out_dir, ctx.rank)
    dist.barrier()
    shutdown_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:4])
