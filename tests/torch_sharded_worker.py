"""One rank of the port's sharded train step on the CPU (gloo), driven by
``tests/test_torch_parallel.py``.

    python tests/torch_sharded_worker.py <inputs.npz> <out_dir> <meshes>

with ``DLROVER_TPU_PROCESS_RANK``/``_COUNT``/``_COORDINATOR_ADDR`` set:
for each ``data x fsdp`` mesh of ``meshes`` (``2x2,4x1,1x4``) it builds
``auto_accelerate`` over ``LlamaConfig.tiny`` in fp32 from the params in
``inputs.npz``, takes a step per global batch there (its rows only), and
rank 0 writes the losses, grad norms, the reassembled params and the
gathers of the last step to ``<out_dir>/<mesh>.pt``.  Each rank also
writes its own slices and placements (``<mesh>_rank<r>.pt``).  Imports
torch and the port only.
"""

import os
import sys

import numpy as np
import torch


def main(inputs: str, out_dir: str, meshes: str):
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist

    from dlrover_tpu_torch.accelerate import Strategy, auto_accelerate
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD, QuantizedMoments
    from dlrover_tpu_torch.parallel.collectives import all_gather_dim
    from dlrover_tpu_torch.parallel.mesh import AxisName
    from dlrover_tpu_torch.parallel.train_step import param_leaves
    from dlrover_tpu_torch.trainer.elastic.context import (
        shutdown_distributed,
    )

    z = np.load(inputs)
    batches = z["batches"]
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

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat="full")
    rank = int(os.environ["DLROVER_TPU_PROCESS_RANK"])
    for mesh in meshes.split(","):
        data, fsdp = (int(v) for v in mesh.split("x"))
        result = auto_accelerate(
            loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
            optimizer=lambda ps: AGD(ps, lr=1e-3),
            init_params_fn=init_fn,
            param_axes=tl.param_logical_axes(cfg),
            load_strategy=Strategy(data=data, fsdp=fsdp),
            device="cpu")
        fns = result.fns
        st = fns.init_state(0)
        metrics = []
        for b in batches:
            local = fns.batch_sharding.local({"tokens": b})
            st, m = fns.train_step(
                st, {k: torch.from_numpy(v) for k, v in local.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        group = result.mesh_ctx.group(AxisName.FSDP)
        full = {}
        with torch.no_grad():
            for (path, t), p in zip(_paths(st["params"]),
                                    param_leaves(fns.placements)):
                full[path] = (all_gather_dim(t.detach(), p.dim, group)
                              if p.sharded else t.detach()).clone()
        torch.save({"slices": dict(_paths(st["params"])),
                    "placements": fns.placements,
                    "exp_avg": [st["opt_state"].state[t]["exp_avg"]
                                for t in param_leaves(st["params"])]},
                   os.path.join(out_dir, f"{mesh}_rank{rank}.pt"))
        if rank == 0:
            torch.save({"metrics": metrics, "params": full,
                        "gathered": fns.last_gather.gathered},
                       os.path.join(out_dir, f"{mesh}.pt"))
        dist.barrier()
    # int8 moments under fsdp > 1 are refused
    try:
        auto_accelerate(
            loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
            optimizer=lambda ps: QuantizedMoments(ps, lr=1e-3),
            init_params_fn=init_fn,
            param_axes=tl.param_logical_axes(cfg),
            load_strategy=Strategy(data=2, fsdp=2), device="cpu")
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    if rank == 0:
        with open(os.path.join(out_dir, "int8.txt"), "w") as f:
            f.write(refused)
    shutdown_distributed()


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _paths(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


if __name__ == "__main__":
    main(*sys.argv[1:4])
