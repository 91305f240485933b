"""One rank of the port's tensor, seq and pipe parallelism on the CPU
(gloo), driven by ``tests/test_torch_model_parallel.py``.

    python tests/torch_model_parallel_worker.py <inputs.npz> <out_dir> \\
        <meshes> [units]

with ``DLROVER_TPU_PROCESS_RANK``/``_COUNT``/``_COORDINATOR_ADDR`` set.
Each mesh of ``meshes`` (comma-separated; ``d2f2t2``, ``p2d2m4``,
``s2t2ring``, ...: the letters d, f, t, s, p and m give data, fsdp,
tensor, seq, pipe and the pipeline's microbatches; ``ring``/``ulysses``
forces the SP kernel) covers the world: ``auto_accelerate`` over
``LlamaConfig.tiny(n_heads=4 tp, n_kv_heads=2 tp, n_layers=4)`` in fp32
from the params in ``inputs.npz`` (``p<tp>/<leaf>``) takes a step per
global batch (its rows only), and rank 0 writes the losses, grad norms
and the reassembled params to ``<out_dir>/<mesh>.pt``.  Every rank
writes its placements and its slices' shapes too.  With ``units`` the
world also runs the collectives' unit cases (ring and Ulysses attention
at seq 2 and 4, the pipeline under both schedules, the vocab-parallel
loss and embedding) and writes each rank's outputs and gradients to
``<out_dir>/units_rank<r>.pt``.  Imports torch and the port only.
"""

import os
import re
import sys

import numpy as np
import torch


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _paths(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def parse_mesh(mesh: str):
    """``p2d2m4`` -> ({"pipe": 2, "data": 2}, microbatches 4, kernel)."""
    kernel = next((k for k in ("ring", "ulysses") if mesh.endswith(k)), "")
    spec = mesh[:len(mesh) - len(kernel)]
    names = {"d": "data", "f": "fsdp", "t": "tensor", "s": "seq",
             "p": "pipe", "m": "micro"}
    sizes = {names[a]: int(n) for a, n in re.findall(r"([dftspm])(\d+)",
                                                      spec)}
    micro = sizes.pop("micro", 0)
    return sizes, micro, kernel


def run_mesh(mesh, z, out_dir, rank):
    from dlrover_tpu_torch.accelerate import Strategy, auto_accelerate
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.parallel.collectives import all_gather_dim
    from dlrover_tpu_torch.parallel.train_step import param_leaves

    sizes, micro, kernel = parse_mesh(mesh)
    tp = sizes.get("tensor", 1)
    os.environ["DLROVER_TPU_SP_KERNEL"] = kernel or "auto"
    flat = {k[len(f"p{tp}/"):]: z[k] for k in z.files
            if k.startswith(f"p{tp}/")}

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

    cfg = tl.LlamaConfig.tiny(n_heads=4 * tp, n_kv_heads=2 * tp,
                              n_layers=4, dtype=torch.float32, remat="full")
    result = auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=init_fn,
        param_axes=tl.param_logical_axes(cfg),
        load_strategy=Strategy(pipe_microbatches=micro, **sizes),
        device="cpu")
    fns, ctx = result.fns, result.mesh_ctx
    st = fns.init_state(0)
    metrics = []
    for b in z[f"batches_{mesh}"]:
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
    torch.save({"placements": fns.placements,
                "shapes": {k: tuple(v.shape)
                           for k, v in _paths(st["params"])},
                "rows": fns.batch_sharding.local(
                    {"tokens": z[f"batches_{mesh}"][0]})["tokens"]},
               os.path.join(out_dir, f"{mesh}_rank{rank}.pt"))
    if rank == 0:
        torch.save({"metrics": metrics, "params": full,
                    "microbatches": ctx.pipeline_microbatches},
                   os.path.join(out_dir, f"{mesh}.pt"))


def _chunk(x, n, i, dim=1):
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def run_units(z, out_dir, rank, world):
    """The collectives' cases; each rank keeps its outputs and grads."""
    import torch.distributed as dist

    from dlrover_tpu_torch.accelerate.module_replace import (
        _pipeline_executor,
    )
    from dlrover_tpu_torch.ops.fused import (
        fused_linear_cross_entropy,
        vocab_parallel_nll,
    )
    from dlrover_tpu_torch.parallel import collectives as C
    from dlrover_tpu_torch.parallel.mesh import create_parallel_mesh
    from dlrover_tpu_torch.parallel.pipeline import pipeline_spmd

    out = {}

    def grads_of(loss, *xs):
        return [g.detach().clone() for g in torch.autograd.grad(loss, xs)]

    # ring and Ulysses attention: seq 2 (two groups) and seq 4
    for n in (2, 4):
        ctx = create_parallel_mesh([("data", world // n), ("seq", n)],
                                   set_global=False)
        group = ctx.group("seq")
        i = ctx.axis_index("seq")
        for name in ("attn_mha", "attn_gqa"):
            q, k, v, w = (torch.from_numpy(z[f"{name}/{x}"])
                          for x in "qkvw")
            q, k, v = (_chunk(t, n, i).clone().requires_grad_(True)
                       for t in (q, k, v))
            w = _chunk(w, n, i)
            cases = [("ring", True), ("ring", False)]
            if k.shape[2] % n == 0:
                cases.append(("ulysses", True))
            for kind, causal in cases:
                if kind == "ring":
                    o = C.ring_attention(q, k, v, group, causal=causal)
                else:
                    o = C.ulysses_attention(q, k, v, group, causal=causal)
                key = f"{kind}/{name}/seq{n}/causal{int(causal)}"
                out[key] = [o.detach().clone()] + grads_of(
                    (o * w).sum(), q, k, v)
        dist.barrier()
    # the pipeline with a toy stage: [S, d, d] weights cut over pipe
    ctx = create_parallel_mesh([("data", world // 2), ("pipe", 2)],
                               set_global=False)
    s = ctx.axis_index("pipe")
    for schedule in ("gpipe", "chunked"):
        wts = torch.from_numpy(z["pipe/w"])[s:s + 1].clone(
        ).requires_grad_(True)
        mbs = torch.from_numpy(z["pipe/x"]).clone().requires_grad_(True)
        y = pipeline_spmd(lambda p, x: torch.tanh(x @ p[0]), wts, mbs, ctx,
                          schedule=schedule)
        loss = (y * torch.from_numpy(z["pipe/c"])).sum()
        out[f"pipe/{schedule}"] = [y.detach().clone()] + grads_of(
            loss, wts, mbs)
    # the executor's input sums its gradient over the stages
    ctx.pipeline_microbatches = 4
    x = torch.from_numpy(z["pipe/x"]).reshape(-1, z["pipe/x"].shape[-1])
    x = x.clone().requires_grad_(True)
    wts = torch.from_numpy(z["pipe/w"])[s:s + 1].clone().requires_grad_(True)
    y = _pipeline_executor(ctx)(
        lambda lp, h: torch.tanh(h @ lp["w"]), {"w": list(wts)}, x)
    loss = (y * torch.from_numpy(z["pipe/c"]).reshape(y.shape)).sum()
    out["pipe/executor"] = [y.detach().clone()] + grads_of(loss, wts, x)
    dist.barrier()
    # vocab-parallel loss and embedding over a tensor group of 2
    ctx = create_parallel_mesh([("data", world // 2), ("tensor", 2)],
                               set_global=False)
    group = ctx.group("tensor")
    j = ctx.axis_index("tensor")
    logits = torch.from_numpy(z["ce/logits"])
    t = torch.from_numpy(z["ce/t"])
    vl = logits.shape[-1] // 2
    part = _chunk(logits, 2, j, dim=-1).clone().requires_grad_(True)
    nll = vocab_parallel_nll(part, t, group, j * vl)
    out["ce/dense"] = [nll.detach().clone()] + grads_of(
        (nll * torch.from_numpy(z["ce/c"])).sum(), part)
    h = torch.from_numpy(z["ce/h"]).clone().requires_grad_(True)
    wv = _chunk(torch.from_numpy(z["ce/w"]), 2, j, dim=-1).clone(
    ).requires_grad_(True)
    loss = fused_linear_cross_entropy(C.copy_to(h, group), wv, t,
                                      chunk_rows=5, group=group,
                                      vocab_start=j * vl)
    out["ce/fused"] = [loss.detach().clone()] + grads_of(loss, h, wv)
    from dlrover_tpu_torch.models.llama import _embed
    from dlrover_tpu_torch.parallel.sharding import ParamGather, Placement

    emb = torch.from_numpy(z["ce/emb"])
    table = _chunk(emb, 2, j, dim=0).clone().requires_grad_(True)
    gather = ParamGather(
        {"embed": Placement.of(emb.shape, 0, 2, j, axis="tensor")},
        mesh_ctx=ctx)
    rows = _embed(gather, {"embed": table}, t.reshape(3, -1), torch.float32)
    out["embed"] = [rows.detach().clone()] + grads_of(
        (rows * torch.from_numpy(z["ce/ec"])).sum(), table)
    # distributed_softmax over the vocab cut: psum's gradient is summed
    part = _chunk(logits, 2, j, dim=-1).clone().requires_grad_(True)
    sm = C.distributed_softmax(part, group)
    out["softmax"] = [sm.detach().clone()] + grads_of(
        (sm * _chunk(torch.from_numpy(z["ce/sc"]), 2, j, dim=-1)).sum(),
        part)
    torch.save(out, os.path.join(out_dir, f"units_rank{rank}.pt"))


def main(inputs: str, out_dir: str, meshes: str, units: str = ""):
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
    rank = ctx.rank
    for mesh in filter(None, meshes.split(",")):
        run_mesh(mesh, z, out_dir, rank)
        dist.barrier()
    if units:
        run_units(z, out_dir, rank, ctx.world_size)
        dist.barrier()
    shutdown_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:5])
