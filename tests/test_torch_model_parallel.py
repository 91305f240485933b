"""The port's tensor, sequence (Ulysses and ring) and pipeline parallelism
against the JAX package's, on the CPU.

- The sharded step on ``LlamaConfig.tiny(n_heads=4 tp, n_kv_heads=2 tp,
  n_layers=4)`` in fp32 as gloo processes (``tests/
  torch_model_parallel_worker.py``, one spawn of eight ranks for
  ``{data 2, fsdp 2, tensor 2}``, one of four for ``{pipe 2, data 2}``
  with 4 microbatches, ``{seq 2, tensor 2}`` with Ulysses and with ring,
  and ``{pipe 2, tensor 2}``): from params converted from the JAX
  package's, two AGD steps give the loss, the grad norm and the updated
  params of the JAX package's sharded step on the same mesh and batches
  (``dlrover_tpu.parallel.train_step.build_train_step``, the SP kind
  forced through ``DLROVER_TPU_SP_KERNEL`` on both sides).  Tolerances
  are ``tests/test_torch_parallel.py``'s: 1e-5 on the loss, 1e-4 on the
  grad norm, 2e-5 on the params.
- The collectives against the JAX functions under ``shard_map`` on the
  CPU devices: ``ring_attention`` at seq 2 and 4, causal and full, MHA
  and GQA, and ``ulysses_attention`` (outputs and q/k/v grads);
  ``pipeline_spmd`` with a toy stage under both schedules (outputs, the
  stages' and the microbatches' grads) and the GPipe executor; the
  vocab-parallel loss (dense and fused) and embedding and
  ``distributed_softmax`` against their unsharded forms;
  ``sp_kernel_choice`` against the JAX function.
- A ``{pipe 2, tensor 2}`` checkpoint restores at world 1 and at
  ``{tensor 2, fsdp 2}`` bit for bit through ``derive_layouts``.
- Every tensor, seq and pipe rank of one (data, fsdp) coordinate gets
  the same rows from ``BatchSharding`` and ``device_prefetch``.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import uuid
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from dlrover_tpu.accelerate import module_replace as jmr  # noqa: E402
from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel import collectives as jcol  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.parallel import pipeline as jpipe  # noqa: E402
from dlrover_tpu.parallel import sharding as jsharding  # noqa: E402
from dlrover_tpu_torch.accelerate import module_replace as tmr  # noqa: E402
from dlrover_tpu_torch.accelerate.strategy import Strategy  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    _dict_paths,
    params_from_jax,
)
from dlrover_tpu_torch.optimizers import AGD  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from dlrover_tpu_torch.parallel.train_step import (  # noqa: E402
    build_train_step,
)
from dlrover_tpu_torch.trainer.checkpoint import reshard as R  # noqa: E402
from dlrover_tpu_torch.trainer.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_model_parallel_worker import parse_mesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LOSS_ATOL, NORM_ATOL, PARAM_ATOL = 1e-5, 1e-4, 2e-5
UNIT_ATOL = 2e-5
#: (mesh, world, batch rows, tokens a row)
MESHES = (("d2f2t2", 8, 8, 16), ("p2d2m4", 4, 8, 16),
          ("s2t2ulysses", 4, 4, 32), ("s2t2ring", 4, 4, 32),
          ("p2t2", 4, 8, 16))
AXES = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


def _jcfg(tp):
    return jl.LlamaConfig.tiny(n_heads=4 * tp, n_kv_heads=2 * tp,
                               n_layers=4, dtype=jnp.float32, remat="none")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _inputs():
    """JAX params for tp 1 and 2, a batch stream per mesh, and the unit
    cases' inputs."""
    out, jparams = {}, {}
    for tp in (1, 2):
        jp = jl.init_params(jax.random.PRNGKey(3), _jcfg(tp))
        jparams[tp] = jp
        npp = jax.tree_util.tree_map(np.asarray, jp)
        for k, v in _flat(params_from_jax(
                npp, device="cpu", dtype=torch.float32)).items():
            out[f"p{tp}/{k}"] = v.numpy()
    rng = np.random.default_rng(8)
    for mesh, _, rows, seq in MESHES:
        out[f"batches_{mesh}"] = rng.integers(
            0, 256, (2, rows, seq + 1)).astype(np.int32)
    for name, h, kv in (("attn_mha", 4, 4), ("attn_gqa", 8, 2)):
        out[f"{name}/q"] = rng.standard_normal((2, 32, h, 8), np.float32)
        for x in "kv":
            out[f"{name}/{x}"] = rng.standard_normal((2, 32, kv, 8),
                                                     np.float32)
        out[f"{name}/w"] = rng.standard_normal((2, 32, h, 8), np.float32)
    out["pipe/w"] = (rng.standard_normal((2, 8, 8), np.float32)
                     / np.sqrt(8)).astype(np.float32)
    out["pipe/x"] = rng.standard_normal((4, 2, 8), np.float32)
    out["pipe/c"] = rng.standard_normal((4, 2, 8), np.float32)
    out["ce/logits"] = 3 * rng.standard_normal((12, 10), np.float32)
    out["ce/t"] = rng.integers(0, 10, (12,)).astype(np.int64)
    out["ce/c"] = rng.standard_normal((12,), np.float32)
    out["ce/sc"] = rng.standard_normal((12, 10), np.float32)
    out["ce/h"] = rng.standard_normal((12, 6), np.float32)
    out["ce/w"] = rng.standard_normal((6, 10), np.float32)
    out["ce/emb"] = rng.standard_normal((10, 6), np.float32)
    out["ce/ec"] = rng.standard_normal((3, 4, 6), np.float32)
    return out, jparams


def _spawn(work, world, meshes, units=""):
    port = get_free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   DLROVER_TPU_PROCESS_RANK=str(rank),
                   DLROVER_TPU_PROCESS_COUNT=str(world),
                   DLROVER_TPU_LOCAL_RANK=str(rank),
                   DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   PYTHONPATH=str(REPO),
                   **{multi_process.SOCKET_DIR_ENV: str(work)})
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests/torch_model_parallel_worker.py"),
             str(work / "in.npz"), str(work), meshes, units],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _wait(procs, timeout=150):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        raise
    assert all(p.returncode == 0 for p in procs), "\n".join(
        o[-3000:] for o in outs)


@pytest.fixture(scope="module")
def runs():
    """The gloo ranks (one spawn of 8, one of 4) run while this process
    computes the JAX side."""
    inputs, jparams = _inputs()
    work = Path(tempfile.mkdtemp(prefix="dtm", dir="/tmp"))
    try:
        np.savez(work / "in.npz", **inputs)
        eight = _spawn(work, 8, "d2f2t2")
        four = _spawn(work, 4, ",".join(m for m, w, _, _ in MESHES
                                        if w == 4), units="units")
        jax_runs = {m: _jax_sharded(m, w, jparams, inputs)
                    for m, w, _, _ in MESHES}
        units = _jax_units(inputs)
        _wait(eight)
        _wait(four)
        port = {m: torch.load(work / f"{m}.pt", weights_only=False)
                for m, _, _, _ in MESHES}
        ranks = {m: [torch.load(work / f"{m}_rank{r}.pt", weights_only=False)
                     for r in range(w)] for m, w, _, _ in MESHES}
        port_units = [torch.load(work / f"units_rank{r}.pt",
                                 weights_only=False) for r in range(4)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"port": port, "ranks": ranks, "jax": jax_runs, "units": units,
            "port_units": port_units, "inputs": inputs}


def _jax_sharded(mesh, world, jparams, inputs):
    from dlrover_tpu.optimizers.agd import agd
    from dlrover_tpu.parallel.train_step import build_train_step as jbuild

    sizes, micro, kernel = parse_mesh(mesh)
    tp = sizes.get("tensor", 1)
    jcfg = _jcfg(tp)
    flags = Strategy(**sizes).rule_flags()
    prev = os.environ.get(jmr.SP_KERNEL_ENV)
    os.environ[jmr.SP_KERNEL_ENV] = kernel or "auto"
    ctx = jmesh.create_parallel_mesh(
        [(a, sizes.get(a, 1)) for a in AXES], devices=jax.devices()[:world])
    if sizes.get("pipe", 1) > 1:
        ctx.pipeline_microbatches = micro or 2 * sizes["pipe"]
    try:
        fns = jbuild(
            loss_fn=lambda p, b: jl.loss_fn(p, b, jcfg),
            optimizer=agd(1e-3), init_params_fn=lambda rng: jparams[tp],
            param_axes=jl.param_logical_axes(jcfg), mesh_ctx=ctx,
            rules=jsharding.default_rules(**flags))
        st = fns.init_state(jax.random.PRNGKey(0))
        metrics = []
        for b in inputs[f"batches_{mesh}"]:
            st, m = fns.train_step(st, jax.device_put(
                {"tokens": jnp.asarray(b)}, fns.batch_sharding))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        params = _flat(jax.tree_util.tree_map(np.asarray, st["params"]))
    finally:
        jmesh.destroy_parallel_mesh()
        if prev is None:
            os.environ.pop(jmr.SP_KERNEL_ENV, None)
        else:
            os.environ[jmr.SP_KERNEL_ENV] = prev
    return {"metrics": metrics, "params": params}


def _sm(fn, n, axis, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:n]), (axis,))
    return jsharding.shard_map_compat(fn, mesh, in_specs, out_specs)


def _jax_units(z):
    """The JAX functions' outputs and grads on the unit inputs."""
    out = {}
    seq = P(None, "seq")
    for n in (2, 4):
        for name in ("attn_mha", "attn_gqa"):
            q, k, v, w = (jnp.asarray(z[f"{name}/{x}"]) for x in "qkvw")
            cases = [("ring", True), ("ring", False)]
            if k.shape[2] % n == 0:
                cases.append(("ulysses", True))
            for kind, causal in cases:
                if kind == "ring":
                    fn = partial(jcol.ring_attention, axis_name="seq",
                                 causal=causal, use_flash=False)
                else:
                    fn = partial(jcol.ulysses_attention, axis_name="seq",
                                 causal=causal)
                f = _sm(fn, n, "seq", (seq, seq, seq), seq)
                o = jax.jit(f)(q, k, v)
                grads = jax.jit(jax.grad(
                    lambda q, k, v: jnp.sum(f(q, k, v) * w),
                    argnums=(0, 1, 2)))(q, k, v)
                out[f"{kind}/{name}/seq{n}/causal{int(causal)}"] = [
                    np.asarray(o)] + [np.asarray(g) for g in grads]
    w, x, c = (jnp.asarray(z[f"pipe/{k}"]) for k in "wxc")
    for schedule in ("gpipe", "chunked"):
        f = _sm(lambda p, s, sch=schedule: jpipe.pipeline_spmd(
            lambda pp, xx: jnp.tanh(xx @ pp[0]), p, s, axis_name="pipe",
            schedule=sch), 2, "pipe", (P("pipe"), P()), P())
        y = jax.jit(f)(w, x)
        gw, gx = jax.jit(jax.grad(lambda w, x: jnp.sum(f(w, x) * c),
                                  argnums=(0, 1)))(w, x)
        out[f"pipe/{schedule}"] = [np.asarray(y), np.asarray(gw),
                                   np.asarray(gx)]
    return out


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=atol, rtol=0)


# --------------------------------------------------- the sharded step


@pytest.mark.parametrize("mesh", [m for m, _, _, _ in MESHES])
def test_model_parallel_step_matches_jax(runs, mesh):
    port, want = runs["port"][mesh], runs["jax"][mesh]
    for (l, n), (wl, wn) in zip(port["metrics"], want["metrics"]):
        _close(l, wl, LOSS_ATOL)
        _close(n, wn, NORM_ATOL)
    assert len(port["metrics"]) == 2
    assert set(port["params"]) == set(want["params"])
    for k, v in port["params"].items():
        _close(v.numpy(), want["params"][k], PARAM_ATOL)
    sizes, micro, _ = parse_mesh(mesh)
    if "pipe" in sizes:
        assert port["microbatches"] == (micro or 2 * sizes["pipe"])
    # every rank kept its slices: the tensor axis cuts the heads, MLP
    # columns and vocab, the pipe axis the layers
    for r, rank in enumerate(runs["ranks"][mesh]):
        places = dict(_flat(rank["placements"]))
        for path, shape in rank["shapes"].items():
            assert shape == places[path].local_shape
        for axis, path, dim in (("tensor", "layers/wq", 2),
                                ("tensor", "layers/w_down", 1),
                                ("tensor", "embed", 0),
                                ("tensor", "lm_head", 1),
                                ("pipe", "layers/wo", 0)):
            if sizes.get(axis, 1) > 1:
                assert places[path].dim_of(axis) == dim, (path, axis)


def test_model_parallel_ranks_of_one_data_coordinate_get_the_same_rows(runs):
    for mesh, world, _, _ in MESHES:
        sizes = parse_mesh(mesh)[0]
        ctxs = [tmesh.MeshContext(
            mesh=None, dims=[(a, sizes.get(a, 1)) for a in AXES], rank=r)
            for r in range(world)]
        for r, rank in enumerate(runs["ranks"][mesh]):
            c = ctxs[r]
            first = next(i for i, o in enumerate(ctxs)
                         if o.axis_index("data") == c.axis_index("data")
                         and o.axis_index("fsdp") == c.axis_index("fsdp"))
            assert np.array_equal(rank["rows"],
                                  runs["ranks"][mesh][first]["rows"])


# ------------------------------------------------------ the collectives


def _unit(runs, key, ranks):
    return [runs["port_units"][r][key] for r in ranks]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_parallel_attention_matches_jax(runs, kind, n):
    seen = 0
    for key, want in runs["units"].items():
        if not key.startswith(f"{kind}/") or f"/seq{n}/" not in key:
            continue
        got = _unit(runs, key, range(n))
        # each rank's output and grads are its chunk of the sequence
        for i, w in enumerate(want):
            _close(torch.cat([g[i] for g in got], dim=1).numpy(), w,
                   UNIT_ATOL)
        seen += 1
    assert seen == {("ring", 2): 4, ("ring", 4): 4, ("ulysses", 2): 2,
                    ("ulysses", 4): 1}[(kind, n)]


@pytest.mark.parametrize("schedule", ["gpipe", "chunked"])
def test_pipeline_spmd_matches_jax(runs, schedule):
    y, gw, gx = runs["units"][f"pipe/{schedule}"]
    got = _unit(runs, f"pipe/{schedule}", (0, 1))
    for g in got:
        _close(g[0].numpy(), y, UNIT_ATOL)
    # stage s holds w[s]; the microbatches' grad is summed over stages
    _close(torch.cat([g[1] for g in got]).numpy(), gw, UNIT_ATOL)
    _close((got[0][2] + got[1][2]).numpy(), gx, UNIT_ATOL)
    # the executor: the same, its input's grad summed over the stages
    ex = _unit(runs, "pipe/executor", (0, 1))
    for g in ex:
        _close(g[0].numpy().reshape(y.shape), y, UNIT_ATOL)
        _close(g[2].numpy().reshape(gx.shape), gx, UNIT_ATOL)
    _close(torch.cat([g[1] for g in ex]).numpy(), gw, UNIT_ATOL)


def test_vocab_parallel_loss_embedding_and_softmax_match_unsharded(runs):
    z = runs["inputs"]
    logits = torch.from_numpy(z["ce/logits"]).requires_grad_(True)
    t = torch.from_numpy(z["ce/t"])
    nll = -torch.log_softmax(logits, -1).gather(1, t[:, None])[:, 0]
    g = torch.autograd.grad((nll * torch.from_numpy(z["ce/c"])).sum(),
                            logits)[0]
    got = _unit(runs, "ce/dense", (0, 1))
    for r in got:
        _close(r[0].numpy(), nll.detach().numpy(), UNIT_ATOL)
    _close(torch.cat([r[1] for r in got], -1).numpy(), g.numpy(), UNIT_ATOL)

    h = torch.from_numpy(z["ce/h"]).requires_grad_(True)
    w = torch.from_numpy(z["ce/w"]).requires_grad_(True)
    loss = -torch.log_softmax(h @ w, -1).gather(1, t[:, None]).mean()
    gh, gw = torch.autograd.grad(loss, (h, w))
    got = _unit(runs, "ce/fused", (0, 1))
    for r in got:
        _close(r[0].numpy(), loss.detach().numpy(), UNIT_ATOL)
        _close(r[1].numpy(), gh.numpy(), UNIT_ATOL)
    _close(torch.cat([r[2] for r in got], -1).numpy(), gw.numpy(), UNIT_ATOL)

    emb = torch.from_numpy(z["ce/emb"]).requires_grad_(True)
    rows = emb[t.reshape(3, -1)]
    ge = torch.autograd.grad((rows * torch.from_numpy(z["ce/ec"])).sum(),
                             emb)[0]
    got = _unit(runs, "embed", (0, 1))
    for r in got:
        _close(r[0].numpy(), rows.detach().numpy(), 0)
    _close(torch.cat([r[1] for r in got]).numpy(), ge.numpy(), UNIT_ATOL)

    sm = torch.softmax(logits, -1)
    gs = torch.autograd.grad((sm * torch.from_numpy(z["ce/sc"])).sum(),
                             logits)[0]
    got = _unit(runs, "softmax", (0, 1))
    _close(torch.cat([r[0] for r in got], -1).numpy(), sm.detach().numpy(),
           UNIT_ATOL)
    _close(torch.cat([r[1] for r in got], -1).numpy(), gs.numpy(), UNIT_ATOL)


@pytest.mark.parametrize("env", ["auto", "ring", "ulysses"])
def test_sp_kernel_choice_equals_jax(monkeypatch, env):
    monkeypatch.setenv(tmr.SP_KERNEL_ENV, env)
    for seq, h, kv in ((2, 4, 2), (4, 8, 2), (2, 3, 1), (8, 32, 8),
                       (4, 32, 32)):
        assert tmr.sp_kernel_choice(seq, h, kv) == jmr.sp_kernel_choice(
            seq, h, kv)


# ----------------------------------------------------- the checkpoint


def _placements(dims, rules, world, glob, axes):
    out = []
    for r in range(world):
        ctx = tmesh.MeshContext(mesh=None, dims=dims, rank=r)
        out.append({path: tsharding.placement_for(
            ctx, rules, axes[path], tuple(t.shape),
            rules.uses_axis("fsdp")) for path, t in glob.items()})
    return out


def _cut(state, places):
    return {k: places[k].local(v).clone() for k, v in state.items()}


def test_pipe_tensor_checkpoint_restores_at_world_one_and_tensor_fsdp():
    cfg = tl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=4,
                              dtype=torch.float32)
    rng = np.random.default_rng(5)
    glob = {path: torch.from_numpy(
        rng.standard_normal(tuple(m.shape)).astype(np.float32))
        for path, m in _dict_paths(tl.init_params(cfg, device="meta"))}
    moms = {k: v * 0.5 for k, v in glob.items()}
    axes = dict(_dict_paths(tl.param_logical_axes(cfg)))
    meshes = {
        "pipe2_tensor2": ([("pipe", 2), ("tensor", 2)],
                          tsharding.default_rules(
                              fsdp=False, tensor_parallel=True,
                              pipeline=True), 4),
        "world1": ([("data", 1)], tsharding.default_rules(fsdp=False), 1),
        "tensor2_fsdp2": ([("fsdp", 2), ("tensor", 2)],
                          tsharding.default_rules(
                              fsdp=True, tensor_parallel=True), 4),
    }

    def rank_keyed(name):
        dims, rules, world = meshes[name]
        out = []
        for places in _placements(dims, rules, world, glob, axes):
            keyed = [(f"['opt_state'].exp_avg{k}", v)
                     for k, v in _cut(moms, places).items()]
            keyed += [(f"['params']{k}", v)
                      for k, v in _cut(glob, places).items()]
            tree = {}
            for path, p in places.items():
                node = tree
                keys = [k[2:-2] for k in path.replace("][", "]|[").split("|")]
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = p
            out.append((keyed, R.derive_layouts(keyed, tree), places))
        return out

    saved = rank_keyed("pipe2_tensor2")
    # both axes cut wq: the layer dim over pipe, the heads over tensor
    lay = saved[3][1]["['params']['layers']['wq']"]
    assert lay["start"] == [2, 0, 32] and lay["shape"] == [2, 64, 32]
    d = tempfile.mkdtemp(prefix="dtk", dir="/tmp")
    sock = tempfile.mkdtemp(prefix="dts", dir="/tmp")
    old = os.environ.get(multi_process.SOCKET_DIR_ENV)
    os.environ[multi_process.SOCKET_DIR_ENV] = sock
    try:
        name = f"k{uuid.uuid4().hex[:6]}"
        engines = [CheckpointEngine(checkpoint_dir=d, process_rank=r,
                                    process_count=4, local_shard_num=4,
                                    name=name, step_sync_fn=max)
                   for r in range(4)]
        try:
            for r in (3, 2, 1):
                assert engines[r].save_to_memory(4, saved[r][0],
                                                 layouts=saved[r][1])
            assert engines[0].save_to_storage(4, saved[0][0],
                                              layouts=saved[0][1])
            assert engines[0].wait_for_persist(4, timeout=60)
        finally:
            for e in engines[::-1]:
                e.close()
        for target in ("world1", "tensor2_fsdp2"):
            world = meshes[target][2]
            name = f"g{uuid.uuid4().hex[:6]}"
            engines = [CheckpointEngine(checkpoint_dir=d, process_rank=r,
                                        process_count=world,
                                        local_shard_num=world, name=name,
                                        step_sync_fn=max)
                       for r in range(world)]
            try:
                for (keyed, lay, _), eng in zip(rank_keyed(target),
                                                engines):
                    step, got = eng.load(layouts=lay)
                    assert step == 4
                    for k, v in keyed:
                        assert torch.equal(got[k], v), (target, k)
            finally:
                for e in engines[::-1]:
                    e.close()
    finally:
        if old is None:
            os.environ.pop(multi_process.SOCKET_DIR_ENV, None)
        else:
            os.environ[multi_process.SOCKET_DIR_ENV] = old
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(sock, ignore_errors=True)


# ------------------------------------------------------ the batch rows


def test_batch_sharding_and_prefetch_give_each_data_coordinate_its_rows():
    from dlrover_tpu_torch.data.prefetch import device_prefetch

    cfg = tl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=4,
                              dtype=torch.float32)
    sizes = {"pipe": 2, "data": 2, "fsdp": 2, "seq": 2, "tensor": 2}
    dims = [(a, sizes.get(a, 1)) for a in AXES]
    batch = {"tokens": np.arange(8 * 9, dtype=np.int32).reshape(8, 9)}
    got = {}
    for r in range(32):
        ctx = tmesh.MeshContext(mesh=None, dims=dims, rank=r)
        fns = build_train_step(
            lambda p, b: None, lambda ps: AGD(ps),
            lambda gen, dev: tl.init_params(cfg, gen, dev,
                                            dtype=torch.float32),
            device="cpu", mesh_ctx=ctx,
            param_axes=tl.param_logical_axes(cfg),
            rules=tsharding.default_rules(**Strategy(**sizes).rule_flags()))
        pf = device_prefetch(iter([batch]), size=2,
                             sharding=fns.batch_sharding)
        rows = next(iter(pf))["tokens"]
        assert torch.equal(rows, torch.from_numpy(
            fns.batch_sharding.local(batch)["tokens"]))
        key = (ctx.axis_index("data"), ctx.axis_index("fsdp"))
        if key in got:
            assert torch.equal(rows, got[key])
        got[key] = rows
    # four (data, fsdp) coordinates, two rows each, the batch in order
    assert torch.equal(torch.cat([got[k] for k in sorted(got)]),
                       torch.from_numpy(batch["tokens"]))


# ------------------------------------------------------------ the raises


def test_expert_axis_and_int8_moments_over_cut_leaves_raise():
    from dlrover_tpu_torch.optimizers import QuantizedMoments

    cfg = tl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, dtype=torch.float32)
    init = lambda gen, dev: tl.init_params(  # noqa: E731
        cfg, gen, dev, dtype=torch.float32)
    ctx = tmesh.MeshContext(mesh=None, dims=[("expert", 2)])
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        build_train_step(None, AGD, init, device="cpu", mesh_ctx=ctx,
                         param_axes=tl.param_logical_axes(cfg),
                         rules=tsharding.default_rules(expert_parallel=True))
    ctx = tmesh.MeshContext(mesh=None, dims=[("tensor", 2)])
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        build_train_step(None, lambda ps: QuantizedMoments(ps), init,
                         device="cpu", mesh_ctx=ctx,
                         param_axes=tl.param_logical_axes(cfg),
                         rules=tsharding.default_rules(
                             fsdp=False, tensor_parallel=True))
