"""The port's data and fsdp parallelism against the JAX package's, on the
CPU.

- ``_resolve_dims`` and ``default_rules(...).spec`` give the JAX
  functions' answers over a table of meshes and rule flags.
- ``param_sharding_with_fsdp`` picks the dim the JAX function shards for
  every leaf of ``LlamaConfig.tiny()`` at fsdp 2, 4 and 8 (the JAX side
  on the 8 CPU devices of ``tests/conftest.py``).
- The sharded step on ``LlamaConfig.tiny()`` in fp32, as four gloo
  processes (``tests/torch_sharded_worker.py``) at ``{data 2, fsdp 2}``,
  ``{data 4}`` and ``{fsdp 4}``: from params converted from the JAX
  package's, two steps give the loss, the grad norm and the updated
  params of the JAX package's sharded step on the same mesh and batches
  (``dlrover_tpu.parallel.train_step.build_train_step``) and of the
  port's world-1 step.  Tolerances are ``tests/test_torch_train.py``'s:
  1e-5 on the loss, 1e-4 on the grad norm, 2e-5 on params after AGD
  steps (sums in another order; AGD's step is sign-like).
- Under fsdp 4 no gather returns more than one layer of a stacked leaf
  (the elements of every ``layers/*`` gather are counted), and each
  layer is gathered twice a step (the forward and the ``remat="full"``
  recompute).
- At ``{data 1, fsdp 1}`` the sharded step equals the unsharded one bit
  for bit.
- A checkpoint written at ``{fsdp 2}`` with the layouts
  ``derive_layouts`` reads from the placements restores at world 1 and
  at ``{fsdp 4}`` bit for bit.
- ``QuantizedMoments`` at fsdp 2, the expert axis and the hybrid mesh
  raise, naming their ROADMAP labels; the tensor, seq and pipe axes
  build a step (``tests/test_torch_model_parallel.py`` runs them).
"""

import os
import shutil
import subprocess
import sys
import tempfile
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jsharding  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.optimizers import AGD  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from dlrover_tpu_torch.parallel.train_step import (  # noqa: E402
    build_train_step,
    param_leaves,
)
from dlrover_tpu_torch.trainer.checkpoint import reshard as R  # noqa: E402
from dlrover_tpu_torch.trainer.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)

REPO = Path(__file__).resolve().parents[1]
MESHES = ("2x2", "4x1", "1x4")
LOSS_ATOL, NORM_ATOL, PARAM_ATOL = 1e-5, 1e-4, 2e-5


def _jcfg():
    return jl.LlamaConfig.tiny(dtype=jnp.float32, remat="none")


def _tcfg():
    return tl.LlamaConfig.tiny(dtype=torch.float32, remat="full")


def _inputs():
    jp = jl.init_params(jax.random.PRNGKey(3), _jcfg())
    npp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(8)
    batches = rng.integers(0, 256, (2, 8, 13)).astype(np.int32)
    return jp, npp, batches


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _torch_init(npp):
    tp = params_from_jax(npp, device="cpu", dtype=torch.float32)

    def init(gen, dev):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if dev.type == "meta":
                return torch.empty(node.shape, device=dev)
            return node.clone().to(dev)
        return walk(tp)

    return init


# ------------------------------------------------------------ the tables


@pytest.mark.parametrize("config,n", [
    ([("data", -1)], 8), ([("data", 2), ("fsdp", -1)], 8),
    ([("pipe", 1), ("data", 2), ("fsdp", 2), ("expert", 1), ("seq", 1),
      ("tensor", 1)], 4),
    ([("data", 3)], 8), ([("data", -1), ("fsdp", -1)], 4),
    ([("data", 0)], 4), ([("fsdp", 4)], 6)])
def test_resolve_dims_equals_jax(config, n):
    def run(mod):
        try:
            return mod._resolve_dims(config, n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tmesh) == run(jmesh)
    assert tmesh.build_device_mesh_dims(8, fsdp=2) == \
        jmesh.build_device_mesh_dims(8, fsdp=2)


_AXES = [(jsharding.BATCH,), (jsharding.BATCH, jsharding.SEQ),
         ("layers", "embed", "heads"), ("layers", "heads", "embed"),
         ("embed", "vocab"), ("vocab", "embed"), ("layers", None),
         (None,), ("embed", "embed"), ("expert", "embed", "mlp")]


@pytest.mark.parametrize("flags", [
    {}, {"fsdp": False}, {"tensor_parallel": True},
    {"sequence_parallel": True, "pipeline": True},
    {"expert_parallel": True, "fsdp": False}])
def test_default_rules_spec_equals_jax(flags):
    tr, jr = tsharding.default_rules(**flags), jsharding.default_rules(**flags)
    for axes in _AXES:
        assert tuple(tr.spec(axes)) == tuple(jr.spec(axes)), axes
    for ax in ("fsdp", "tensor", "data"):
        assert tr.uses_axis(ax) == jr.uses_axis(ax)
    with tsharding.rules_scope(tr):
        assert tsharding.active_rules() is tr
    assert tsharding.active_rules() is None


@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_param_sharding_with_fsdp_picks_the_jax_dim(fsdp):
    jcfg = _jcfg()
    shapes = jax.tree_util.tree_map(
        lambda x: x.shape, jax.eval_shape(
            lambda k: jl.init_params(k, jcfg), jax.random.PRNGKey(0)))
    dims = [("data", 8 // fsdp), ("fsdp", fsdp)]
    jctx = jmesh.create_parallel_mesh(dims, devices=jax.devices()[:8],
                                      set_global=False)
    tctx = tmesh.MeshContext(mesh=None, dims=dims)
    jrules = jsharding.default_rules(fsdp=True)
    trules = tsharding.default_rules(fsdp=True)
    axes = _flat(jl.param_logical_axes(jcfg))
    assert axes == _flat(tl.param_logical_axes(_tcfg()))
    for path, shape in _flat(shapes).items():
        spec = jsharding.param_sharding_with_fsdp(
            jctx.mesh, jrules, axes[path], shape).spec
        want = next((i for i, e in enumerate(spec)
                     if "fsdp" in (e if isinstance(e, tuple) else (e,))),
                    None)
        got = tsharding.param_sharding_with_fsdp(
            tctx, trules, axes[path], shape)
        assert got == want, (path, shape, spec)


# --------------------------------------------------- the sharded step


@pytest.fixture(scope="module")
def sharded_runs():
    """Four gloo ranks run every mesh of ``MESHES`` (one spawn for all);
    the JAX package's sharded step and the port's world-1 step on the
    same inputs."""
    jp, npp, batches = _inputs()
    work = Path(tempfile.mkdtemp(prefix="dtp", dir="/tmp"))
    try:
        flat = _flat(params_from_jax(npp, device="cpu",
                                     dtype=torch.float32))
        np.savez(work / "in.npz", batches=batches,
                 **{f"p/{k}": v.numpy() for k, v in flat.items()})
        port = get_free_port()
        procs = []
        for rank in range(4):
            env = dict(os.environ, OMP_NUM_THREADS="1",
                       DLROVER_TPU_PROCESS_RANK=str(rank),
                       DLROVER_TPU_PROCESS_COUNT="4",
                       DLROVER_TPU_LOCAL_RANK=str(rank),
                       DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                       PYTHONPATH=str(REPO),
                       **{multi_process.SOCKET_DIR_ENV: str(work)})
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "tests/torch_sharded_worker.py"),
                 str(work / "in.npz"), str(work), ",".join(MESHES)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out)
        assert all(p.returncode == 0 for p in procs), "\n".join(
            o[-3000:] for o in outs)
        runs = {m: torch.load(work / f"{m}.pt", weights_only=False)
                for m in MESHES}
        ranks = {m: [torch.load(work / f"{m}_rank{r}.pt",
                                weights_only=False) for r in range(4)]
                 for m in MESHES}
        int8 = (work / "int8.txt").read_text()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    jax_runs = {m: _jax_sharded(m, jp, batches) for m in MESHES}
    world1 = _port_world1(npp, batches)
    return {"port": runs, "ranks": ranks, "jax": jax_runs,
            "world1": world1, "int8": int8}


def _jax_sharded(mesh, jp, batches):
    import optax  # noqa: F401 - the JAX step's optimizer library

    from dlrover_tpu.optimizers.agd import agd
    from dlrover_tpu.parallel.train_step import build_train_step as jbuild

    data, fsdp = (int(v) for v in mesh.split("x"))
    jcfg = _jcfg()
    ctx = jmesh.create_parallel_mesh(
        [("pipe", 1), ("data", data), ("fsdp", fsdp), ("expert", 1),
         ("seq", 1), ("tensor", 1)], devices=jax.devices()[:4])
    try:
        fns = jbuild(
            loss_fn=lambda p, b: jl.loss_fn(p, b, jcfg,
                                            jl.dot_product_attention),
            optimizer=agd(1e-3), init_params_fn=lambda rng: jp,
            param_axes=jl.param_logical_axes(jcfg), mesh_ctx=ctx,
            rules=jsharding.default_rules(fsdp=fsdp > 1))
        st = fns.init_state(jax.random.PRNGKey(0))
        metrics = []
        for b in batches:
            st, m = fns.train_step(st, jax.device_put(
                {"tokens": jnp.asarray(b)}, fns.batch_sharding))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        params = _flat(jax.tree_util.tree_map(np.asarray, st["params"]))
    finally:
        jmesh.destroy_parallel_mesh()
    return {"metrics": metrics, "params": params}


def _port_world1(npp, batches):
    cfg = _tcfg()
    fns = build_train_step(lambda p, b: tl.loss_fn(p, b, cfg),
                           lambda ps: AGD(ps, lr=1e-3), _torch_init(npp),
                           device="cpu")
    st = fns.init_state(0)
    metrics = []
    for b in batches:
        st, m = fns.train_step(st, {"tokens": torch.from_numpy(b)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics,
            "params": {k: v.detach() for k, v in _flat(st["params"]).items()}}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_matches_jax_and_world_one(sharded_runs, mesh):
    port = sharded_runs["port"][mesh]
    for other in (sharded_runs["jax"][mesh], sharded_runs["world1"]):
        for (l, n), (wl, wn) in zip(port["metrics"], other["metrics"]):
            _close(l, wl, LOSS_ATOL)
            _close(n, wn, NORM_ATOL)
        assert set(port["params"]) == set(other["params"])
        for k, v in port["params"].items():
            _close(v.numpy(), np.asarray(other["params"][k]), PARAM_ATOL)
    # every rank kept only its slices, as the placements say
    for r, rank in enumerate(sharded_runs["ranks"][mesh]):
        fsdp = int(mesh.split("x")[1])
        for (path, t), p in zip(rank["slices"].items(),
                                param_leaves(rank["placements"])):
            assert tuple(t.shape) == p.local_shape
            if fsdp > 1 and p.sharded:
                full = port["params"][path]
                assert torch.equal(
                    t, full.narrow(p.dim, p.start, p.local_shape[p.dim]))


def test_fsdp_gathers_one_layer_at_a_time(sharded_runs):
    cfg = _tcfg()
    full = {k: v.numel() for k, v in
            sharded_runs["port"]["1x4"]["params"].items()}
    for mesh in ("1x4", "2x2"):
        gathered = sharded_runs["port"][mesh]["gathered"]
        layers = [(p, n) for p, n in gathered if p.startswith("layers/")]
        assert layers
        for path, n in layers:
            # one layer of the stacked leaf, never the whole stack
            assert n == full[path] // cfg.n_layers < full[path]
        per_leaf = {}
        for path, _ in layers:
            per_leaf[path] = per_leaf.get(path, 0) + 1
        # the forward and the checkpoint's recompute, every layer
        assert set(per_leaf.values()) == {2 * cfg.n_layers}
        assert {p for p, _ in gathered if not p.startswith("layers/")} == {
            "embed", "final_norm", "lm_head"}


def test_int8_moments_under_fsdp_raise(sharded_runs):
    assert "ROADMAP A6" in sharded_runs["int8"]


def test_data_one_fsdp_one_equals_the_unsharded_step_bit_for_bit():
    _, npp, batches = _inputs()
    cfg = _tcfg()
    runs = []
    for sharded in (False, True):
        kw = {}
        if sharded:
            kw = dict(mesh_ctx=tmesh.create_parallel_mesh(
                [("data", 1), ("fsdp", 1)], set_global=False),
                param_axes=tl.param_logical_axes(cfg),
                rules=tsharding.default_rules(fsdp=True))
        fns = build_train_step(lambda p, b: tl.loss_fn(p, b, cfg),
                               lambda ps: AGD(ps, lr=1e-3),
                               _torch_init(npp), device="cpu", **kw)
        st = fns.init_state(0)
        out = []
        for b in batches:
            st, m = fns.train_step(st, {"tokens": torch.from_numpy(b)})
            out.append((m["loss"], m["grad_norm"]))
        runs.append((out, param_leaves(st["params"]), fns))
    (a, pa, _), (b, pb, fns) = runs
    assert all(torch.equal(x, y) for u, v in zip(a, b) for x, y in zip(u, v))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    # the hook ran: every leaf passed through the gather, no collective
    paths = {p for p, _ in fns.last_gather.gathered}
    assert "layers/wq" in paths and "lm_head" in paths
    assert not any(p.sharded for p in param_leaves(fns.placements))


# ----------------------------------------------------- the checkpoint


def _fsdp_state(global_state, placements):
    """A rank's train state cut from a global one by its placements."""
    return {k: v.narrow(p.dim, p.start, p.local_shape[p.dim]).clone()
            if p.sharded else v.clone()
            for (k, v), p in zip(global_state.items(), placements)}


def _keyed(params, moments):
    """Keyed leaves as the trainer's state flattens them: params and one
    moment per param."""
    out = [(f"['opt_state'].exp_avg{k}", m) for k, m in moments.items()]
    out += [(f"['params']{k}", v) for k, v in params.items()]
    return out


def test_fsdp_checkpoint_restores_at_world_one_and_four_bit_for_bit():
    from dlrover_tpu_torch.models.convert import _dict_paths

    cfg = _tcfg()
    rng = np.random.default_rng(5)
    glob = {path: torch.from_numpy(
        rng.standard_normal(tuple(m.shape)).astype(np.float32))
        for path, m in _dict_paths(tl.init_params(cfg, device="meta"))}
    moms = {k: v * 0.5 for k, v in glob.items()}
    axes = dict(_dict_paths(tl.param_logical_axes(cfg)))
    rules = tsharding.default_rules(fsdp=True)

    def placements(world):
        ctx = tmesh.MeshContext(mesh=None, dims=[("data", 1),
                                                 ("fsdp", world)])
        out = []
        for r in range(world):
            tree = {}
            for path, t in glob.items():
                dim = tsharding.param_sharding_with_fsdp(
                    ctx, rules, axes[path], tuple(t.shape))
                tree[path] = tsharding.Placement.of(t.shape, dim, world, r)
            out.append(tree)
        return out

    def rank_keyed(world):
        out = []
        for r, pl in enumerate(placements(world)):
            order = list(glob)
            ps = _fsdp_state(glob, [pl[k] for k in order])
            ms = _fsdp_state(moms, [pl[k] for k in order])
            keyed = _keyed(ps, ms)
            lay = _layouts(keyed, pl)
            out.append((keyed, lay))
        return out

    d = tempfile.mkdtemp(prefix="dtf", dir="/tmp")
    sock = tempfile.mkdtemp(prefix="dts", dir="/tmp")
    old = os.environ.get(multi_process.SOCKET_DIR_ENV)
    os.environ[multi_process.SOCKET_DIR_ENV] = sock
    try:
        saved = rank_keyed(2)
        # the layouts say where each slice sits in the global leaf
        for (keyed, lay), pl in zip(saved, placements(2)):
            for key, leaf in keyed:
                path = (key[len("['params']"):] if key.startswith(
                    "['params']") else key[len("['opt_state'].exp_avg"):])
                p = pl[path]
                assert lay[key]["global_shape"] == list(glob[path].shape)
                assert lay[key]["shape"] == list(leaf.shape)
                if p.sharded:
                    assert lay[key]["start"][p.dim] == p.start
        name = f"f{uuid.uuid4().hex[:6]}"
        engines = [CheckpointEngine(checkpoint_dir=d, process_rank=r,
                                    process_count=2, local_shard_num=2,
                                    name=name, step_sync_fn=max)
                   for r in range(2)]
        try:
            assert engines[1].save_to_memory(4, saved[1][0],
                                             layouts=saved[1][1])
            assert engines[0].save_to_storage(4, saved[0][0],
                                              layouts=saved[0][1])
            assert engines[0].wait_for_persist(4, timeout=60)
        finally:
            for e in engines[::-1]:
                e.close()
        for world in (1, 4):
            name = f"g{uuid.uuid4().hex[:6]}"
            engines = [CheckpointEngine(checkpoint_dir=d, process_rank=r,
                                        process_count=world,
                                        local_shard_num=world, name=name,
                                        step_sync_fn=max)
                       for r in range(world)]
            try:
                for (keyed, lay), eng in zip(rank_keyed(world), engines):
                    step, got = eng.load(layouts=lay)
                    assert step == 4
                    for k, v in keyed:
                        assert torch.equal(got[k], v), (world, k)
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


def _layouts(keyed, placements_by_path):
    """``derive_layouts`` of a keyed state whose params sit at the
    placements' paths."""
    tree = {}
    for path, p in placements_by_path.items():
        node = tree
        keys = [k[2:-2] for k in path.replace("][", "]|[").split("|")]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = p
    return R.derive_layouts(keyed, tree)


# ------------------------------------------------------------ the raises


def test_axes_of_later_slices_raise():
    """tensor, seq and pipe build a step (the rule table's axes cut the
    leaves), expert raises naming A7; the hybrid mesh builds."""
    npp = _inputs()[1]
    cfg = _tcfg()
    for dims, flags, cuts in (
            ([("data", 2), ("tensor", 2)], {"tensor_parallel": True},
             {"layers/wq": ("tensor", 2), "embed": ("tensor", 0)}),
            ([("seq", 2)], {"sequence_parallel": True}, {}),
            ([("pipe", 2)], {"pipeline": True},
             {"layers/wq": ("pipe", 0), "layers/attn_norm": ("pipe", 0)})):
        ctx = tmesh.MeshContext(mesh=None, dims=dims, rank=1)
        rules = tsharding.default_rules(fsdp=False, **flags)
        spec = tsharding.logical_sharding(ctx, rules, ("layers", "embed",
                                                       "heads"))
        assert len(spec) == 3
        fns = build_train_step(lambda p, b: tl.loss_fn(p, b, cfg),
                               lambda ps: AGD(ps), _torch_init(npp),
                               device="cpu", mesh_ctx=ctx,
                               param_axes=tl.param_logical_axes(cfg),
                               rules=rules)
        places = _flat(fns.placements)
        for path, (axis, dim) in cuts.items():
            assert places[path].dim_of(axis) == dim, (dims, path)
        assert all(p.sharded == any(p.dim_of(a) is not None
                                    for a, _ in dims)
                   for p in places.values())
        assert fns.batch_sharding.num_shards == dict(dims).get("data", 1)
    ctx = tmesh.MeshContext(mesh=None, dims=[("expert", 2)])
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        build_train_step(None, None, _torch_init(_inputs()[1]),
                         device="cpu", mesh_ctx=ctx,
                         param_axes=tl.param_logical_axes(_tcfg()),
                         rules=tsharding.default_rules())
    # the hybrid mesh is built (tests/test_torch_hybrid_mesh.py): over a
    # world of one only its sizes of one fit
    assert tmesh.create_hybrid_parallel_mesh(
        [("data", 1)], [("fsdp", 1)], set_global=False).dims == [
            ("data", 1), ("fsdp", 1)]
    with pytest.raises(ValueError, match="covers"):
        tmesh.create_hybrid_parallel_mesh([("data", 2)], [("fsdp", 2)],
                                          set_global=False)
    with pytest.raises(ValueError, match="covers"):
        tmesh.create_parallel_mesh([("data", 2)], set_global=False)
