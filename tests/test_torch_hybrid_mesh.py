"""The port's hybrid mesh against the JAX package's, on the CPU.

``create_hybrid_parallel_mesh`` lays the DCN axes across nodes and keeps
the ICI axes inside one.  Its layout is held against the JAX package's
(``dlrover_tpu/parallel/mesh.py:158``) for the same grouping of eight
devices (ranks) into two granules, as ``tests/test_parallel.py:77-126``
checks the JAX one: every ICI row stays inside one granule, granules
come in numeric order, and uneven granules are refused.  The port builds
the mesh where that order is the ranks' own, as the agent numbers them,
and refuses a grouping that the reference would meet by permuting its
devices.

Then the step over it, by gloo ranks of ``tests/torch_mixed_mesh_worker.py``
(two nodes by ``DLROVER_TPU_NODE_INDEX``), on the configuration of the
JAX package's hybrid dry runs (``__graft_entry__.py:_dryrun_hybrid_mesh``
and ``_dryrun_hybrid_full``): ``LlamaConfig.tiny(n_heads=8,
n_kv_heads=4, remat="none")`` from ``init_params(PRNGKey(0))``, AGD(1e-3),
the dry run's batch of zeros and then a seeded random batch, at 8 rows of
64 + 1 tokens (the mixed mesh's shape) and 16 rows for the 32 ranks.

- ``dcn {data 2} x ici {fsdp 2, tensor 2}`` over 8 ranks: the JAX hybrid
  step on 8 CPU devices in bf16, the dry run's compute, reads
  ``MULTICHIP_r05.json``'s 3.7742 (``hybrid-mesh[dcn(data=2) x
  ici(fsdp,tensor)]``) and the port's 8 ranks in bf16 read it within one
  bf16 ulp (3.7675 here); in fp32 each step's loss and grad norm and
  the params after two steps equal the JAX package's step on one device
  within ``tests/test_torch_mixed_mesh.py``'s tolerances.
- ``dcn {data 2} x ici {pipe 2, fsdp 2, seq 2, tensor 2}`` over 32 ranks
  ("hybrid-full", JAX loss 3.7723): held against the JAX one-device step
  in fp32, never against the JAX sharded step, whose gradients are wrong
  where pipe and seq are both above 1 (ROADMAP §C).
"""

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# tests/test_torch_mixed_mesh.py's tolerances
NORM_ATOL, PARAM_ATOL, ONE_LOSS_ATOL = 1e-4, 2e-5, 5e-5
#: MULTICHIP_r05.json: "hybrid-mesh[dcn(data=2) x ici(fsdp,tensor)]"
RECORDED_LOSS = 3.7742
#: one bf16 ulp of a loss between 2 and 4
BF16_ULP = 2.0 ** -6


def _granules(n, fn):
    return {d: fn(i) for i, d in enumerate(jax.devices()[:n])}


# ------------------------------------------------------------- the layout


def _world_of(monkeypatch, n):
    """``create_hybrid_parallel_mesh`` at a world of ``n`` gloo ranks,
    up to the mesh it hands to ``create_parallel_mesh`` (returned as
    its dims)."""
    monkeypatch.setattr(tmesh, "_world", lambda: (n, "gloo"))
    monkeypatch.setattr(tmesh, "create_parallel_mesh",
                        lambda dims, device=None, set_global=True: dims)


@pytest.mark.parametrize("grouping", ["halves", "alternating"])
def test_each_ici_row_stays_inside_one_granule_as_in_jax(grouping,
                                                         monkeypatch):
    fn = (lambda i: i // 4) if grouping == "halves" else (lambda i: i % 2)
    fake = _granules(8, fn)
    jctx = jmesh.create_hybrid_parallel_mesh(
        [("data", 2)], [("fsdp", 2), ("tensor", 2)],
        devices=jax.devices()[:8], set_global=False,
        granule_fn=lambda d: fake[d])
    dims, layout = tmesh.hybrid_layout(
        [("data", 2)], [("fsdp", 2), ("tensor", 2)],
        [fn(r) for r in range(8)])
    assert dims == [("data", 2), ("fsdp", 2), ("tensor", 2)]
    assert tuple(jctx.mesh.axis_names) == tuple(n for n, _ in dims)
    want = [d.id for d in np.asarray(jctx.mesh.devices).flatten()]
    assert layout == want
    grid = np.asarray(layout).reshape(2, 2, 2)
    for row in range(2):
        assert len({fn(r) for r in grid[row].flatten()}) == 1
    # the port builds the mesh where that order is the ranks' own (the
    # agent's numbering, node by node) and refuses the permutation
    _world_of(monkeypatch, 8)
    make = lambda: tmesh.create_hybrid_parallel_mesh(  # noqa: E731
        [("data", 2)], [("fsdp", 2), ("tensor", 2)], granule_fn=fn)
    if grouping == "halves":
        assert make() == dims
    else:
        with pytest.raises(ValueError, match="in order"):
            make()


def test_granules_come_in_numeric_order_as_in_jax(monkeypatch):
    got = {}
    for keys in ([10, 10, 2, 2], [2, 2, 10, 10]):
        fake = _granules(4, keys.__getitem__)
        jctx = jmesh.create_hybrid_parallel_mesh(
            [("data", -1)], [("tensor", 2)], devices=jax.devices()[:4],
            set_global=False, granule_fn=lambda d: fake[d])
        dims, layout = tmesh.hybrid_layout([("data", -1)], [("tensor", 2)],
                                           keys)
        assert dims == [("data", 2), ("tensor", 2)]
        assert layout == [
            d.id for d in np.asarray(jctx.mesh.devices).flatten()]
        got[tuple(keys)] = layout
    assert got == {(10, 10, 2, 2): [2, 3, 0, 1],
                   (2, 2, 10, 10): [0, 1, 2, 3]}
    # node 2 before node 10: the ranks' own order, which the port builds
    _world_of(monkeypatch, 4)
    assert tmesh.create_hybrid_parallel_mesh(
        [("data", -1)], [("tensor", 2)],
        granule_fn=[2, 2, 10, 10].__getitem__) == dims
    with pytest.raises(ValueError, match="in order"):
        tmesh.create_hybrid_parallel_mesh(
            [("data", -1)], [("tensor", 2)],
            granule_fn=[10, 10, 2, 2].__getitem__)


def test_uneven_granules_are_rejected_as_in_jax(monkeypatch):
    sizes = [0, 0, 0, 1, 1, 1, 1, 1]  # 3 + 5
    fake = _granules(8, sizes.__getitem__)
    with pytest.raises(ValueError, match="uneven"):
        jmesh.create_hybrid_parallel_mesh(
            [("data", 2)], [("tensor", -1)], devices=jax.devices()[:8],
            set_global=False, granule_fn=lambda d: fake[d])
    with pytest.raises(ValueError, match="uneven"):
        tmesh.hybrid_layout([("data", 2)], [("tensor", -1)], sizes)
    _world_of(monkeypatch, 8)
    with pytest.raises(ValueError, match="uneven"):
        tmesh.create_hybrid_parallel_mesh(
            [("data", 2)], [("tensor", -1)], granule_fn=sizes.__getitem__)


def test_a_world_of_one_gets_a_hybrid_mesh():
    ctx = tmesh.create_hybrid_parallel_mesh(
        [("data", 1)], [("fsdp", 1), ("tensor", 1)], set_global=False)
    assert ctx.dims == [("data", 1), ("fsdp", 1), ("tensor", 1)]
    assert ctx.mesh is None
    assert ctx.axis_index("tensor") == 0
    with pytest.raises(ValueError, match="covers"):
        tmesh.create_hybrid_parallel_mesh([("data", 2)], [("tensor", 2)],
                                          set_global=False)


# -------------------------------------------------------- the gloo steps


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _inputs(rows, seq):
    cfg = jl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, remat="none")
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    out = {f"p/{k}": np.asarray(v) for k, v in _flat(params).items()}
    rng = np.random.default_rng(16)
    out["batches"] = np.stack([
        np.zeros((rows, seq + 1), np.int32),
        rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)])
    return out


def _jax_one_device(inputs):
    """The JAX package's step on one device, fp32, two steps."""
    from dlrover_tpu.optimizers.agd import agd
    from dlrover_tpu.parallel.sharding import default_rules
    from dlrover_tpu.parallel.train_step import build_train_step

    ctx = jmesh.create_parallel_mesh([("data", 1)],
                                     devices=jax.devices()[:1])
    cfg = jl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, remat="none",
                              dtype=jnp.float32)
    fns = build_train_step(
        loss_fn=lambda p, b: jl.loss_fn(p, b, cfg), optimizer=agd(1e-3),
        init_params_fn=lambda rng: jl.init_params(rng, cfg),
        param_axes=jl.param_logical_axes(cfg), mesh_ctx=ctx,
        rules=default_rules())
    st = fns.init_state(jax.random.PRNGKey(0))
    out = {}
    for i, b in enumerate(inputs["batches"]):
        st, m = fns.train_step(st, jax.device_put(
            {"tokens": jnp.asarray(b)}, fns.batch_sharding))
        out[f"loss{i}"] = float(m["loss"])
        out[f"norm{i}"] = float(m["grad_norm"])
    for k, v in _flat(jax.device_get(st["params"])).items():
        out[f"p/{k}"] = np.asarray(v)
    jmesh.destroy_parallel_mesh()
    return out


def _jax_hybrid_dry_run_loss(inputs):
    """The JAX hybrid dry run's step on 8 CPU devices (bf16 compute, two
    faked slices): its loss on the batch of zeros."""
    from dlrover_tpu.optimizers.agd import agd
    from dlrover_tpu.parallel.sharding import default_rules
    from dlrover_tpu.parallel.train_step import build_train_step

    fake = _granules(8, lambda i: i // 4)
    ctx = jmesh.create_hybrid_parallel_mesh(
        [("data", 2)], [("fsdp", -1), ("tensor", 2)],
        devices=jax.devices()[:8], granule_fn=lambda d: fake[d])
    cfg = jl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, remat="none")
    fns = build_train_step(
        loss_fn=lambda p, b: jl.loss_fn(p, b, cfg), optimizer=agd(1e-3),
        init_params_fn=lambda rng: jl.init_params(rng, cfg),
        param_axes=jl.param_logical_axes(cfg), mesh_ctx=ctx,
        rules=default_rules(fsdp=True, tensor_parallel=True))
    st = fns.init_state(jax.random.PRNGKey(0))
    _, m = fns.train_step(st, jax.device_put(
        {"tokens": jnp.asarray(inputs["batches"][0])}, fns.batch_sharding))
    jmesh.destroy_parallel_mesh()
    return float(m["loss"])


def _spawn(work, case, world, per_node):
    port = get_free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   DLROVER_TPU_PROCESS_RANK=str(rank),
                   DLROVER_TPU_PROCESS_COUNT=str(world),
                   DLROVER_TPU_LOCAL_RANK=str(rank % per_node),
                   DLROVER_TPU_NODE_INDEX=str(rank // per_node),
                   DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests/torch_mixed_mesh_worker.py"),
             str(work / "in.npz"), str(work), case],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _wait(procs, timeout=240):
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


def _run(case, world, rows, seq, jax_side):
    work = Path(tempfile.mkdtemp(prefix="dhm", dir="/tmp"))
    try:
        inputs = _inputs(rows, seq)
        np.savez(work / "in.npz", **inputs)
        procs = _spawn(work, case, world, world // 2)
        try:
            want = jax_side(inputs)
        finally:
            _wait(procs)
        port = torch.load(work / f"{case}.pt", weights_only=False)
        bf16 = work / "bf16_loss.pt"
        if bf16.exists():
            port["bf16_loss"] = float(torch.load(bf16))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"port": port, "jax": want, "inputs": inputs}


@pytest.fixture(scope="module")
def hybrid8():
    def jax_side(inputs):
        out = _jax_one_device(inputs)
        out["hybrid_bf16_loss0"] = _jax_hybrid_dry_run_loss(inputs)
        return out

    # the mixed mesh's batch shape (8 rows of 64 + 1): at the dry run's
    # 32 + 1 the port's ONE-device step already sits past PARAM_ATOL
    # from the JAX one's after two AGD steps, with no mesh at all
    # (test_one_device_steps_at_the_dry_runs_length_as_in_jax, ROADMAP
    # §C); the zeros batch's loss does not depend on the length
    return _run("hybrid8", 8, 8, 64, jax_side)


@pytest.fixture(scope="module")
def hybrid32():
    return _run("hybrid32", 32, 16, 64, _jax_one_device)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _big(dims):
    return {k: v for k, v in dims.items() if v > 1}


def _check_steps(runs):
    port, want = runs["port"], runs["jax"]
    for step in (0, 1):
        loss, norm = port["metrics"][step]
        _close(loss, want[f"loss{step}"], ONE_LOSS_ATOL)
        _close(norm, want[f"norm{step}"], NORM_ATOL)
    got = port["params"]
    assert {f"p/{k}" for k in got} == {k for k in want if k.startswith("p/")}
    for k, v in got.items():
        _close(v.numpy(), want[f"p/{k}"], PARAM_ATOL)
    init = runs["inputs"]
    assert max(float(np.abs(v.numpy() - init[f"p/{k}"]).max())
               for k, v in got.items()) > 1e-4


def test_hybrid8_reads_the_recorded_dry_run_loss(hybrid8):
    """The dry run computes in bf16: the JAX hybrid step on 8 devices
    reads the recorded loss, and the port's 8 gloo ranks in bf16 read it
    within one bf16 ulp (2**-6 between 2 and 4: the two packages round
    their bf16 products and sums at other places; in fp32 they agree to
    5e-5, below)."""
    assert round(hybrid8["jax"]["hybrid_bf16_loss0"], 4) == RECORDED_LOSS
    assert abs(hybrid8["port"]["bf16_loss"] - RECORDED_LOSS) < BF16_ULP


def test_hybrid8_steps_match_the_jax_single_device_step(hybrid8):
    assert _big(hybrid8["port"]["dims"]) == {"data": 2, "fsdp": 2,
                                             "tensor": 2}
    _check_steps(hybrid8)


def test_hybrid32_steps_match_the_jax_single_device_step(hybrid32):
    dims = hybrid32["port"]["dims"]
    assert list(dims)[0] == "data"  # the DCN axis, outermost
    assert _big(dims) == {"data": 2, "pipe": 2, "fsdp": 2, "seq": 2,
                          "tensor": 2}
    _check_steps(hybrid32)



def test_one_device_steps_at_the_dry_runs_length_as_in_jax(capsys):
    """The hybrid checks above run at 8 rows of 64 + 1 tokens.  At the
    dry run's 32 + 1 the port's ONE-device fp32 step already sits at
    ``PARAM_ATOL`` from the JAX package's after two AGD steps (ROADMAP
    §C): the losses and grad norms agree as above, and the first step's
    params within ``PARAM_ATOL``; but the second step's preconditioner
    is the square of the difference of two nearly equal bias-corrected
    first moments, so the few-ulp gradient differences of the two
    packages' reduction orders come out as a percent of an element's
    step.  Held to the readings (2.119e-05 in one ``layers/wk`` element
    that the two steps move by 1.2e-03), printed with ``-s``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_mixed_mesh_worker", REPO / "tests/torch_mixed_mesh_worker.py")
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    inputs = _inputs(8, 32)
    port = {}
    work = Path(tempfile.mkdtemp(prefix="dhm", dir="/tmp"))
    try:
        np.savez(work / "in.npz", **inputs)
        for steps in (1, 2):
            worker.run("one", np.load(work / "in.npz"), str(work), 0,
                       steps=steps)
            port[steps] = torch.load(work / "one.pt", weights_only=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = {1: _jax_one_device(dict(inputs, batches=inputs["batches"][:1])),
            2: _jax_one_device(inputs)}
    for step in (0, 1):
        loss, norm = port[2]["metrics"][step]
        _close(loss, want[2][f"loss{step}"], ONE_LOSS_ATOL)
        _close(norm, want[2][f"norm{step}"], NORM_ATOL)
    worst = {}
    for steps in (1, 2):
        worst[steps] = max(
            (float(np.abs(v.numpy() - want[steps][f"p/{k}"]).max()), k)
            for k, v in port[steps]["params"].items())
    dev, key = worst[2]
    d = np.abs(port[2]["params"][key].numpy() - want[2][f"p/{key}"])
    at = np.unravel_index(d.argmax(), d.shape)
    moved = abs(float(want[2][f"p/{key}"][at] - inputs[f"p/{key}"][at]))
    with capsys.disabled():
        print(f"\none device, 8 x 33: the port's params within "
              f"{worst[1][0]:.4g} of JAX's after one AGD step, {dev:.4g} "
              f"after two ({key}{tuple(map(int, at))}, which the two steps "
              f"move by {moved:.4g})")
    assert worst[1][0] < PARAM_ATOL
    assert key == "layers/wk" and PARAM_ATOL < dev < 1.1 * PARAM_ATOL
    assert 1.1e-3 < moved < 1.3e-3
