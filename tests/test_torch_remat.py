"""The port's ``remat="dots"`` against the JAX package's, on the CPU.

- At ``LlamaConfig.tiny(remat="dots")`` in fp32 the loss and grads equal
  the JAX package's (``jax.checkpoint`` with
  ``checkpoint_dots_with_no_batch_dims``) on converted params (1e-5), and
  equal the port's own ``"none"`` and ``"full"`` bit for bit: a policy
  changes what is stored, not what is computed.
- The backward's products (``aten.mm``, counted by a dispatch mode
  entered outside the checkpoint around ``autograd.grad``): under dots as
  many as under none, none recomputed; under full 6 more a layer, the
  forward's projections but ``w_down``'s, whose output no backward reads
  (the checkpoint's recompute stops before it).  A mode entered inside
  the checkpoint (``counting_dots`` of ``tests/torch_mixed_mesh_worker.py``
  wraps ``llama._dots_contexts``) sees the 7 projections a layer saved in
  the forward and the 6 the recompute takes from the cache, so the outer
  count cannot pass by not looking.
- Dots under the gloo ``{pipe 2, tensor 2}`` step (4 ranks,
  ``tests/torch_mixed_mesh_worker.py`` case ``p2t2dots``: the per-layer
  selective checkpoint nested in the pipeline's chunk checkpoint) equals
  the JAX package's sharded step with dots on the same mesh: loss and
  grad norm of two AGD steps (1e-5, 1e-4) and the params (2e-5), the
  tolerances of ``tests/test_torch_model_parallel.py``.
- An unknown policy raises.
"""

import os
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.parallel.train_step import param_leaves  # noqa: E402
from torch_mixed_mesh_worker import counting_dots  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
LOSS_ATOL, NORM_ATOL, PARAM_ATOL = 1e-5, 1e-4, 2e-5
LAYERS = 2
PROJECTIONS = 7  # wq, wk, wv, wo, w_gate, w_up, w_down


class _Products(TorchDispatchMode):
    """Counts every aten op that reaches it."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def case():
    jcfg = jl.LlamaConfig.tiny(remat="dots", dtype=jnp.float32)
    jp = jl.init_params(jax.random.PRNGKey(5), jcfg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    loss, grads = jax.value_and_grad(
        lambda p: jl.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg))(jp)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return {"npp": npp, "tokens": tokens, "loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in _flat(grads).items()}}


def _port(case, remat):
    """The port's loss, grads and the backward's op counts."""
    cfg = tl.LlamaConfig.tiny(remat=remat, dtype=torch.float32)
    params = params_from_jax(case["npp"], device="cpu", dtype=torch.float32)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with counting_dots(tl) as dots:
        loss = tl.loss_fn(params,
                          {"tokens": torch.from_numpy(case["tokens"])}, cfg)
        with _Products() as backward:
            grads = torch.autograd.grad(loss, leaves)
    names = list(_flat(params))
    return {"loss": loss.detach(), "grads": dict(zip(names, grads)),
            "backward": backward.ops, "dots": dict(dots)}


def test_dots_loss_and_grads_match_jax_dots(case):
    got = _port(case, "dots")
    np.testing.assert_allclose(float(got["loss"]), case["loss"], atol=ATOL,
                               rtol=0)
    assert set(got["grads"]) == set(case["grads"])
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), case["grads"][k], atol=ATOL,
                                   rtol=0, err_msg=k)


def test_dots_equals_none_and_full_bit_for_bit(case):
    runs = {r: _port(case, r) for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        assert torch.equal(runs[r]["loss"], runs["none"]["loss"]), r
        for k, g in runs[r]["grads"].items():
            assert torch.equal(g, runs["none"]["grads"][k]), (r, k)


def test_dots_backward_recomputes_no_projection(case):
    runs = {r: _port(case, r) for r in ("none", "full", "dots")}
    mm = {r: runs[r]["backward"]["aten.mm.default"] for r in runs}
    # each projection's dA and dW, and the head's: no recompute
    assert mm["dots"] == mm["none"] > 0
    assert mm["full"] - mm["none"] == (PROJECTIONS - 1) * LAYERS
    # the inner count looked: every projection kept, and all but the
    # last of each layer handed back from the cache in the recompute
    assert runs["dots"]["dots"] == {"saved": PROJECTIONS * LAYERS,
                                    "replayed": (PROJECTIONS - 1) * LAYERS}
    assert runs["none"]["dots"] == runs["full"]["dots"] == {}
    # the plain attention's batched products are recomputed as under full
    bmm = {r: runs[r]["backward"]["aten.bmm.default"] for r in runs}
    assert bmm["dots"] == bmm["full"] > bmm["none"]


def test_unknown_remat_policy_raises(case):
    cfg = tl.LlamaConfig.tiny(remat="everything", dtype=torch.float32)
    params = params_from_jax(case["npp"], device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown remat policy"):
        tl.loss_fn(params, {"tokens": torch.from_numpy(case["tokens"])},
                   cfg)


# ------------------------------------------- dots under {pipe 2, tensor 2}


def _jax_p2t2_dots(npp, batches):
    from dlrover_tpu.optimizers.agd import agd
    from dlrover_tpu.parallel import mesh as jmesh
    from dlrover_tpu.parallel.sharding import default_rules
    from dlrover_tpu.parallel.train_step import build_train_step as jbuild

    jcfg = jl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=4,
                               remat="dots", dtype=jnp.float32)
    ctx = jmesh.create_parallel_mesh(
        [("pipe", 2), ("data", 1), ("fsdp", 1), ("expert", 1), ("seq", 1),
         ("tensor", 2)], devices=jax.devices()[:4])
    ctx.pipeline_microbatches = 4
    try:
        fns = jbuild(
            loss_fn=lambda p, b: jl.loss_fn(p, b, jcfg),
            optimizer=agd(1e-3),
            init_params_fn=lambda rng: jax.tree_util.tree_map(jnp.asarray,
                                                              npp),
            param_axes=jl.param_logical_axes(jcfg), mesh_ctx=ctx,
            rules=default_rules(tensor_parallel=True, pipeline=True))
        st = fns.init_state(jax.random.PRNGKey(0))
        metrics = []
        for b in batches:
            st, m = fns.train_step(st, jax.device_put(
                {"tokens": jnp.asarray(b)}, fns.batch_sharding))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        params = _flat(jax.tree_util.tree_map(np.asarray, st["params"]))
    finally:
        jmesh.destroy_parallel_mesh()
    return metrics, params


@pytest.fixture(scope="module")
def p2t2():
    jcfg = jl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=4,
                               dtype=jnp.float32)
    npp = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(7), jcfg))
    inputs = {f"p/{k}": v for k, v in _flat(npp).items()}
    inputs["batches"] = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 8, 17)).astype(np.int32)
    work = Path(tempfile.mkdtemp(prefix="drm", dir="/tmp"))
    try:
        np.savez(work / "in.npz", **inputs)
        port = get_free_port()
        procs = []
        for rank in range(4):
            env = dict(os.environ, OMP_NUM_THREADS="1",
                       DLROVER_TPU_PROCESS_RANK=str(rank),
                       DLROVER_TPU_PROCESS_COUNT="4",
                       DLROVER_TPU_LOCAL_RANK=str(rank),
                       DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                       PYTHONPATH=str(REPO))
            procs.append(subprocess.Popen(
                [sys.executable,
                 str(REPO / "tests/torch_mixed_mesh_worker.py"),
                 str(work / "in.npz"), str(work), "p2t2dots"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        want = _jax_p2t2_dots(npp, inputs["batches"])
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=150)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert all(p.returncode == 0 for p in procs), "\n".join(
            o[-3000:] for o in outs)
        got = torch.load(work / "p2t2dots.pt", weights_only=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return got, want


def test_dots_under_pipe_and_tensor_matches_the_jax_sharded_step(p2t2):
    got, (metrics, params) = p2t2
    assert got["dims"]["pipe"] == 2 and got["dims"]["tensor"] == 2
    assert len(got["metrics"]) == len(metrics) == 2
    for (l, n), (wl, wn) in zip(got["metrics"], metrics):
        np.testing.assert_allclose(l, wl, atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(n, wn, atol=NORM_ATOL, rtol=0)
    assert set(got["params"]) == set(params)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), params[k], atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
    # the selective checkpoint ran inside the pipeline's chunks: stage 0
    # kept its layers' projections and took some back from the cache
    assert got["dots_counts"].get("saved", 0) > 0
    assert got["dots_counts"].get("replayed", 0) > 0
