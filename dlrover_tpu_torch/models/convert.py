"""Params from the JAX package's pytree, and the train state under the
JAX package's key paths (``train_state_leaves``, below: the state
counterpart of ``params_from_jax``, which flash checkpoint names its
shards' leaves by).

``dlrover_tpu/models/llama.py:init_params`` builds a nested dict of fp32
arrays: ``embed [V, D]``, ``layers`` (each leaf stacked on dim 0,
projections ``[in, out]``), ``final_norm [D]``, ``lm_head [D, V]``.
The port keeps that layout, so conversion is a leaf-by-leaf copy of
the same arrays (handed over as numpy) onto the device in the serving
dtype.  Nothing here imports JAX: the caller converts its arrays with
``numpy.asarray``.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device


def params_from_jax(
    tree: Dict[str, Any],
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = torch.bfloat16,
) -> Dict[str, Any]:
    """Nested dict of numpy arrays (the JAX params) -> the same nested
    dict of tensors on ``device`` in ``dtype`` (``None`` keeps each
    array's own dtype)."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))  # a writable host copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


# -- the train state under the JAX package's key paths ----------------------
#
# ``dlrover_tpu/parallel/train_step.py:79 make_train_state`` is
# ``{"step": int32 [], "params": ..., "opt_state": optimizer.init(params)}``
# and a ``.drckpt`` shard names each leaf by ``jax.tree_util.keystr`` of
# its path in that tree.  The port's state is ``{"step": int, "params":
# the same nested dict, "opt_state": torch.optim.Optimizer}``; the
# functions below name the port's leaves by the JAX paths of the same
# logical leaves, in JAX's flatten order (dict keys sorted), so a shard
# written by either package restores in the other:
#
# - ``AGDState(step, exp_avg, exp_avg_sq, max_exp_avg_sq)``
#   (``optimizers/agd.py:19``): ``['opt_state'].step`` is the port's
#   per-parameter step count (equal for every parameter), and
#   ``['opt_state'].exp_avg['layers']['wq']`` the state of that param.
# - ``QuantizedMomentsState(step, mu, nu)`` (``optimizers/low_bit.py:58``)
#   whose moments are ``_QTensor``s flattened as ``(q, scales)``:
#   ``['opt_state'].mu[<path>][<flat index 0>]`` is ``mu_q``, ``[<flat
#   index 1>]`` ``mu_scales``; the step is every group's ``"step"``.


class HostScalar:
    """A Python number of the train state (the step, an optimizer's step
    count) seen as a 0-d leaf of ``dtype``: ``get()`` reads it, ``set(v)``
    writes it back on restore."""

    def __init__(self, get, set, dtype: str = "int32"):
        self.get = get
        self.set = set
        self.dtype = dtype

    def value(self) -> np.ndarray:
        return np.asarray(self.get(), dtype=self.dtype)


def _dict_paths(node, prefix: str = ""):
    """``(keystr, leaf)`` of a nested dict in JAX's order (sorted keys)."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _dict_paths(node[k], f"{prefix}['{k}']")
    else:
        yield prefix, node


def is_train_state(tree) -> bool:
    return (isinstance(tree, dict) and "params" in tree
            and isinstance(tree.get("opt_state"), torch.optim.Optimizer))


def _same_int(values, what: str) -> int:
    values = {int(v) for v in values}
    if len(values) != 1:
        raise ValueError(f"{what} differs across parameters: {values}")
    return values.pop()


def train_state_leaves(state):
    """``[(JAX keystr, leaf)]`` of a port train state, in JAX's flatten
    order.  A leaf is a tensor of the state (restored in place) or a
    :class:`HostScalar`."""
    params, opt = state["params"], state["opt_state"]
    param_paths = list(_dict_paths(params))
    # deferred: the optimizers import the kernels' module tree
    from dlrover_tpu_torch.optimizers.agd import AGD
    from dlrover_tpu_torch.optimizers.low_bit import QuantizedMoments

    out = []
    if isinstance(opt, AGD):
        states = [opt.state[p] for _, p in param_paths]
        if any(not st for st in states):
            raise ValueError("AGD state is not initialised (init_state())")

        def set_step(v):
            for st in states:
                st["step"] = int(v)

        out.append(("['opt_state'].step", HostScalar(
            lambda: _same_int((st["step"] for st in states),
                              "AGD step"), set_step)))
        names = ["exp_avg", "exp_avg_sq"]
        if all("max_exp_avg_sq" in st for st in states):
            names.append("max_exp_avg_sq")
        for name in names:
            for (path, _), st in zip(param_paths, states):
                out.append((f"['opt_state'].{name}{path}", st[name]))
    elif isinstance(opt, QuantizedMoments):
        groups = opt.param_groups

        def set_group_step(v):
            for g in groups:
                g["step"] = int(v)

        out.append(("['opt_state'].step", HostScalar(
            lambda: _same_int((g["step"] for g in groups),
                              "QuantizedMoments step"), set_group_step)))
        for moment in ("mu", "nu"):
            for path, p in param_paths:
                st = opt._state_of(p)
                out.append((f"['opt_state'].{moment}{path}[<flat index 0>]",
                            st[f"{moment}_q"]))
                out.append((f"['opt_state'].{moment}{path}[<flat index 1>]",
                            st[f"{moment}_scales"]))
    else:
        raise NotImplementedError(
            f"no checkpoint key paths for {type(opt).__name__}: the JAX "
            "package's states are AGDState and QuantizedMomentsState")
    out.extend((f"['params']{path}", p) for path, p in param_paths)

    def set_state_step(v):
        state["step"] = int(v)

    out.append(("['step']", HostScalar(lambda: state["step"],
                                       set_state_step)))
    return out
