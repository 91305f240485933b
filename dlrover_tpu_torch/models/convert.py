"""Params from the JAX package's pytree.

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
