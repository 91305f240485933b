"""AdamW with int8 moments: 1 byte per moment per parameter instead of 4.

Port of ``dlrover_tpu/optimizers/low_bit.py`` (``_QTensor`` :27,
``dequantize_qtensor`` :51, ``quantized_moments`` :64-131) as a
``torch.optim.Optimizer``.  The moments are stored blockwise-quantized
(``ops.quantization``: one fp32 scale per 1024 elements) and each step
makes one fused kernel launch per parameter (``fused_int8_adam_update``:
dequantize, Adam moment update, update value, requantize), so the fp32
moments never exist in memory.

nu is stored as sqrt(nu): linear int8 on raw nu underflows small second
moments inside a block dominated by one large value (blockwise absmax
scale) and the rsqrt then explodes the update; storing the root keeps
1e-8-class moments representable (the reference's low-bit optimizers use
nonlinear quantization maps for the same reason).

State per parameter: ``mu_q``, ``mu_scales``, ``nu_q``, ``nu_scales``
(the reference's padded layout, so a JAX state carries across byte for
byte: :func:`quantized_state_from_jax`).  ``step`` is one count for the
whole optimizer, as ``QuantizedMomentsState.step`` is: every param group
holds it as ``group["step"]`` and all advance together.

The step follows the JAX order: the fused update, then ``upd -= lr *
weight_decay * p`` when ``weight_decay`` is set, then ``p += upd``
(``optax.apply_updates``).  The update is written into the grad's own
storage, which the step consumes (an fp32 grad is overwritten), and the
moments are updated in place, so no parameter-sized temporary is made.
Nothing in ``step()`` waits for the device.
"""

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ops.quantization import (
    bias_corrections,
    dequantize_blockwise,
    fused_int8_adam_update,
    quantize_blockwise,
)

STATE_KEYS = ("mu_q", "mu_scales", "nu_q", "nu_scales")


@dataclass
class QTensor:
    """A quantized tensor: int8 payload ``[P/128, 128]``, fp32 scales
    ``[n_blocks, 1]``, the original shape and element count."""

    q: torch.Tensor
    scales: torch.Tensor
    shape: Tuple[int, ...]
    n: int


def dequantize_qtensor(t: QTensor) -> torch.Tensor:
    """Materialize a quantized moment in fp32 (inspection; the training
    path never does this: the fused kernel dequantizes in registers)."""
    return dequantize_blockwise(t.q, t.scales, (t.shape, t.n))


class QuantizedMoments(torch.optim.Optimizer):
    def __init__(
        self,
        params: Iterable,
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
    ):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(
                "QuantizedMoments needs lr, eps and weight_decay >= 0")
        if not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"betas must lie in [0, 1), got {betas}")
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay, step=0)
        super().__init__(params, defaults)

    def init_state(self):
        """Quantize every parameter's zero moments now (they are
        otherwise made at its first step), as ``init_fn`` does; on
        ``meta`` parameters this sizes the state without touching
        memory."""
        for group in self.param_groups:
            for p in group["params"]:
                self._state_of(p)

    def _state_of(self, p: torch.Tensor) -> Dict[str, Any]:
        st = self.state[p]
        if not st:
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            st["mu_q"], st["mu_scales"], _ = quantize_blockwise(zeros)
            st["nu_q"], st["nu_scales"], _ = quantize_blockwise(zeros)
        return st

    def moments(self, p: torch.Tensor) -> Tuple[QTensor, QTensor]:
        """``(mu, sqrt(nu))`` of ``p`` as :class:`QTensor`."""
        st = self.state[p]
        shape, n = tuple(p.shape), p.numel()
        return (QTensor(st["mu_q"], st["mu_scales"], shape, n),
                QTensor(st["nu_q"], st["nu_scales"], shape, n))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            group["step"] += 1
            b1, b2 = group["betas"]
            bc1, bc2 = bias_corrections(b1, b2, group["step"])
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                g = p.grad
                if g is None:
                    continue
                st = self._state_of(p)
                # the update goes into the grad's storage where it can
                out = (g if g.dtype == torch.float32 and g.is_contiguous()
                       else None)
                upd = fused_int8_adam_update(
                    g, *(st[k] for k in STATE_KEYS),
                    (tuple(p.shape), p.numel()), bc1, bc2, lr=lr, b1=b1,
                    b2=b2, eps=group["eps"], out=out, inplace=True,
                )[0]
                if wd:
                    upd.sub_(p, alpha=lr * wd)
                p.add_(upd)
        return loss


def quantized_state_from_jax(jax_state, params: Dict, optimizer:
                             QuantizedMoments) -> QuantizedMoments:
    """Load the JAX package's ``QuantizedMomentsState`` into
    ``optimizer``, a :class:`QuantizedMoments` over
    ``param_leaves(params)`` (``params`` as ``params_from_jax`` made
    them).

    ``jax_state`` has the reference's fields with its leaves as numpy
    (``jax.tree_util.tree_map(np.asarray, state)``): ``step``, and
    ``mu`` / ``nu`` trees shaped like the params whose leaves carry
    ``q``, ``scales``, ``shape`` and ``n``.  Each leaf is matched to its
    parameter by key path and copied onto the parameter's device; the
    padded layouts are the same, so nothing is re-quantized."""
    params_of = {id(p) for g in optimizer.param_groups for p in g["params"]}

    def walk(p_node, mu_node, nu_node, path):
        if isinstance(p_node, dict):
            for k, v in p_node.items():
                walk(v, mu_node[k], nu_node[k], f"{path}/{k}")
            return
        if id(p_node) not in params_of:
            raise ValueError(f"{path}: not a parameter of the optimizer")
        st = optimizer.state[p_node]
        for prefix, t in (("mu", mu_node), ("nu", nu_node)):
            if tuple(t.shape) != tuple(p_node.shape) or t.n != p_node.numel():
                raise ValueError(
                    f"{path}: {prefix} is for shape {tuple(t.shape)}, n "
                    f"{t.n}; the parameter is {tuple(p_node.shape)}")
            for key, a in (("q", t.q), ("scales", t.scales)):
                # a writable host copy of the (read-only) JAX buffer
                st[f"{prefix}_{key}"] = torch.from_numpy(np.array(a)).to(
                    p_node.device)

    walk(params, jax_state.mu, jax_state.nu, "")
    step = int(jax_state.step)
    for group in optimizer.param_groups:
        group["step"] = step
    return optimizer
