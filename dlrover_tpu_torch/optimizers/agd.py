"""AGD (NeurIPS'23) as a ``torch.optim.Optimizer``.

Port of ``dlrover_tpu/optimizers/agd.py:26-102`` (the optax
transformation, itself the dense path of atorch's AGD).  The second
moment tracks the stepwise difference of bias-corrected first moments,
``diff = m_t / bc1_t - m_{t-1} / bc1_{t-1}`` (``m_1 / bc1_1`` on the
first step), instead of the squared gradient; the step is
``-lr * sqrt(bc2) / bc1 * m / max(sqrt(v), delta * sqrt(bc2))``, clipped
to ``[-clip, clip]`` before the learning rate when ``clip`` is set, with
decoupled weight decay ``- lr * weight_decay * p``.

State per parameter: fp32 ``exp_avg``, ``exp_avg_sq`` (and
``max_exp_avg_sq`` with ``amsgrad``) and the step count.  The update is
done with ``torch._foreach_*`` ops over buckets of parameters, so its
temporaries stay within ``BUCKET_ELEMENTS`` fp32 elements at a time.
"""

import math
from typing import Iterable, List, Optional, Tuple

import torch

#: fp32 elements of parameters updated together (two temporaries each)
BUCKET_ELEMENTS = 1 << 28


class AGD(torch.optim.Optimizer):
    def __init__(
        self,
        params: Iterable,
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        delta: float = 1e-5,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        clip: Optional[float] = None,
    ):
        if lr < 0.0 or delta <= 0.0 or weight_decay < 0.0:
            raise ValueError("AGD needs lr >= 0, delta > 0, weight_decay >= 0")
        if not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"AGD betas must lie in [0, 1), got {betas}")
        defaults = dict(lr=lr, betas=tuple(betas), delta=delta,
                        weight_decay=weight_decay, amsgrad=amsgrad, clip=clip)
        super().__init__(params, defaults)

    def init_state(self):
        """Create every parameter's state now (it is otherwise made at
        its first step); on ``meta`` parameters this sizes the state
        without touching memory."""
        for group in self.param_groups:
            for p in group["params"]:
                self._state_of(p, group)

    def _state_of(self, p, group):
        st = self.state[p]
        if not st:
            st["step"] = 0
            st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            if group["amsgrad"]:
                st["max_exp_avg_sq"] = torch.zeros_like(
                    p, dtype=torch.float32)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            by_step = {}
            for p in params:
                st = self._state_of(p, group)
                st["step"] += 1
                by_step.setdefault(st["step"], []).append(p)
            for step, ps in by_step.items():
                for bucket in _buckets(ps):
                    self._update(group, step, bucket)
        return loss

    def _update(self, group, step: int, params: List[torch.Tensor]):
        b1, b2 = group["betas"]
        lr, clip = group["lr"], group["clip"]
        bc1_old = 1.0 - b1 ** (step - 1)
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        states = [self.state[p] for p in params]
        m = [s["exp_avg"] for s in states]
        v = [s["exp_avg_sq"] for s in states]
        grads = [p.grad.float() for p in params]

        old = None if step == 1 else torch._foreach_div(
            m, max(bc1_old, 1e-12))
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        del grads
        diff = torch._foreach_div(m, bc1)
        if old is not None:
            torch._foreach_sub_(diff, old)
            del old
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, diff, diff, value=1.0 - b2)
        del diff
        precond = v
        if group["amsgrad"]:
            precond = [s["max_exp_avg_sq"] for s in states]
            torch._foreach_maximum_(precond, v)

        denom = torch._foreach_sqrt(precond)
        torch._foreach_clamp_min_(denom, group["delta"] * math.sqrt(bc2))
        u = torch._foreach_div(m, denom)
        del denom
        if clip is not None:
            torch._foreach_clamp_min_(u, -clip)
            torch._foreach_clamp_max_(u, clip)
        torch._foreach_mul_(u, -lr * math.sqrt(bc2) / bc1)
        if group["weight_decay"]:
            # decoupled decay on the parameter before this update
            torch._foreach_add_(
                u, [p.float() for p in params],
                alpha=-lr * group["weight_decay"],
            )
        torch._foreach_add_(params, [x.to(p.dtype) for x, p in
                                     zip(u, params)])


def _buckets(params: List[torch.Tensor]):
    """Consecutive runs of parameters of one device and dtype, each at
    most ``BUCKET_ELEMENTS`` elements (or one larger parameter)."""
    bucket, size, key = [], 0, None
    for p in params:
        k = (p.device, p.dtype)
        if bucket and (k != key or size + p.numel() > BUCKET_ELEMENTS):
            yield bucket
            bucket, size = [], 0
        bucket.append(p)
        size += p.numel()
        key = k
    if bucket:
        yield bucket
