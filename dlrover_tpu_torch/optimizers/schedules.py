"""Learning-rate schedules: a name-keyed registry of ``step -> lr``
functions.

Port of ``dlrover_tpu/optimizers/schedules.py``: the same names, the
same ``get_scheduler`` arguments and the same values.  The reference
builds each schedule from optax (``linear_schedule``,
``cosine_decay_schedule``, ``polynomial_schedule``,
``join_schedules``); here each is a plain Python function of the step
with optax's formulas written out, so nothing imports optax.  Python
computes in float64 where optax computes in float32, so the two agree to
float32 rounding (``tests/test_torch_schedules_wsam.py`` holds every
name against optax).

The reference puts the schedule inside the optax optimizer, so its
position is the optimizer state's step count; here the caller reads
``schedule(step)`` and hands the value to its optimizer, and
``Trainer(lr_schedule=...)`` logs it per step (the Nth update applied
``schedule(N - 1)``, as in optax).

Names: ``constant``, ``constant_with_warmup``, ``linear``, ``cosine``,
``cosine_with_min_lr``, ``polynomial``, ``inverse_sqrt``, ``wsd``
(warmup-stable-decay).
"""

import math
from typing import Callable, Optional, Sequence

Schedule = Callable[[int], float]
SchedulerFn = Callable[..., Schedule]

_REGISTRY = {}


def register_scheduler(name: str):
    def deco(fn: SchedulerFn) -> SchedulerFn:
        _REGISTRY[name] = fn
        return fn

    return deco


def available_schedulers():
    return sorted(_REGISTRY)


def get_scheduler(
    name: str,
    learning_rate: float,
    total_steps: Optional[int] = None,
    warmup_steps: int = 0,
    **kwargs,
) -> Schedule:
    """Build a ``step -> lr`` schedule by name.

    ``total_steps`` is required by decaying schedules (linear/cosine/
    polynomial/wsd); warmup always ramps linearly from 0 over
    ``warmup_steps``.
    """
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown scheduler {name!r}; available: "
            f"{available_schedulers()}"
        )
    decaying = name in (
        "linear", "cosine", "cosine_with_min_lr", "polynomial", "wsd"
    )
    if decaying and not total_steps:
        raise ValueError(f"scheduler {name!r} requires total_steps")
    return _REGISTRY[name](
        learning_rate=learning_rate,
        total_steps=total_steps,
        warmup_steps=warmup_steps,
        **kwargs,
    )


# -- optax's building blocks, as plain functions ----------------------------


def constant_schedule(value: float) -> Schedule:
    return lambda step: float(value)


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    """``optax.polynomial_schedule`` (transition from step 0)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(step):
        count = min(max(step, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``."""
    return polynomial_schedule(init_value, end_value, 1, transition_steps)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(
            "the cosine schedule requires positive decay_steps, got "
            f"{decay_steps}")

    def schedule(step):
        count = min(step, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule,
    counting its steps from the boundary."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = nxt(step - boundary)
        return float(out)

    return schedule


def _with_warmup(base: Schedule, learning_rate: float,
                 warmup_steps: int) -> Schedule:
    if warmup_steps <= 0:
        return base
    warmup = linear_schedule(0.0, learning_rate, warmup_steps)
    return join_schedules([warmup, base], [warmup_steps])


@register_scheduler("constant")
def _constant(learning_rate, total_steps, warmup_steps, **_):
    return _with_warmup(
        constant_schedule(learning_rate), learning_rate, warmup_steps)


@register_scheduler("constant_with_warmup")
def _constant_with_warmup(learning_rate, total_steps, warmup_steps, **_):
    return _with_warmup(
        constant_schedule(learning_rate), learning_rate,
        max(warmup_steps, 1))


@register_scheduler("linear")
def _linear(learning_rate, total_steps, warmup_steps, end_value=0.0, **_):
    decay = linear_schedule(
        learning_rate, end_value, max(total_steps - warmup_steps, 1))
    return _with_warmup(decay, learning_rate, warmup_steps)


@register_scheduler("cosine")
def _cosine(learning_rate, total_steps, warmup_steps, **_):
    decay = cosine_decay_schedule(
        learning_rate, max(total_steps - warmup_steps, 1))
    return _with_warmup(decay, learning_rate, warmup_steps)


@register_scheduler("cosine_with_min_lr")
def _cosine_min(learning_rate, total_steps, warmup_steps, min_lr_ratio=0.1,
                **_):
    decay = cosine_decay_schedule(
        learning_rate, max(total_steps - warmup_steps, 1),
        alpha=min_lr_ratio)
    return _with_warmup(decay, learning_rate, warmup_steps)


@register_scheduler("polynomial")
def _polynomial(learning_rate, total_steps, warmup_steps, power=1.0,
                end_value=1e-7, **_):
    decay = polynomial_schedule(
        learning_rate, end_value, power, max(total_steps - warmup_steps, 1))
    return _with_warmup(decay, learning_rate, warmup_steps)


@register_scheduler("inverse_sqrt")
def _inverse_sqrt(learning_rate, total_steps, warmup_steps, **_):
    shift = max(warmup_steps, 1)

    def decay(step):
        return learning_rate * (shift / (step + shift)) ** 0.5

    # joined at the warmup boundary, which rebases the step to 0 there:
    # what ``shift`` expects
    return _with_warmup(decay, learning_rate, warmup_steps)


@register_scheduler("wsd")
def _wsd(learning_rate, total_steps, warmup_steps, decay_ratio=0.1,
         min_lr_ratio=0.0, **_):
    """Warmup-Stable-Decay: hold the peak LR for most of training and
    decay linearly over the final ``decay_ratio`` fraction (checkpoints
    mid-plateau resume into longer runs without an LR mismatch)."""
    decay_steps = max(int(total_steps * decay_ratio), 1)
    stable_steps = max(total_steps - warmup_steps - decay_steps, 0)
    decay = linear_schedule(
        learning_rate, learning_rate * min_lr_ratio, decay_steps)
    tail = join_schedules(
        [constant_schedule(learning_rate), decay], [stable_steps])
    return _with_warmup(tail, learning_rate, warmup_steps)
