"""Serving env knobs — the port's own copy of the five readers in
``dlrover_tpu/common/env.py`` (``kv_incremental_enabled`` ..
``decode_steps``).  Same variable names, same defaults, same clamping,
so one environment configures either package identically."""

import os

KV_INCREMENTAL_ENV = "DLROVER_TPU_KV_INCREMENTAL"
KV_GROW_BLOCKS_ENV = "DLROVER_TPU_KV_GROW_BLOCKS"
KV_ADMIT_WATERMARK_ENV = "DLROVER_TPU_KV_ADMIT_WATERMARK"
KV_PREFIX_CACHE_ENV = "DLROVER_TPU_KV_PREFIX_CACHE"
DECODE_STEPS_ENV = "DLROVER_TPU_DECODE_STEPS"

_OFF = ("0", "false", "off")


def env_float(name: str, default: float) -> float:
    """Float env knob with a default (malformed values fall back)."""
    try:
        return float(os.getenv(name, "") or default)
    except ValueError:
        return default


def kv_incremental_enabled() -> bool:
    """Incremental allocation (watermark admission, on-demand growth,
    preemption, prefix caching); ``=0`` selects worst-case reservation
    admission.  Default: enabled."""
    return os.getenv(KV_INCREMENTAL_ENV, "1").lower() not in _OFF


def kv_grow_blocks() -> int:
    """Blocks of headroom an admitted sequence reserves beyond its
    prompt, and the quantum its table grows by (>= 1)."""
    return max(1, int(env_float(KV_GROW_BLOCKS_ENV, 2)))


def kv_admit_watermark() -> float:
    """Share of the usable pool that must stay free after a new
    admission (incremental mode), clamped to [0, 0.9]."""
    return min(max(env_float(KV_ADMIT_WATERMARK_ENV, 0.1), 0.0), 0.9)


def kv_prefix_cache_enabled() -> bool:
    """Content-hashed sharing of full prompt blocks (incremental mode
    only).  Default: enabled."""
    return os.getenv(KV_PREFIX_CACHE_ENV, "1").lower() not in _OFF


def decode_steps() -> int:
    """K decode steps per scheduler iteration: K greedy self-drafting
    steps plus one verify forward when K > 1.  Default 1."""
    return max(1, int(env_float(DECODE_STEPS_ENV, 1)))
