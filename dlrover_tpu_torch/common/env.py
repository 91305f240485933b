"""Env knobs — the port's own copy of readers in
``dlrover_tpu/common/env.py``: the five serving ones
(``kv_incremental_enabled`` .. ``decode_steps``), the process identity
a checkpoint shard is named by (``get_process_rank`` ..
``get_local_process_count``) and the checkpoint engine's close timeout
(``ckpt_close_timeout_s``).  Same variable names,
same defaults, same clamping, so one environment configures either
package identically."""

import os

KV_INCREMENTAL_ENV = "DLROVER_TPU_KV_INCREMENTAL"
KV_GROW_BLOCKS_ENV = "DLROVER_TPU_KV_GROW_BLOCKS"
KV_ADMIT_WATERMARK_ENV = "DLROVER_TPU_KV_ADMIT_WATERMARK"
KV_PREFIX_CACHE_ENV = "DLROVER_TPU_KV_PREFIX_CACHE"
DECODE_STEPS_ENV = "DLROVER_TPU_DECODE_STEPS"
CKPT_CLOSE_TIMEOUT_ENV = "DLROVER_TPU_CKPT_CLOSE_TIMEOUT_S"
# process identity (``NodeEnv`` of the JAX package's constants)
NODE_ID_ENV = "DLROVER_TPU_NODE_ID"
NODE_RANK_ENV = "DLROVER_TPU_NODE_RANK"
PROCESS_RANK_ENV = "DLROVER_TPU_PROCESS_RANK"
PROCESS_COUNT_ENV = "DLROVER_TPU_PROCESS_COUNT"
LOCAL_PROCESS_COUNT_ENV = "DLROVER_TPU_LOCAL_PROCESS_COUNT"

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


def _get_int(name: str, default: int = 0) -> int:
    try:
        return int(os.getenv(name, ""))
    except (TypeError, ValueError):
        return default


def get_node_rank() -> int:
    return _get_int(NODE_RANK_ENV, _get_int(NODE_ID_ENV, 0))


def get_process_rank() -> int:
    return _get_int(PROCESS_RANK_ENV, 0)


def get_process_count() -> int:
    return _get_int(PROCESS_COUNT_ENV, 1)


def get_local_process_count() -> int:
    return _get_int(LOCAL_PROCESS_COUNT_ENV, 1)


def ckpt_close_timeout_s() -> float:
    """How long ``CheckpointEngine.close()`` waits for an in-flight
    snapshot drain before leaving its handles open (closing under a
    live drain would corrupt the persist)."""
    return env_float(CKPT_CLOSE_TIMEOUT_ENV, 300.0)
