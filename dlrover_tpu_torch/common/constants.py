"""Flash-checkpoint layout names.

The ``CheckpointConstant`` part of ``dlrover_tpu/common/constants.py``
(the rest of that module belongs to the control plane, ROADMAP A3b).
Both packages write the same directory layout, so a checkpoint
committed by either is found by the other.
"""


class CheckpointConstant:
    """Flash-checkpoint layout names (reference:
    ``common/constants.py`` ``CheckpointConstant`` +
    ``elastic_agent/torch/ckpt_saver.py`` stage-dir protocol)."""

    CKPT_DIR_PREFIX = "checkpoint-"
    STAGE_DIR = "._dlrover_ckpt_stage"
    STEP_FILE = "latest_step.txt"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    SAVE_TIMEOUT = 600
