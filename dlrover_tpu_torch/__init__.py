"""dlrover_tpu_torch — the PyTorch / CUDA port of ``dlrover_tpu``.

This package serves the Llama family through the paged-KV
continuous-batching scheduler on one NVIDIA Hopper card.  It imports
``torch`` and never ``jax``, and nothing of ``dlrover_tpu``: what it
needs from there it keeps as its own copy.

Layout (each module names its JAX counterpart in its docstring):

- ``common/``  env knobs (the same ``DLROVER_TPU_*`` variables) and
  device resolution;
- ``ops/``     the hand-written CUDA kernels (``ops/csrc``), their build,
  their wrappers and plain PyTorch versions;
- ``models/``  the Llama paged serving forward and the JAX-params
  converter;
- ``rl/``      the block pool, the sampler and the scheduler.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU they raise.  A kernel wrapper takes its
plain version only for a tensor on the CPU: a CUDA tensor launches the
kernel or raises.
"""
