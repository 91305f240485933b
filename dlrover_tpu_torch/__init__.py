"""dlrover_tpu_torch — the PyTorch / CUDA port of ``dlrover_tpu``.

This package serves the Llama family through the paged-KV
continuous-batching scheduler, and trains it (forward, loss, backward,
AGD, the trainer loop, flash checkpoint), one NVIDIA Hopper card a
process, under the elastic launch (``python -m dlrover_tpu_torch.run``:
a local master, the node's agent, its workers).  It imports
``torch`` and never ``jax``, and nothing of ``dlrover_tpu``: what it
needs from there it keeps as its own copy.

Layout (each module names its JAX counterpart in its docstring):

- ``common/``  env knobs (the same ``DLROVER_TPU_*`` variables), device
  resolution, the control-plane messages and their gRPC transport;
- ``master/``  the local job master (rendezvous, KV store, job manager,
  dataset shards);
- ``agent/``   the node's agent (spawns, watches and restarts the
  workers), its master client and the flash-checkpoint saver;
- ``run.py``   the launcher, ``python -m dlrover_tpu_torch.run``;
- ``ops/``     the hand-written CUDA kernels (``ops/csrc``), their build,
  their wrappers and plain PyTorch versions;
- ``models/``  the Llama training forward and loss, the paged serving
  steps and the JAX-params converter;
- ``optimizers/`` AGD;
- ``parallel/`` the one-device train step (``build_train_step``);
- ``accelerate/`` ``auto_accelerate`` with the one-device strategy;
- ``trainer/`` the training loop (``Trainer``, ``TrainingArgs``), flash
  checkpoint, the worker's side of the elastic launch (``elastic/``,
  the drain and the hang detector);
- ``examples/`` ``python -m dlrover_tpu_torch.examples.llama_pretrain``;
- ``rl/``      the block pool, the sampler and the scheduler.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU they raise.  A kernel wrapper takes its
plain version only for a tensor on the CPU: a CUDA tensor launches the
kernel or raises.
"""
