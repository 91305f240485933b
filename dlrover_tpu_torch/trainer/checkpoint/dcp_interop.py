"""Export and import of flash checkpoints as torch DCP.

Port of ``dlrover_tpu/trainer/checkpoint/orbax_interop.py``.  The
reference converts between the private ``.drckpt`` shards (the crash
path: raw shm bytes, written by the agent without touching the training
process) and an Orbax checkpoint, the JAX ecosystem's format.  The
port's counterpart is ``torch.distributed.checkpoint`` (DCP), the format
the upstream FSDP engine writes (``dlrover/trainer/torch/
flash_checkpoint/fsdp.py``), in one process with no process group.

- :func:`export_dcp` — a committed ``.drckpt`` step -> ``dest/<step>/``
  in DCP's file-system layout.
- :func:`import_dcp` — a DCP checkpoint -> (step, state): a nested dict
  of tensors, or copied into a ``target`` (a train state or nested dict).

Key paths: each ``.drckpt`` leaf is named by a JAX ``keystr``
(``"['opt_state'].mu['embed'][<flat index 0>]"``); export nests it by
its tokens (dict keys, attribute names and indices alike become keys:
``opt_state.mu.embed.0`` in DCP's dotted names), and import matches a
target's leaves by the same tokens.  Shards are merged by key path,
which is exact for replicated state.
"""

import os
import re
import warnings
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.agent.ckpt_saver import find_latest_checkpoint
from dlrover_tpu_torch.agent.ckpt_shm import (
    _target_leaves,
    read_shard_file,
    restore_to_target,
)
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import default_logger as logger

_KEY_TOKEN = re.compile(
    r"\['([^']*)'\]"  # dict key: ['name']
    r"|\[(\d+)\]"  # sequence index: [0]
    r"|\[<flat index (\d+)>\]"  # a custom pytree node's child
    r"|\.([A-Za-z_][A-Za-z0-9_]*)"  # namedtuple/dataclass field: .mu
)


def keystr_tokens(keystr: str) -> Tuple[str, ...]:
    """``"['opt'].mu['w'][<flat index 0>]"`` -> ("opt", "mu", "w", "0")."""
    return tuple(next(g for g in m.groups() if g is not None)
                 for m in _KEY_TOKEN.finditer(keystr))


def _nest(arrays: Dict[str, torch.Tensor]) -> Dict:
    root: Dict = {}
    for keystr, value in arrays.items():
        tokens = keystr_tokens(keystr) or (keystr,)
        node = root
        for tok in tokens[:-1]:
            node = node.setdefault(tok, {})
        node[tokens[-1]] = value
    return root


def _flat(node, prefix: Tuple[str, ...] = ()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield prefix, node


def _read_step_arrays(checkpoint_dir: str, step: Optional[int]):
    """Merge every ``shard_*.drckpt`` of the chosen committed step."""
    if step is None:
        path = find_latest_checkpoint(checkpoint_dir)
        if path is None:
            return -1, {}
    else:
        path = os.path.join(
            checkpoint_dir, f"{CheckpointConstant.CKPT_DIR_PREFIX}{step}")
    if not os.path.isdir(path):
        return -1, {}
    merged: Dict[str, torch.Tensor] = {}
    found_step = -1
    for entry in sorted(os.listdir(path)):
        if entry.endswith(".drckpt"):
            shard_step, arrays = read_shard_file(os.path.join(path, entry))
            found_step = max(found_step, shard_step)
            merged.update(arrays)
    return found_step, merged


def export_dcp(checkpoint_dir: str, dest_dir: str,
               step: Optional[int] = None) -> int:
    """Write a committed ``.drckpt`` checkpoint as DCP at
    ``dest_dir/<step>``; returns the step (-1 when nothing is
    committed)."""
    import torch.distributed.checkpoint as dcp

    found_step, arrays = _read_step_arrays(checkpoint_dir, step)
    if found_step < 0 or not arrays:
        logger.warning("no committed checkpoint to export under %s",
                       checkpoint_dir)
        return -1
    dest = os.path.join(os.path.abspath(dest_dir), str(found_step))
    with warnings.catch_warnings():
        # "assuming the intent is to save in a single process"
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(_nest(arrays), checkpoint_id=dest)
    logger.info("exported step %s -> %s (dcp)", found_step, dest)
    return found_step


def import_dcp(src_dir: str, step: Optional[int] = None, target=None):
    """Load a DCP checkpoint written by :func:`export_dcp` (integer step
    dirs under ``src_dir``).  Returns (step, nested dict of tensors), or
    with ``target`` (step, target restored, leaves matched by their key
    tokens); (-1, None) when there is none."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    src_dir = os.path.abspath(src_dir)
    if step is None:
        steps = ([int(e) for e in os.listdir(src_dir) if e.isdigit()]
                 if os.path.isdir(src_dir) else [])
        if not steps:
            return -1, None
        step = max(steps)
    path = os.path.join(src_dir, str(step))
    meta = dcp.FileSystemReader(path).read_metadata()
    flat = {}
    for fqn, md in meta.state_dict_metadata.items():
        if not isinstance(md, TensorStorageMetadata):
            raise ValueError(f"{fqn}: not a tensor in {path}")
        flat[fqn] = torch.empty(tuple(md.size), dtype=md.properties.dtype)
    tree: Dict = {}
    for fqn, t in flat.items():
        node = tree
        parts = fqn.split(".")
        for tok in parts[:-1]:
            node = node.setdefault(tok, {})
        node[parts[-1]] = t
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(tree, checkpoint_id=path)
    if target is None:
        return step, tree
    by_tokens = dict(_flat(tree))
    arrays = {}
    for key, _leaf in _target_leaves(target):
        tokens = keystr_tokens(key)
        if tokens not in by_tokens:
            raise KeyError(f"DCP checkpoint missing leaf {key}")
        arrays[key] = by_tokens[tokens]
    return step, restore_to_target(target, arrays)
