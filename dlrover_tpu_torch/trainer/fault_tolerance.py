"""In-trainer fault-tolerance utilities.

Port of ``dlrover_tpu/trainer/fault_tolerance.py``: ``HangDetector``
(:26) and its default action, ``LossSpikeCapture`` (:90),
``pytree_digest`` (:157) and ``NumericChecker`` (:170).  A hung worker
reports the hang to the master and exits, and the agent restarts it
(the JAX version reports only).

``pytree_digest`` and the spike capture's batch digests hash what the
JAX functions hash, in the same order: for each leaf, ``str(path)`` of
its ``jax.tree_util`` key path, then the leaf's bytes.  The port walks
its trees as the JAX package flattens the matching ones (``_leaves``):

- a train state ``{"step", "params", "opt_state"}`` through
  ``models/convert.train_state_leaves``, which names each leaf by the
  JAX key path of the same logical leaf (``AGDState`` and
  ``QuantizedMomentsState`` as flash checkpoint names them), the step
  counts as int32 scalars;
- a dict by its sorted keys (``DictKey``), a list or tuple by index
  (``SequenceKey``);
- a key path's text is built from those names: ``['k']`` is
  ``DictKey(key='k')``, ``.name`` ``GetAttrKey(name='name')``,
  ``[<flat index i>]`` ``FlattenedIndexKey(key=i)``, ``[i]``
  ``SequenceKey(idx=i)``, printed as the tuple JAX prints.

So a digest of a port state equals the JAX digest of the state it was
converted from (or to), bf16 leaves included: the bytes are the
tensor's own.

Reference parity:
- ``HangingDetector`` (``atorch/atorch/fault_tolerance/
  hanging_detector.py:86``): a side thread watches step progress and
  triggers a relaunch when stuck.
- loss-spike capture (``atorch/atorch/utils/loss_spike_utils.py``):
  record batches around abnormal losses for offline repro.
- numeric checker (``atorch/atorch/utils/numberic_checker.py``): drift
  detection between runs/layouts.
"""

import hashlib
import json
import os
import re
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger


class HangDetector:
    """Watches a monotonically-increasing step counter from a side
    thread; fires ``on_hang`` when no progress within ``timeout``."""

    def __init__(
        self,
        timeout: float = 1800.0,
        check_interval: float = 30.0,
        on_hang: Optional[Callable[[], None]] = None,
    ):
        self._timeout = timeout
        self._interval = check_interval
        self._on_hang = on_hang
        self._last_step = -1
        self._last_progress = time.time()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hang_detected = False

    def report_step(self, step: int):
        if step > self._last_step:
            self._last_step = step
            self._last_progress = time.time()
            self.hang_detected = False

    def _loop(self):
        while not self._stopped.wait(self._interval):
            stalled = time.time() - self._last_progress
            if self._last_step >= 0 and stalled > self._timeout:
                self.hang_detected = True
                logger.error(
                    "hang: no step progress for %.0fs (step %d)",
                    stalled,
                    self._last_step,
                )
                if self._on_hang is not None:
                    self._on_hang()
                self._last_progress = time.time()  # don't refire hot

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="hang-detector", daemon=True
            )
            self._thread.start()

    def stop(self):
        self._stopped.set()


#: a worker that exits on a hang does so with this code
HANG_EXIT_CODE = 75


def default_hang_action():
    """Report a hang to the master (process restart verdict) — the
    reference's relaunch RPC — then exit, so that the agent sees the
    worker fail and restarts it."""
    from dlrover_tpu_torch.agent.master_client import MasterClient

    try:
        client = MasterClient.singleton_instance()
        client.report_failure(
            "training hang detected", level="process_error"
        )
    except Exception as e:  # noqa: BLE001
        logger.warning("hang report failed: %s", e)
    logger.error("exiting on a hang (code %d)", HANG_EXIT_CODE)
    os._exit(HANG_EXIT_CODE)


class LossSpikeCapture:
    """Records (step, loss, batch digest) around loss spikes."""

    def __init__(
        self,
        out_dir: str,
        window: int = 16,
        spike_factor: float = 3.0,
        min_history: int = 20,
    ):
        self._out_dir = out_dir
        self._window = window
        self._factor = spike_factor
        self._min_history = min_history
        self._history: List[float] = []
        os.makedirs(out_dir, exist_ok=True)

    def observe(self, step: int, loss: float, batch=None) -> bool:
        """Returns True when this step is a spike (and was captured)."""
        spiked = False
        if len(self._history) >= self._min_history:
            recent = self._history[-self._window :]
            mean = float(np.mean(recent))
            std = float(np.std(recent)) + 1e-12
            if loss > mean + self._factor * std:
                spiked = True
                self._capture(step, loss, mean, std, batch)
        self._history.append(float(loss))
        if len(self._history) > 4096:
            self._history.pop(0)
        return spiked

    def _capture(self, step, loss, mean, std, batch):
        record = {
            "step": int(step),
            "loss": float(loss),
            "window_mean": mean,
            "window_std": std,
            "timestamp": time.time(),
        }
        if batch is not None:
            leaves = _leaves(batch)
            record["batch_digest"] = {
                path: hashlib.sha1(to_numpy(leaf).tobytes()).hexdigest()[:16]
                for path, leaf in leaves
            }
            np.savez(
                os.path.join(self._out_dir, f"spike_{step}.npz"),
                **{f"arr_{i}": to_numpy(leaf)
                   for i, (_, leaf) in enumerate(leaves)},
            )
        with open(
            os.path.join(self._out_dir, "spikes.jsonl"), "a"
        ) as f:
            f.write(json.dumps(record) + "\n")
        logger.warning("loss spike at step %s: %.4f", step, loss)


# -- the JAX key paths of a port tree ----------------------------------------

_KEY_TOKEN = re.compile(
    r"\['((?:[^'\\]|\\.)*)'\]|\.(\w+)|\[<flat index (\d+)>\]|\[(\d+)\]")


def jax_path_str(keystr: str) -> str:
    """``str(path)`` of the ``jax.tree_util`` key path whose ``keystr`` is
    ``keystr`` (``"['opt_state'].mu['embed'][<flat index 0>]"`` ->
    ``"(DictKey(key='opt_state'), GetAttrKey(name='mu'), ...)"``)."""
    parts, pos = [], 0
    while pos < len(keystr):
        m = _KEY_TOKEN.match(keystr, pos)
        if m is None:
            raise ValueError(f"not a key path: {keystr!r} at {pos}")
        key, attr, flat, idx = m.groups()
        if key is not None:
            parts.append(f"DictKey(key={key!r})")
        elif attr is not None:
            parts.append(f"GetAttrKey(name={attr!r})")
        elif flat is not None:
            parts.append(f"FlattenedIndexKey(key={int(flat)})")
        else:
            parts.append(f"SequenceKey(idx={int(idx)})")
        pos = m.end()
    if len(parts) == 1:
        return f"({parts[0]},)"
    return "(" + ", ".join(parts) + ")"


def _keyed(tree, prefix: str = "") -> List[Tuple[str, object]]:
    from dlrover_tpu_torch.models.convert import (
        HostScalar,
        is_train_state,
        train_state_leaves,
    )

    if is_train_state(tree):
        return [(prefix + k, v.value() if isinstance(v, HostScalar) else v)
                for k, v in train_state_leaves(tree)]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _keyed(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _keyed(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _leaves(tree) -> List[Tuple[str, object]]:
    """``[(str(JAX key path), leaf)]`` in JAX's flatten order."""
    return [(jax_path_str(k), v) for k, v in _keyed(tree)]


def to_numpy(leaf) -> np.ndarray:
    """A batch leaf (a tensor, on the card or not, or an array) as a
    numpy array on the host."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


#: bytes of each of the two pinned buffers a card's leaves stream through
_DIGEST_CHUNK = 64 << 20
_staging = {}  # device index -> (copy stream, two pinned uint8 buffers)


def _card_chunks(t: torch.Tensor):
    """A card tensor's bytes on the host, chunk after chunk: each chunk
    is copied into one of two pinned buffers on a side stream while the
    caller hashes the other (no page of a fresh host allocation is
    touched, and the copy hides behind the hash)."""
    dev = t.device.index if t.device.index is not None else (
        torch.cuda.current_device())
    if dev not in _staging:
        _staging[dev] = (torch.cuda.Stream(t.device), [
            torch.empty(_DIGEST_CHUNK, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)])
    stream, bufs = _staging[dev]
    # the copies read what the compute stream wrote
    stream.wait_stream(torch.cuda.current_stream(t.device))
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pending = []
    for i, off in enumerate(range(0, flat.numel(), _DIGEST_CHUNK)):
        n = min(_DIGEST_CHUNK, flat.numel() - off)
        buf = bufs[i % 2]
        with torch.cuda.stream(stream):
            buf[:n].copy_(flat[off:off + n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        pending.append((buf, n, done))
        if len(pending) == 2:
            buf, n, done = pending.pop(0)
            done.synchronize()
            yield buf[:n].numpy()
    for buf, n, done in pending:
        done.synchronize()
        yield buf[:n].numpy()


def _leaf_chunks(leaf):
    """The leaf's bytes as flat, contiguous uint8 buffers, in order."""
    if torch.is_tensor(leaf):
        if leaf.is_cuda:
            yield from _card_chunks(leaf)
            return
        yield leaf.detach().contiguous().reshape(-1).view(
            torch.uint8).numpy()
        return
    yield np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def pytree_digest(tree) -> str:
    """Deterministic digest of a tree's values: cross-host / cross-
    layout consistency checks (DP vs FSDP must produce identical
    states; compare digests instead of shipping tensors).  Equal to
    ``dlrover_tpu.trainer.fault_tolerance.pytree_digest`` of the
    matching JAX tree (the module docstring)."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        h.update(path.encode())
        for chunk in _leaf_chunks(leaf):
            h.update(chunk)
    return h.hexdigest()


def _float64(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().double().numpy()
    return np.asarray(leaf, dtype=np.float64)


class NumericChecker:
    """Step-wise numeric drift detection between two runs."""

    def __init__(self, rtol: float = 1e-5, atol: float = 1e-6):
        self._rtol = rtol
        self._atol = atol
        self.records: List[dict] = []

    def compare_trees(self, name: str, a, b) -> bool:
        leaves_a = [v for _, v in _keyed(a)]
        leaves_b = [v for _, v in _keyed(b)]
        if len(leaves_a) != len(leaves_b):
            self.records.append(
                {"name": name, "match": False, "reason": "structure"}
            )
            return False
        worst = 0.0
        for la, lb in zip(leaves_a, leaves_b):
            da = _float64(la)
            db = _float64(lb)
            if da.shape != db.shape:
                self.records.append(
                    {"name": name, "match": False, "reason": "shape"}
                )
                return False
            denom = np.maximum(np.abs(da), np.abs(db))
            err = np.max(
                np.abs(da - db) / np.maximum(denom, self._atol)
            ) if da.size else 0.0
            worst = max(worst, float(err))
        ok = worst <= self._rtol or np.isclose(worst, 0)
        self.records.append(
            {"name": name, "match": bool(ok), "max_rel_err": worst}
        )
        return ok
