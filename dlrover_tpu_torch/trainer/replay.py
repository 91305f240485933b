"""Deterministic replay — the training flight recorder.

Port of ``dlrover_tpu/trainer/replay.py``: the same batch files
(``batch-<step>.npz``, one array per batch key) and the same journal
(``journal.jsonl``, the JAX package's digests, ``trainer/
fault_tolerance.pytree_digest``), so a recording made by either package
replays in the other.  A batch recorded from the card is copied to the
host first; ``replay`` puts each batch back on the device of the
state's params (or ``device``) as ``torch.as_tensor`` of its arrays,
the form the ``Trainer``'s prefetch hands the train step, and runs
``train_step``, the function the ``Trainer`` ran.

SURVEY.md §5.2 calls race/numeric-drift detection a GAP in the
reference (its closest tools are the numeric checker and loss-spike
capture); the TPU build is asked to plan explicit equivalents.  This
module is the missing piece: record what each step consumed, then
re-execute any recorded window from a checkpoint and verify the
results are BIT-IDENTICAL — a deterministic step reproduces its bits, so
any divergence between a run and its replay is real evidence
(non-deterministic data order, host-side RNG misuse, hardware fault),
not noise.

Usage::

    recorder = ReplayRecorder(dir, keep_steps=200)
    for batch in data:
        batch = recorder.record(step, batch)      # logs batch + digest
        state, metrics = train_step(state, batch)
        recorder.commit(step, state)              # logs state digest

    # later, from the step-N checkpoint:
    report = replay(dir, train_step, state_at_n, start=N+1, stop=N+20)
    report.diverged_at  # first step whose state digest differs, or None

The recorder keeps a bounded ring of recent batches on disk (the same
budget discipline as LossSpikeCapture) and a digest journal for every
recorded step, so the window around an incident is always
re-executable.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.trainer.fault_tolerance import pytree_digest, to_numpy


def _batch_path(root: str, step: int) -> str:
    return os.path.join(root, f"batch-{step:010d}.npz")


class ReplayRecorder:
    """Log (batch payload, batch digest, post-step state digest) per
    step into a bounded on-disk ring."""

    def __init__(self, root: str, keep_steps: int = 200):
        self.root = root
        self.keep = keep_steps
        os.makedirs(root, exist_ok=True)
        self._journal_path = os.path.join(root, "journal.jsonl")
        # seed the ring from disk: an elastic restart reuses the same
        # dir, and files outside the in-memory list would never age
        # out (unbounded growth across incarnations)
        self._recorded: List[int] = sorted(
            int(f[len("batch-"):-len(".npz")])
            for f in os.listdir(root)
            if f.startswith("batch-") and f.endswith(".npz")
        )
        self._appends = 0

    def record(self, step: int, batch: Dict) -> Dict:
        """Persist the batch for ``step``; returns it unchanged."""
        arrays = {
            k: to_numpy(v)
            for k, v in batch.items()
        }
        np.savez(_batch_path(self.root, step), **arrays)
        # re-recording a step (restart replays the incident window) is
        # an overwrite, not a second ring slot — a duplicate entry
        # would make length-based eviction delete live files
        if step in self._recorded:
            self._recorded.remove(step)
        self._recorded.append(step)
        self._append(
            {"step": step, "batch_digest": pytree_digest(arrays)}
        )
        # ring: drop the oldest batch beyond the budget
        while len(self._recorded) > self.keep:
            old = self._recorded.pop(0)
            try:
                os.remove(_batch_path(self.root, old))
            except OSError:
                pass
        self._maybe_compact_journal()
        return batch

    def commit(self, step: int, state) -> str:
        """Log the post-step state digest (the replay comparand)."""
        digest = pytree_digest(state)
        self._append({"step": step, "state_digest": digest})
        return digest

    def _append(self, entry: Dict):
        with open(self._journal_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        self._appends += 1

    def _maybe_compact_journal(self):
        """The journal would otherwise grow one line per step forever;
        every ``keep`` appends, rewrite it keeping only entries for
        steps still in (or newer than) the ring."""
        if self._appends < 2 * self.keep:
            return
        floor = self._recorded[0] if self._recorded else 0
        kept = [
            e
            for step, e in sorted(_load_journal(self.root).items())
            if step >= floor
        ]
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            for e in kept:
                f.write(json.dumps(e) + "\n")
        os.replace(tmp, self._journal_path)
        self._appends = 0


def _load_journal(root: str) -> Dict[int, Dict]:
    path = os.path.join(root, "journal.jsonl")
    out: Dict[int, Dict] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue
            out.setdefault(e["step"], {}).update(e)
    return out


@dataclass
class ReplayReport:
    replayed_steps: List[int] = field(default_factory=list)
    # first step whose post-step state digest differs from the
    # recorded run (None = bit-identical window); set ONLY for real
    # state divergence — damaged recordings land in corrupt_batches
    diverged_at: Optional[int] = None
    missing_batches: List[int] = field(default_factory=list)
    corrupt_batches: List[int] = field(default_factory=list)

    @property
    def deterministic(self) -> bool:
        return self.diverged_at is None

    @property
    def complete(self) -> bool:
        """Whole requested window replayed with intact recordings."""
        return not (self.missing_batches or self.corrupt_batches)


def _state_device(state) -> torch.device:
    """The device of the first tensor of the state's params (the CPU
    when there is none)."""
    tree = state.get("params", state) if isinstance(state, dict) else state
    stack = [tree]
    while stack:
        node = stack.pop()
        if torch.is_tensor(node):
            return node.device
        if isinstance(node, dict):
            stack.extend(node[k] for k in sorted(node, reverse=True))
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
    return torch.device("cpu")


def replay(
    root: str,
    train_step: Callable,
    state,
    start: int,
    stop: int,
    device=None,
) -> ReplayReport:
    """Re-execute recorded steps ``start..stop`` (inclusive) from
    ``state`` (the post-``start-1`` checkpoint) and compare each
    post-step state digest against the journal.  ``train_step(state,
    batch)`` takes the batch on ``device`` (default: the device of the
    state's params).

    Divergence pinpoints the first bad step — from there, the recorded
    batch reproduces the incident in isolation."""
    journal = _load_journal(root)
    report = ReplayReport()
    dev = torch.device(device) if device is not None else _state_device(
        state)
    for step in range(start, stop + 1):
        path = _batch_path(root, step)
        if step not in journal or not os.path.exists(path):
            # a gap breaks step continuity: executing later steps from
            # a state that never applied this one would "diverge" by
            # construction — stop instead of reporting phantoms
            report.missing_batches.append(step)
            logger.warning(
                "replay: batch for step %d not in the ring; window "
                "truncated (re-anchor from a later checkpoint)", step,
            )
            break
        with np.load(path) as data:
            batch = {k: data[k] for k in data.files}
        recorded = journal[step]
        if pytree_digest(batch) != recorded.get("batch_digest"):
            logger.error(
                "replay: batch file for step %d does not match its "
                "recorded digest (damaged recording, NOT "
                "nondeterminism)", step,
            )
            report.corrupt_batches.append(step)
            break
        state, _metrics = train_step(
            state, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        report.replayed_steps.append(step)
        want = recorded.get("state_digest")
        if want is None:
            continue
        got = pytree_digest(state)
        if got != want:
            logger.error(
                "replay: state diverged at step %d (recorded %s, "
                "replayed %s)", step, want[:12], got[:12],
            )
            report.diverged_at = step
            break
    return report
