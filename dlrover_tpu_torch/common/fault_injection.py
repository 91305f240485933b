"""Seeded, env-driven fault injection for chaos testing.

Copy of ``dlrover_tpu/common/fault_injection.py``: the same plan
variables, so one chaos plan drives either package.

The plan rides ``DLROVER_TPU_FAULT_PLAN`` (a JSON object, see
:class:`FaultPlan`) into every process of a job; each process also
declares its role via ``DLROVER_TPU_FAULT_ROLE`` (``master`` /
``agent`` / anything — the orchestrator in ``scripts/chaos.py`` sets
it on the children it spawns).  Two fault families:

- ``kill`` — SIGKILL the current process when execution reaches a
  named phase hook (:func:`maybe_crash` call sites: mid_rendezvous,
  mid_long_poll, mid_report_flush, mid_checkpoint_persist,
  mid_weight_publish) and the
  spec's role/occurrence filters match.  This is how "the master dies
  mid-rendezvous" is reproduced deterministically instead of by
  racing a timer against the serve loop.
- ``rpc`` — drop / delay / duplicate individual RPCs at the
  ``MasterChannel`` boundary (:meth:`FaultInjector.on_rpc`), matched
  by request class name, with a seeded probability.

Every injected fault emits a ``fault_injected`` instant event
(labels: ``kind`` + ``target``) on the job timeline
before it acts, so chaos runs are attributable in the same trace as
the recovery they provoke.

With no plan configured every hook is a cheap no-op (one module-level
``None`` check) — production code paths pay nothing.
"""

import json
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

FAULT_PLAN_ENV = "DLROVER_TPU_FAULT_PLAN"
FAULT_ROLE_ENV = "DLROVER_TPU_FAULT_ROLE"

#: the closed phase-hook vocabulary (``maybe_crash`` call sites)
KILL_PHASES = (
    "mid_rendezvous",
    "mid_long_poll",
    "mid_report_flush",
    "mid_checkpoint_persist",
    "mid_weight_publish",
)


class FaultInjectedError(ConnectionError):
    """A dropped RPC, surfaced as the transport failure it simulates."""


@dataclass
class FaultSpec:
    """One fault in a plan.

    ``kind``: ``kill`` | ``rpc``.
    ``target``: role filter (``master`` / ``agent`` / "" = any) for
    kills; for rpc faults the request CLASS NAME to match ("" or
    ``*`` = any RPC).
    ``phase``: kill hook name (one of :data:`KILL_PHASES`).
    ``op``: rpc fault operation — ``drop`` | ``delay`` | ``dup``.
    ``after``: skip the first N matching occurrences before arming.
    ``count``: fire at most N times (-1 = unlimited).
    ``prob``: seeded per-occurrence probability once armed.
    ``delay_s``: sleep for ``op=delay``.
    """

    kind: str = "rpc"
    target: str = ""
    phase: str = ""
    op: str = "drop"
    after: int = 0
    count: int = 1
    prob: float = 1.0
    delay_s: float = 0.0
    # runtime occurrence bookkeeping (not part of the plan)
    seen: int = 0
    fired: int = 0


@dataclass
class FaultPlan:
    seed: int = 0
    faults: List[FaultSpec] = field(default_factory=list)

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        data = json.loads(raw)
        specs = []
        for f in data.get("faults", []):
            known = {
                k: v
                for k, v in f.items()
                if k in FaultSpec.__dataclass_fields__
            }
            spec = FaultSpec(**known)
            if spec.kind == "kill" and spec.phase not in KILL_PHASES:
                raise ValueError(
                    f"unknown kill phase {spec.phase!r} "
                    f"(declared: {KILL_PHASES})"
                )
            specs.append(spec)
        return cls(seed=int(data.get("seed", 0)), faults=specs)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.getenv(FAULT_PLAN_ENV, "")
        if not raw:
            return None
        try:
            return cls.from_json(raw)
        except (ValueError, TypeError) as e:
            logger.warning("ignoring malformed %s: %s",
                           FAULT_PLAN_ENV, e)
            return None


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at the instrumented hooks."""

    def __init__(self, plan: FaultPlan, role: str = ""):
        self._plan = plan
        self._role = role or os.getenv(FAULT_ROLE_ENV, "")
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()

    @property
    def role(self) -> str:
        return self._role

    def _armed(self, spec: FaultSpec) -> bool:
        """Caller holds the lock: occurrence bookkeeping + seeded
        probability for one matching occurrence."""
        spec.seen += 1
        if spec.seen <= spec.after:
            return False
        if spec.count >= 0 and spec.fired >= spec.count:
            return False
        if spec.prob < 1.0 and self._rng.random() >= spec.prob:
            return False
        spec.fired += 1
        return True

    def _emit(self, kind: str, target: str, **labels):
        from dlrover_tpu_torch.observability.events import get_event_logger

        get_event_logger().instant(
            "fault_injected", kind=kind, target=target, **labels
        )

    # ------------------------------------------------------- kill hooks
    def maybe_crash(self, phase: str):
        """SIGKILL the current process when a kill spec matches this
        phase + role.  The ``fault_injected`` marker is written first
        (O_APPEND, synchronous) so the timeline records the cause."""
        for spec in self._plan.faults:
            if spec.kind != "kill" or spec.phase != phase:
                continue
            if spec.target and spec.target != self._role:
                continue
            with self._lock:
                if not self._armed(spec):
                    continue
            logger.warning(
                "fault plan: SIGKILL self (%s) at %s",
                self._role or "?", phase,
            )
            self._emit("kill", self._role or "self", phase=phase)
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)  # pragma: no cover - the signal lands first

    # -------------------------------------------------------- rpc hooks
    def on_rpc(self, msg_name: str) -> str:
        """Consulted by ``MasterChannel`` before each wire attempt.

        Returns ``"dup"`` when the RPC should be sent twice, ``""``
        otherwise; raises :class:`FaultInjectedError` for a drop;
        sleeps in place for a delay."""
        for spec in self._plan.faults:
            if spec.kind != "rpc":
                continue
            if spec.target not in ("", "*", msg_name):
                continue
            with self._lock:
                if not self._armed(spec):
                    continue
            self._emit("rpc_" + spec.op, msg_name,
                       delay_s=spec.delay_s)
            if spec.op == "drop":
                raise FaultInjectedError(
                    f"fault plan dropped rpc {msg_name}"
                )
            if spec.op == "delay":
                time.sleep(max(spec.delay_s, 0.0))
            elif spec.op == "dup":
                return "dup"
        return ""


_injector: Optional[FaultInjector] = None
_injector_loaded = False
_injector_lock = threading.Lock()


def get_fault_injector() -> Optional[FaultInjector]:
    """Process-wide injector, built lazily from the env; None (and
    near-free) when no plan is configured."""
    global _injector, _injector_loaded
    if _injector_loaded:
        return _injector
    with _injector_lock:
        if not _injector_loaded:
            plan = FaultPlan.from_env()
            _injector = (
                FaultInjector(plan) if plan is not None else None
            )
            _injector_loaded = True
    return _injector


def reset_fault_injector():
    """Drop the cached injector so the next call re-reads the env
    (tests and harnesses that flip the plan mid-process)."""
    global _injector, _injector_loaded
    with _injector_lock:
        _injector = None
        _injector_loaded = False


def maybe_crash(phase: str):
    """Module-level kill hook — safe to call unconditionally from any
    instrumented site."""
    injector = get_fault_injector()
    if injector is not None:
        injector.maybe_crash(phase)
