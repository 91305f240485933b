"""Master KV-store service: the rendezvous/bootstrap store the agents
use to exchange small blobs (e.g. the jax coordinator address).

Copy of ``dlrover_tpu/master/kv_store.py``.

Reference parity: ``dlrover/python/master/elastic_training/
kv_store_service.py:18``.

``wait`` blocks on a ``threading.Condition`` notified by every mutation
(``set``/``add``/``delete``) — a waiter wakes the moment its key
appears instead of busy-polling; this is also the primitive the
control-plane long-poll ``get`` (``KVWaitRequest``) parks on, so an
idle remote waiter costs one RPC and zero master CPU.

Durability: every mutation can be journaled through an attached
callback (``set_journal``) so a restarted master replays identical KV
contents — ``add`` journals its RESULT (an idempotent ``set``), so a
replay that overlaps a snapshot can never double-count.
"""

import base64
import threading
import time
from typing import Callable, Dict, Optional


class KVStoreService:
    def __init__(self):
        self._cond = threading.Condition()
        self._store: Dict[str, bytes] = {}
        self._journal_cb: Optional[Callable[[str, dict], None]] = None

    def set_journal(self, cb: Optional[Callable[[str, dict], None]]):
        """``cb(op, args)`` invoked (under the lock, so journal order
        is mutation order) on every state change."""
        self._journal_cb = cb

    def _journal(self, op: str, **args):
        """Caller holds the condition."""
        if self._journal_cb is not None:
            self._journal_cb(op, args)

    def _mutated(self):
        """Caller holds the condition: wake every parked waiter."""
        self._cond.notify_all()

    def set(self, key: str, value: bytes):
        with self._cond:
            self._store[key] = value
            self._journal(
                "set",
                key=key,
                value_b64=base64.b64encode(value).decode(),
            )
            self._mutated()

    def get(self, key: str) -> bytes:
        with self._cond:
            return self._store.get(key, b"")

    def add(self, key: str, delta: int) -> int:
        """Atomic counter (torch-Store-style add semantics)."""
        with self._cond:
            current = int(self._store.get(key, b"0") or b"0")
            current += delta
            value = str(current).encode()
            self._store[key] = value
            # journal the RESULT, not the delta: replay is idempotent
            self._journal(
                "set",
                key=key,
                value_b64=base64.b64encode(value).decode(),
            )
            self._mutated()
            return current

    def wait(self, key: str, timeout: float = 30.0) -> Optional[bytes]:
        """Block until ``key`` holds a non-empty value; None on
        timeout.  Event-driven: sleeps on the condition, woken by the
        mutation that publishes the key."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cond:
            while True:
                value = self._store.get(key, b"")
                if value:
                    return value
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def delete(self, key: str):
        with self._cond:
            self._store.pop(key, None)
            self._journal("delete", key=key)
            self._mutated()

    def clear(self):
        with self._cond:
            self._store.clear()
            self._journal("clear")
            self._mutated()

    # --------------------------------------------- failover replay
    def export_state(self) -> dict:
        """JSON-safe full state for the compacted snapshot."""
        with self._cond:
            return {
                "kv": {
                    k: base64.b64encode(v).decode()
                    for k, v in self._store.items()
                }
            }

    def restore_state(self, state: dict):
        """Install a snapshot (replay path — NOT journaled: restoring
        a journaled state must not re-journal it)."""
        with self._cond:
            self._store = {
                k: base64.b64decode(v)
                for k, v in (state.get("kv") or {}).items()
            }
            self._mutated()

    def apply_journal_op(self, op: str, args: dict):
        """Re-apply one journaled mutation (replay path)."""
        with self._cond:
            if op == "set":
                self._store[args["key"]] = base64.b64decode(
                    args.get("value_b64", "")
                )
            elif op == "delete":
                self._store.pop(args.get("key", ""), None)
            elif op == "clear":
                self._store.clear()
            self._mutated()
