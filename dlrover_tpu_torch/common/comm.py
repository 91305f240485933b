"""gRPC control-plane transport: two bytes-in/bytes-out unary RPCs.

Copy of ``dlrover_tpu/common/comm.py``.  The transport is gRPC, as
there: ``grpcio`` is installed beside PyTorch on the card's machine.

Reference parity: ``dlrover/proto/elastic_training.proto:26-29`` (the
``Master`` service exposes exactly ``report`` and ``get``) and the channel
helpers in ``dlrover/python/common/grpc.py``.  Instead of protoc codegen
we register the same two methods through grpc's generic handler API with
identity serializers; the payload is the pickled ``Envelope`` from
``dlrover_tpu_torch.common.messages``.

Failover semantics (``DLROVER_TPU_MASTER_FAILOVER``, default on):

- retries use JITTERED exponential backoff under a bounded total
  deadline (``DLROVER_TPU_MASTER_RECONNECT_DEADLINE_S``) instead of
  the old fixed-sleep x3 loop, and the channel object is rebuilt after
  repeated failures so a master that came back on the same address is
  re-dialed cleanly;
- every envelope carries the ``(job_epoch, master_incarnation)`` pair
  this client last learned; a ``StaleEpoch`` answer triggers an epoch
  refresh + one transparent re-issue instead of surfacing a crash;
- with the kill-switch off, behavior is today's fail-fast shape:
  ``max_retry`` attempts then ``ConnectionError``, no epochs on the
  wire, ``StaleEpoch`` answers raise.
"""

import random
import socket
import threading
import time
from concurrent import futures
from contextlib import contextmanager
from typing import Callable, Optional

import grpc

from dlrover_tpu_torch.common.constants import GRPC
from dlrover_tpu_torch.common.env import (
    master_failover_enabled,
    master_reconnect_deadline_s,
)
from dlrover_tpu_torch.common.fault_injection import (
    FaultInjectedError,
    get_fault_injector,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import (
    BoolResponse,
    ControlEpochRequest,
    Envelope,
    Message,
    StaleEpoch,
    deserialize_message,
    serialize_message,
)

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", GRPC.MAX_SEND_MESSAGE_LENGTH),
    ("grpc.max_receive_message_length", GRPC.MAX_RECEIVE_MESSAGE_LENGTH),
    ("grpc.enable_retries", 1),
]


class StaleEpochError(ConnectionError):
    """The master kept fencing this client after an epoch refresh —
    its cached job identity is unrecoverably stale."""


def addr_connectable(addr: str, timeout: float = 1.0) -> bool:
    """True if a TCP connect to "host:port" succeeds."""
    if not addr or ":" not in addr:
        return False
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection((host, int(port)), timeout=timeout):
            return True
    except (OSError, ValueError):
        return False


def wait_channel_ready(addr: str, timeout: float = 60.0) -> bool:
    """Block until a gRPC channel to ``addr`` is READY (or timeout).

    Replaces the connect-probe polling loop (``addr_connectable`` every
    0.5 s): grpc's own reconnect backoff drives the retries and the
    caller just parks on the ready future — the long-poll shape for
    "wait for the master to come up".
    """
    if not addr or ":" not in addr:
        return False
    channel = grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)
    try:
        grpc.channel_ready_future(channel).result(timeout=timeout)
        return True
    except grpc.FutureTimeoutError:
        return False
    finally:
        channel.close()


def build_master_server(
    port: int,
    report_fn: Callable[[Envelope], BoolResponse],
    get_fn: Callable[[Envelope], Optional[Message]],
    max_workers: int = 64,
    host: str = "0.0.0.0",
) -> grpc.Server:
    """Create (not start) the master gRPC server.

    ``report_fn``/``get_fn`` receive the deserialized ``Envelope`` and
    return a ``Message`` (or None); transport (de)serialization is
    handled here.
    """

    def _report(request: bytes, _ctx) -> bytes:
        envelope = deserialize_message(request)
        response = report_fn(envelope)
        return serialize_message(response)

    def _get(request: bytes, _ctx) -> bytes:
        envelope = deserialize_message(request)
        response = get_fn(envelope)
        return serialize_message(response)

    handlers = {
        GRPC.REPORT_METHOD: grpc.unary_unary_rpc_method_handler(_report),
        GRPC.GET_METHOD: grpc.unary_unary_rpc_method_handler(_get),
    }
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=_CHANNEL_OPTIONS,
    )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(GRPC.SERVICE_NAME, handlers),)
    )
    server.add_insecure_port(f"{host}:{port}")
    return server


class MasterChannel:
    """Client side of the 2-RPC protocol with retry + reconnection.

    Reference parity: ``elastic_agent/master_client.py:28`` —
    ``retry_grpc_request`` — plus the DLRover property that agents
    simply reattach when the ElasticJob controller recreates a failed
    master pod (PAPER.md §1).
    """

    #: backoff shape: base * 2^(attempt-1), jittered to [0.5, 1.5)x,
    #: capped — a fleet of agents retrying a dead master must not
    #: stampede it in lockstep the moment it returns
    BACKOFF_BASE_S = 0.1
    BACKOFF_CAP_S = 5.0
    #: rebuild the grpc channel after this many consecutive failures
    #: (a replacement master on the same address gets a clean dial)
    RECONNECT_AFTER_FAILURES = 3
    #: bounded transparent re-issues after a StaleEpoch answer
    MAX_EPOCH_REFRESHES = 3

    def __init__(
        self,
        addr: str,
        node_id: int = 0,
        node_type: str = "worker",
        timeout: float = 10.0,
        max_retry: int = 3,
    ):
        self._addr = addr
        self._node_id = node_id
        self._node_type = node_type
        self._timeout = timeout
        self._max_retry = max_retry
        #: RPCs actually issued on the wire (attempts, not logical
        #: calls) — what the idle-waiter RPC-bound test and the
        #: control-plane bench count
        self.rpc_count = 0
        #: wire attempts beyond the first per logical call — the
        #: retry-storm telemetry surfaced as ``control_wait`` retry
        #: spans on the timeline
        self.retry_count = 0
        #: channel rebuilds (master outages survived)
        self.reconnect_count = 0
        #: fencing pair last learned from the master (-1 until a
        #: refresh; -1 is never fenced)
        self.job_epoch = -1
        self.master_incarnation = -1
        #: callback fired when the master's epoch/incarnation pair
        #: CHANGED on refresh — the client invalidates its delta-
        #: protocol caches there
        self.on_epoch_change: Optional[Callable[[int, int], None]] = None
        self._closed = False
        #: per-thread deadline override (``bounded_deadline``): RPCs
        #: issued from inside another call's recovery path inherit a
        #: bounded budget instead of opening their own full deadline
        self._deadline_override = threading.local()
        self._build_channel()

    def _build_channel(self):
        self._channel = grpc.insecure_channel(
            self._addr, options=_CHANNEL_OPTIONS
        )
        prefix = f"/{GRPC.SERVICE_NAME}/"
        self._report = self._channel.unary_unary(
            prefix + GRPC.REPORT_METHOD,
            # registered_method is only supported on newer grpcio; skip.
        )
        self._get = self._channel.unary_unary(prefix + GRPC.GET_METHOD)

    def _reconnect(self):
        """Drop and re-dial the channel (same address — a restarted
        master keeps its port; k8s keeps the service VIP)."""
        self.reconnect_count += 1
        try:
            self._channel.close()
        except Exception:  # noqa: BLE001 - channel already broken
            pass
        self._build_channel()

    @property
    def addr(self) -> str:
        return self._addr

    def close(self):
        #: flags in-flight retry loops (other threads) to abort: a
        #: deliberately-closed channel must not be retried against
        #: until the reconnect deadline
        self._closed = True
        self._channel.close()

    def _wrap(self, message: Message) -> bytes:
        return serialize_message(
            Envelope(
                node_id=self._node_id,
                node_type=self._node_type,
                data=serialize_message(message),
                job_epoch=(
                    self.job_epoch
                    if master_failover_enabled()
                    else -1
                ),
                master_incarnation=(
                    self.master_incarnation
                    if master_failover_enabled()
                    else -1
                ),
            )
        )

    @contextmanager
    def bounded_deadline(self, seconds: float):
        """Cap the retry deadline of every call this THREAD makes
        inside the block (unless the call passes its own
        ``deadline_s``).  Used around the epoch-change re-assertion:
        its RPCs fire from inside another call's retry loop, and each
        opening a fresh full reconnect deadline would block the outer
        caller far past its own."""
        prev = getattr(self._deadline_override, "s", None)
        self._deadline_override.s = seconds
        try:
            yield
        finally:
            self._deadline_override.s = prev

    def _backoff(self, attempt: int, remaining: float) -> float:
        delay = min(
            self.BACKOFF_BASE_S * (2 ** max(attempt - 1, 0)),
            self.BACKOFF_CAP_S,
        )
        delay *= 0.5 + random.random()  # jitter: [0.5, 1.5)x
        return max(min(delay, remaining), 0.0)

    def _call_with_retry(
        self, kind: str, payload: bytes, timeout: float,
        msg_name: str = "",
        deadline_s: Optional[float] = None,
    ):
        """One logical RPC: jittered-exponential retries under a total
        deadline; under failover the channel is also re-dialed after
        repeated failures so a replacement master is picked up.  Each
        retry pause is visible on the timeline as a ``control_wait``
        span with ``kind="retry"`` + a ``retries`` label.

        ``deadline_s`` caps the TOTAL retry budget for this call;
        without it the full reconnect deadline applies.  Nested probes
        (``refresh_epoch`` from inside another call's retry loop) must
        pass it, or the inner loop would run its own full deadline on
        top of the caller's.

        ``kind`` is the logical method ("report" / "get"), resolved to
        the CURRENT stub on every attempt: channels are shared across
        threads, and a concurrent ``_reconnect`` swaps the stubs — a
        captured callable would keep dialing the closed channel for
        the rest of the deadline ("Cannot invoke RPC on closed
        channel!" forever)."""
        failover = master_failover_enabled()
        if deadline_s is None:
            deadline_s = getattr(self._deadline_override, "s", None)
        if deadline_s is None:
            deadline_s = (
                master_reconnect_deadline_s() if failover else 60.0
            )
        deadline = time.monotonic() + deadline_s
        injector = get_fault_injector()
        err: Optional[Exception] = None
        attempt = 0
        while True:
            attempt += 1
            try:
                if self._closed:
                    raise ConnectionError(
                        f"channel to {self._addr} closed locally"
                    )
                rpc = (
                    self._report if kind == "report" else self._get
                )
                action = ""
                if injector is not None:
                    action = injector.on_rpc(msg_name)
                self.rpc_count += 1
                if action == "dup":
                    # duplicate delivery: the extra send exercises the
                    # master's idempotency; the caller consumes the
                    # second (authoritative) answer
                    self.rpc_count += 1
                    rpc(payload, timeout=timeout)
                raw = rpc(payload, timeout=timeout)
                if (
                    attempt > 1
                    and failover
                    and msg_name != "ControlEpochRequest"
                ):
                    # the call came back after failures: the master
                    # may be a NEW incarnation (or job epoch) — learn
                    # the fencing pair so delta caches invalidate and
                    # subsequent RPCs fence correctly
                    try:
                        self.refresh_epoch(deadline_s=10.0)
                    except ConnectionError:
                        pass  # it flapped; the answer still stands
                return raw
            except (
                grpc.RpcError,
                FaultInjectedError,
                ValueError,  # "Cannot invoke RPC on closed channel!"
            ) as e:
                err = e
                logger.warning(
                    "master rpc to %s failed (attempt %d): %s",
                    self._addr, attempt, e,
                )
                if not failover:
                    # kill-switched: today's fixed sleep schedule
                    # EXACTLY (1 s, 2 s, 4 s … cap 5 s, after every
                    # failure including the last) — the legacy path
                    # tolerated a multi-second master stall between
                    # attempts, and shrinking that window would turn
                    # survivable flakes into job crashes
                    delay = min(2.0 ** (attempt - 1), 5.0)
                    t0_mono = time.monotonic()
                    time.sleep(delay)
                    if attempt >= self._max_retry:
                        break
                    self.retry_count += 1
                    self._emit_retry_span(t0_mono, delay, attempt)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                delay = self._backoff(attempt, remaining)
                self.retry_count += 1
                t0_mono = time.monotonic()
                time.sleep(delay)
                self._emit_retry_span(t0_mono, delay, attempt)
                if (
                    failover
                    and attempt % self.RECONNECT_AFTER_FAILURES == 0
                ):
                    # rebuild swaps self._report/self._get for stubs
                    # on the NEW channel; every attempt re-resolves
                    # from ``kind`` so all threads pick them up
                    self._reconnect()
                if failover and msg_name != "ControlEpochRequest":
                    # probe the epoch BEFORE re-issuing: a parked
                    # long-poll re-sent to a restarted master would
                    # otherwise park its whole chunk before the
                    # client learns the incarnation changed and
                    # re-asserts linger-window-lost state (joins, kv
                    # sets) via on_epoch_change.  The probe is ONE
                    # quick attempt (deadline_s caps its own retry
                    # loop) — the OUTER deadline owns the waiting.
                    try:
                        self.refresh_epoch(timeout=2.0, deadline_s=2.0)
                    except ConnectionError:
                        pass  # still down; keep backing off
        raise ConnectionError(f"master at {self._addr} unreachable: {err}")

    def _emit_retry_span(self, t0_mono: float, delay: float, attempt: int):
        from dlrover_tpu_torch.observability.events import (
            anchored_now,
            get_event_logger,
        )

        # after-the-fact complete(): the start must come off the
        # anchored clock or an NTP step during a retry storm puts
        # these X-spans on a different timeline than B/E spans
        get_event_logger().complete(
            "control_wait", anchored_now(t0_mono), delay,
            kind="retry", retries=attempt,
        )

    def refresh_epoch(
        self, timeout: float = 5.0,
        deadline_s: Optional[float] = None,
    ) -> bool:
        """Learn the master's current ``(job_epoch, incarnation)``.
        Returns True when the pair CHANGED (caches must be dropped).
        ``deadline_s`` bounds the total retry budget — callers probing
        from inside another deadline must pass it."""
        raw = self._call_with_retry(
            "get",
            self._wrap(ControlEpochRequest()),
            timeout,
            msg_name="ControlEpochRequest",
            deadline_s=deadline_s,
        )
        response = deserialize_message(raw)
        epoch = getattr(response, "job_epoch", None)
        inc = getattr(response, "incarnation", None)
        if epoch is None or inc is None:
            return False
        changed = (
            epoch != self.job_epoch or inc != self.master_incarnation
        )
        self.job_epoch, self.master_incarnation = epoch, inc
        if changed and self.on_epoch_change is not None:
            try:
                self.on_epoch_change(epoch, inc)
            except Exception as e:  # noqa: BLE001
                logger.warning("epoch-change callback failed: %s", e)
        return changed

    def _adopt(self, stale: StaleEpoch):
        changed = (
            stale.job_epoch != self.job_epoch
            or stale.incarnation != self.master_incarnation
        )
        self.job_epoch = stale.job_epoch
        self.master_incarnation = stale.incarnation
        if changed and self.on_epoch_change is not None:
            try:
                self.on_epoch_change(stale.job_epoch, stale.incarnation)
            except Exception as e:  # noqa: BLE001
                logger.warning("epoch-change callback failed: %s", e)

    def _roundtrip(self, kind: str, message: Message, timeout: float):
        """Serialize, send with retry, deserialize — with transparent
        StaleEpoch refresh+re-issue under failover."""
        name = type(message).__name__
        for _ in range(self.MAX_EPOCH_REFRESHES):
            raw = self._call_with_retry(
                kind, self._wrap(message), timeout, msg_name=name
            )
            response = deserialize_message(raw)
            if not isinstance(response, StaleEpoch):
                return response
            if not master_failover_enabled():
                raise StaleEpochError(
                    f"master fenced {name}: job_epoch="
                    f"{response.job_epoch}"
                )
            self._adopt(response)
        raise StaleEpochError(
            f"master kept fencing {name} after "
            f"{self.MAX_EPOCH_REFRESHES} epoch refreshes"
        )

    def report(self, message: Message, timeout: Optional[float] = None) -> bool:
        response = self._roundtrip(
            "report", message, timeout or self._timeout
        )
        return bool(response and getattr(response, "success", False))

    def get(self, message: Message, timeout: Optional[float] = None):
        return self._roundtrip(
            "get", message, timeout or self._timeout
        )
