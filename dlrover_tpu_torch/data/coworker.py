"""Coworker data plane: remote CPU preprocessing for TPU trainers.

Copy of ``dlrover_tpu/data/coworker.py``.

Reference parity: ``atorch/atorch/service/coworker_data_service.py:43``
(``CoworkerRpcServicer`` — CPU pods preprocess batches into a queue,
GPU pods pull them over gRPC), ``data/coworker_dataset.py:13``
(``CoworkerDataset`` round-robin client) and the DataInfoService
registration path.

TPU form: the accelerator host's cores are busy feeding the chips, so
preprocessing (tokenization, augmentation, decoding) runs on cheap CPU
pods.  Each coworker runs :class:`CoworkerServer` — a bounded queue
filled by a preprocessing thread, served over a one-request TCP
protocol — and registers its address in the master KV store; trainers
pull with :class:`CoworkerClient` round-robin and fail over when a
coworker dies.

Wire format: batches are pytrees of numpy arrays serialized with
``numpy.savez`` (flat keystr keys) — array-native, NO pickle on the
data path, so a compromised coworker cannot execute code in the
trainer.

Protocol (one request per connection, like the replica service):
  ``GET\n``  -> ``<8-byte big-endian len><npz bytes>``
  len 0       = data source cleanly exhausted
  len 2^64-1  = coworker preprocessing FAILED (clients fail over and
                raise if every coworker failed — a crashed pipeline
                must not masquerade as end-of-epoch)
"""

import io
import queue
import socket
import threading
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from dlrover_tpu_torch.common.env import get_free_port
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.netio import (
    LEN as _LEN,
    recv_exact as _recv_exact,
    recv_line as _recv_line,
)

_ERR_SENTINEL = (1 << 64) - 1
KV_PREFIX = "coworker/"


class CoworkerFailedError(RuntimeError):
    """The coworker's preprocessing pipeline crashed (distinct from
    being unreachable, which failover tolerates)."""


def encode_batch(batch: Dict[str, np.ndarray]) -> bytes:
    """Flat {name: ndarray} -> npz bytes (allow_pickle stays off)."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in batch.items()})
    return buf.getvalue()


def decode_batch(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class CoworkerServer:
    """CPU-pod side: preprocess ``source`` items with ``preprocess_fn``
    into a bounded queue; serve one batch per TCP request."""

    def __init__(
        self,
        source: Iterable,
        preprocess_fn: Callable[[object], Dict[str, np.ndarray]],
        host: str = "0.0.0.0",
        port: int = 0,
        queue_size: int = 8,
    ):
        self._source = source
        self._preprocess = preprocess_fn
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._host = host
        self._port = port or get_free_port()
        self._srv: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()
        self._exhausted = threading.Event()
        self._failed = threading.Event()

    @property
    def port(self) -> int:
        return self._port

    def start(self):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self._host, self._port))
        self._srv.listen(8)
        self._srv.settimeout(0.5)
        for target, name in (
            (self._fill_loop, "coworker-preprocess"),
            (self._serve_loop, "coworker-serve"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        logger.info("coworker serving on port %d", self._port)

    def stop(self):
        self._stopped.set()
        if self._srv is not None:
            self._srv.close()

    # -- preprocessing ----------------------------------------------------
    def _fill_loop(self):
        try:
            for item in self._source:
                if self._stopped.is_set():
                    return
                payload = encode_batch(self._preprocess(item))
                while not self._stopped.is_set():
                    try:
                        self._queue.put(payload, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # noqa: BLE001
            logger.error("coworker preprocessing failed: %s", e)
            self._failed.set()
        finally:
            self._exhausted.set()

    # -- serving ----------------------------------------------------------
    def _serve_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._handle(conn)
            except (ConnectionError, OSError) as e:
                logger.warning("coworker request failed: %s", e)
            finally:
                conn.close()

    def _handle(self, conn: socket.socket):
        try:
            line = _recv_line(conn)
        except ConnectionError:
            return
        if line != "GET":
            return
        payload = None
        while payload is None and not self._stopped.is_set():
            try:
                payload = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._exhausted.is_set() and self._queue.empty():
                    break
        if payload is None:
            if self._failed.is_set():
                # a crashed pipeline must not look like a clean end of
                # the source — the client raises on the sentinel
                conn.sendall(_LEN.pack(_ERR_SENTINEL))
            elif self._exhausted.is_set():
                conn.sendall(_LEN.pack(0))  # clean end of data
            # stopping with data still queued: close WITHOUT replying —
            # the client treats the broken connection as unreachable
            # and fails over, never as end-of-data
            return
        try:
            conn.sendall(_LEN.pack(len(payload)))
            conn.sendall(payload)
        except (OSError, ConnectionError):
            # the client vanished mid-send (timeout/restart): the batch
            # was popped but not delivered — put it back so the sample
            # is not silently dropped from the epoch
            try:
                self._queue.put_nowait(payload)
            except queue.Full:
                logger.warning(
                    "dropping one batch: send failed and queue full"
                )
            raise

    # -- registration -----------------------------------------------------
    def register(self, master_client, coworker_id: int,
                 advertise_host: Optional[str] = None) -> bool:
        """Publish this coworker's address in the master KV store (the
        reference's DataInfoService registration)."""
        host = advertise_host or socket.gethostbyname(
            socket.gethostname()
        )
        return master_client.kv_store_set(
            f"{KV_PREFIX}{coworker_id}",
            f"{host}:{self._port}".encode(),
        )


class CoworkerClient:
    """Trainer side: round-robin batch pulls with failover."""

    def __init__(self, addrs: List[str], timeout: float = 60.0):
        if not addrs:
            raise ValueError("no coworker addresses")
        self._addrs = list(addrs)
        self._timeout = timeout
        self._next = 0
        self._dead: set = set()  # unreachable (tolerated: failover)
        self._failed: set = set()  # reported pipeline FAILURE

    @classmethod
    def from_master(cls, master_client, max_coworkers: int = 64,
                    **kwargs) -> "CoworkerClient":
        """Discover coworker addresses from the master KV store."""
        addrs = []
        for i in range(max_coworkers):
            raw = master_client.kv_store_get(f"{KV_PREFIX}{i}")
            if not raw:
                break
            addrs.append(raw.decode())
        return cls(addrs, **kwargs)

    def _fetch(self, addr: str) -> Optional[Dict[str, np.ndarray]]:
        host, _, port = addr.rpartition(":")
        with socket.create_connection(
            (host, int(port)), timeout=self._timeout
        ) as conn:
            conn.sendall(b"GET\n")
            size = _LEN.unpack(_recv_exact(conn, _LEN.size))[0]
            if size == _ERR_SENTINEL:
                raise CoworkerFailedError(
                    f"coworker {addr} reports preprocessing failure"
                )
            if size == 0:
                return None
            return decode_batch(_recv_exact(conn, size))

    def next_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """The next preprocessed batch, or None when every live
        coworker reports an exhausted source."""
        exhausted = 0
        attempts = 0
        n = len(self._addrs)
        while attempts < 2 * n and exhausted < n - len(self._dead):
            idx = self._next % n
            self._next += 1
            attempts += 1
            if idx in self._dead:
                continue
            addr = self._addrs[idx]
            try:
                batch = self._fetch(addr)
            except CoworkerFailedError as e:
                logger.error("coworker %s: %s", addr, e)
                self._dead.add(idx)
                self._failed.add(idx)
                continue
            except (OSError, ConnectionError) as e:
                logger.warning(
                    "coworker %s unreachable (%s); failing over",
                    addr, e,
                )
                self._dead.add(idx)
                continue
            if batch is None:
                exhausted += 1
                continue
            return batch
        if self._failed:
            # ANY coworker that reported a preprocessing failure means
            # part of the dataset was dropped — surfacing end-of-epoch
            # here would silently truncate training data
            raise RuntimeError(
                f"coworker(s) {sorted(self._failed)} reported "
                "preprocessing failures; refusing to present a crashed "
                "pipeline as end-of-data"
            )
        if exhausted == 0 and len(self._dead) >= n:
            # no coworker ever finished cleanly and all are gone: a
            # fully-dead data plane is an outage, not end-of-epoch
            raise RuntimeError(
                "all coworkers unreachable with none cleanly "
                "exhausted; data plane is down"
            )
        return None


class CoworkerDataset:
    """Iterator facade over :class:`CoworkerClient` (reference
    ``CoworkerDataset``): ``for batch in CoworkerDataset(client)``."""

    def __init__(self, client: CoworkerClient):
        self._client = client

    def __iter__(self):
        while True:
            batch = self._client.next_batch()
            if batch is None:
                return
            yield batch
