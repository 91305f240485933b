"""Cross-node checkpoint replicas: peer shm backup + recovery.

Copy of ``dlrover_tpu/agent/replica.py``: the same protocol, so a
replica service of either package serves the other's clients.

Reference parity: ``dlrover/trainer/torch/flash_checkpoint/replica.py``
(``CkptReplicaManger:28,73``: backup shm shards to peer ranks via
allgather ``:116``, ``gather:193`` restores a relaunched node's shard
from its peer).  The reference rides NCCL/gloo; agents here exchange
shard bytes host-to-host over a tiny length-prefixed TCP protocol
(DCN path — device HBM is never involved), so a node that comes back
with empty shm can pull its last snapshot from its backup peer faster
than any storage read.

Protocol (one request per connection):
  ``GET <rank>\n``              -> ``<8-byte len><payload>`` (len 0 = miss)
  ``PUT <rank> <len>\n<bytes>`` -> ``OK\n``
"""

import socket
import threading
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common.env import get_free_port
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.netio import (
    LEN as _LEN,
    recv_exact as _recv_exact,
    recv_line as _recv_line,
)


class ReplicaService:
    """Per-agent replica store + TCP server."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._store: Dict[int, bytes] = {}
        self._lock = threading.Lock()
        self._port = port or get_free_port()
        self._host = host
        self._srv: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    @property
    def port(self) -> int:
        return self._port

    # -------------------------------------------------------- local API
    def put_local(self, rank: int, payload: bytes):
        with self._lock:
            self._store[rank] = payload

    def get_local(self, rank: int) -> Optional[bytes]:
        with self._lock:
            return self._store.get(rank)

    # ----------------------------------------------------------- server
    def start(self):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self._host, self._port))
        self._srv.listen(8)
        self._srv.settimeout(0.5)
        self._thread = threading.Thread(
            target=self._serve, name="replica-service", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._srv is not None:
            self._srv.close()

    def _serve(self):
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
                logger.warning("replica request failed: %s", e)
            finally:
                conn.close()

    def _handle(self, conn: socket.socket):
        line = _recv_line(conn)
        parts = line.split()
        if parts[0] == "GET":
            payload = self.get_local(int(parts[1])) or b""
            conn.sendall(_LEN.pack(len(payload)))
            if payload:
                conn.sendall(payload)
        elif parts[0] == "PUT":
            rank, size = int(parts[1]), int(parts[2])
            payload = _recv_exact(conn, size)
            self.put_local(rank, payload)
            conn.sendall(b"OK\n")


def push_replica(addr: str, rank: int, payload: bytes,
                 timeout: float = 60.0) -> bool:
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection(
            (host, int(port)), timeout=timeout
        ) as conn:
            conn.sendall(f"PUT {rank} {len(payload)}\n".encode())
            conn.sendall(payload)
            return _recv_line(conn) == "OK"
    except (OSError, ConnectionError) as e:
        logger.warning("replica push to %s failed: %s", addr, e)
        return False


def fetch_replica(addr: str, rank: int,
                  timeout: float = 60.0) -> Optional[bytes]:
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection(
            (host, int(port)), timeout=timeout
        ) as conn:
            conn.sendall(f"GET {rank}\n".encode())
            size = _LEN.unpack(_recv_exact(conn, _LEN.size))[0]
            if size == 0:
                return None
            return _recv_exact(conn, size)
    except (OSError, ConnectionError) as e:
        logger.warning("replica fetch from %s failed: %s", addr, e)
        return None


class ReplicaManager:
    """Backs up this node's shard to ``(node_rank + k) % n`` peers.

    ``peer_addrs`` maps node_rank -> "host:port" of each agent's
    ReplicaService (agents register these through the master's
    NodeAddress registry).
    """

    def __init__(
        self,
        node_rank: int,
        service: ReplicaService,
        peer_addrs_fn: Callable[[], Dict[int, str]],
        backup_count: int = 1,
    ):
        self._node_rank = node_rank
        self._service = service
        self._peer_addrs_fn = peer_addrs_fn
        self._backup_count = backup_count

    def backup(self, payload: bytes) -> int:
        """Push this node's shard to its backup peers; returns how many
        replicas landed."""
        peers = self._peer_addrs_fn()
        n = len(peers)
        if n <= 1:
            return 0
        ok = 0
        for k in range(1, self._backup_count + 1):
            target = (self._node_rank + k) % n
            if target == self._node_rank:
                continue
            addr = peers.get(target)
            if addr and push_replica(addr, self._node_rank, payload):
                ok += 1
        return ok

    def restore(self) -> Optional[bytes]:
        """A relaunched node pulls its shard from whichever peer holds
        the replica (reference ``gather:193``)."""
        local = self._service.get_local(self._node_rank)
        if local is not None:
            return local
        peers = self._peer_addrs_fn()
        n = len(peers)
        # replicas were pushed to (rank + k): ask those peers
        for k in range(1, max(n, 2)):
            holder = (self._node_rank + k) % n
            if holder == self._node_rank:
                continue
            addr = peers.get(holder)
            if not addr:
                continue
            payload = fetch_replica(addr, self._node_rank)
            if payload is not None:
                logger.info(
                    "restored shard %d from peer %d (%d bytes)",
                    self._node_rank, holder, len(payload),
                )
                return payload
        return None
