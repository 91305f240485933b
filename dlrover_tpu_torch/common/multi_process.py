"""Cross-process primitives shared between the elastic agent and the
training processes it spawns: a lock, a queue and a dict served over a
unix-domain socket, plus a POSIX shared-memory wrapper that survives the
death of the creating process.

Copy of ``dlrover_tpu/common/multi_process.py`` with the port's own
namespace: its sockets live in ``/tmp/dlrover_tpu_torch/sockets``
(``DLROVER_TPU_TORCH_SOCKET_DIR``), so a JAX job and a port job on one
machine never attach to each other's locks, queues or dicts.

Reference parity: ``dlrover/python/common/multi_process.py:227,348,455,539``
(SharedLock / SharedQueue / SharedDict / SharedMemory).  These primitives
are the substrate of flash checkpoint: training ranks memcpy device state
into shared memory guarded by ``SharedLock`` while the agent-side saver
drains ``SharedQueue`` events and reads tensor metadata from
``SharedDict``.
"""

import os
import pickle
import queue
import socket
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

SOCKET_DIR_ENV = "DLROVER_TPU_TORCH_SOCKET_DIR"
_DEF_SOCKET_DIR = "/tmp/dlrover_tpu_torch/sockets"

_LEN = struct.Struct("<I")


def _socket_path(name: str) -> str:
    root = os.getenv(SOCKET_DIR_ENV, _DEF_SOCKET_DIR)
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, f"{name}.sock")


def _send_msg(sock: socket.socket, obj):
    data = pickle.dumps(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the local socket")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket):
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, length))


class LocalSocketComm:
    """Base of the shared primitives.

    ``master=True`` (agent side) serves the object over a unix socket;
    ``master=False`` (training-process side) proxies calls to it.
    """

    def __init__(self, name: str, create: bool):
        self._name = name
        self._path = _socket_path(name)
        self._server = create
        self._server_sock: Optional[socket.socket] = None
        self._client_sock: Optional[socket.socket] = None
        self._client_lock = threading.Lock()
        self._stopped = False
        if create:
            self._start_server()

    # -- server side -------------------------------------------------------
    def _start_server(self):
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._server_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server_sock.bind(self._path)
        self._server_sock.listen(64)
        thread = threading.Thread(
            target=self._accept_loop, name=f"lsc-{self._name}", daemon=True
        )
        thread.start()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self._server_sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket):
        with conn:
            while not self._stopped:
                try:
                    method, args = _recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                try:
                    result = getattr(self, "_do_" + method)(*args)
                    _send_msg(conn, ("ok", result))
                except Exception as e:  # noqa: BLE001 - proxied to client
                    # ship the exception object so the client re-raises
                    # the same type (queue.Empty, queue.Full, ...)
                    try:
                        _send_msg(conn, ("exc", e))
                    except Exception:
                        _send_msg(conn, ("exc", RuntimeError(repr(e))))

    def close(self):
        self._stopped = True
        if self._server_sock:
            try:
                self._server_sock.close()
            finally:
                if os.path.exists(self._path):
                    try:
                        os.unlink(self._path)
                    except OSError:
                        pass
        if self._client_sock:
            self._client_sock.close()
            self._client_sock = None

    # -- client side -------------------------------------------------------
    def _connect(self, timeout: float = 60.0):
        deadline = time.time() + timeout
        while True:
            try:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(self._path)
                self._client_sock = sock
                return
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"cannot connect local service {self._name}"
                    )
                time.sleep(0.1)

    def _call(self, method: str, *args, idempotent: bool = False):
        if self._server:
            return getattr(self, "_do_" + method)(*args)
        with self._client_lock:
            if self._client_sock is None:
                self._connect()
            try:
                _send_msg(self._client_sock, (method, args))
                status, result = _recv_msg(self._client_sock)
            except (ConnectionError, OSError):
                self._client_sock = None
                if not idempotent:
                    # the server may have applied the request before the
                    # connection died; blindly resending would duplicate
                    # a put/acquire — surface the ambiguity instead
                    raise
                # safe to retry reads once (agent may have restarted)
                self._connect()
                _send_msg(self._client_sock, (method, args))
                status, result = _recv_msg(self._client_sock)
        if status == "exc":
            raise result
        return result


class SharedLock(LocalSocketComm):
    """A lock shared between agent and training processes."""

    def __init__(self, name: str, create: bool = False):
        self._lock = threading.Lock() if create else None
        super().__init__("lock_" + name, create)

    def _do_acquire(self, blocking: bool, timeout: float) -> bool:
        if blocking:
            return self._lock.acquire(timeout=timeout)
        return self._lock.acquire(blocking=False)

    def _do_release(self) -> bool:
        try:
            self._lock.release()
            return True
        except RuntimeError:
            return False

    def _do_locked(self) -> bool:
        return self._lock.locked()

    def acquire(self, blocking: bool = True, timeout: float = 600.0) -> bool:
        return self._call("acquire", blocking, timeout)

    def release(self) -> bool:
        return self._call("release")

    def locked(self) -> bool:
        return self._call("locked", idempotent=True)

    def __enter__(self):
        if not self.acquire():
            raise TimeoutError(f"cannot acquire shared lock {self._name}")
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class SharedQueue(LocalSocketComm):
    """A FIFO queue shared between agent and training processes."""

    def __init__(self, name: str, create: bool = False, maxsize: int = 0):
        self._queue: Optional[queue.Queue] = (
            queue.Queue(maxsize) if create else None
        )
        super().__init__("queue_" + name, create)

    def _do_put(self, obj, block: bool, timeout: Optional[float]):
        self._queue.put(obj, block=block, timeout=timeout)

    def _do_get(self, block: bool, timeout: Optional[float]):
        return self._queue.get(block=block, timeout=timeout)

    def _do_qsize(self) -> int:
        return self._queue.qsize()

    def _do_empty(self) -> bool:
        return self._queue.empty()

    def put(self, obj, block: bool = True, timeout: Optional[float] = None):
        return self._call("put", obj, block, timeout)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        return self._call("get", block, timeout)

    def qsize(self) -> int:
        return self._call("qsize", idempotent=True)

    def empty(self) -> bool:
        return self._call("empty", idempotent=True)


class SharedDict(LocalSocketComm):
    """A dict shared between agent and training processes.

    Writers call ``set``/``update``; the agent-side saver reads the whole
    dict with ``get_all``.
    """

    def __init__(self, name: str, create: bool = False,
                 initial: Optional[Dict] = None):
        # ``initial`` is in the dict before the server serves it: no
        # client ever reads it empty
        self._dict: Optional[Dict] = dict(initial or {}) if create else None
        super().__init__("dict_" + name, create)

    def _do_set(self, key, value):
        self._dict[key] = value

    def _do_update(self, other: Dict):
        self._dict.update(other)

    def _do_get(self, key, default=None):
        return self._dict.get(key, default)

    def _do_get_all(self) -> Dict:
        return dict(self._dict)

    def _do_clear(self):
        self._dict.clear()

    def set(self, key, value):
        return self._call("set", key, value)

    def update(self, other: Dict):
        return self._call("update", other)

    def get(self, key, default=None):
        return self._call("get", key, default, idempotent=True)

    def get_all(self) -> Dict:
        return self._call("get_all", idempotent=True)

    def clear(self):
        return self._call("clear")


def _unregister_from_resource_tracker(shm: shared_memory.SharedMemory):
    """Keep the segment alive after this process exits.

    Python's resource tracker unlinks shm segments when the creating
    process dies — exactly what flash checkpoint must prevent (the agent
    reads the segment *after* a training-process crash).  Same trick as
    the reference (``common/multi_process.py:539``).
    """
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:  # pragma: no cover - py-version specific
        logger.warning("cannot unregister shm from resource tracker")


class SharedMemory:
    """POSIX shared memory that outlives its creator.

    A thin wrapper over ``multiprocessing.shared_memory.SharedMemory``
    with resource-tracker unregistration and idempotent create/attach.
    """

    def __init__(self, name: str, create: bool = False, size: int = 0):
        self._name = name
        if create:
            try:
                self._shm = shared_memory.SharedMemory(
                    name=name, create=True, size=size
                )
            except FileExistsError:
                existing = shared_memory.SharedMemory(name=name)
                if existing.size >= size:
                    self._shm = existing
                else:
                    existing.unlink()
                    existing.close()
                    self._shm = shared_memory.SharedMemory(
                        name=name, create=True, size=size
                    )
        else:
            self._shm = shared_memory.SharedMemory(name=name)
        _unregister_from_resource_tracker(self._shm)

    @property
    def name(self) -> str:
        return self._name

    @property
    def buf(self):
        return self._shm.buf

    @property
    def size(self) -> int:
        return self._shm.size

    def close(self):
        self._shm.close()

    def unlink(self):
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
