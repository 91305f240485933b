"""Pre-fork worker zygote: restart workers without re-paying imports.

Port of ``dlrover_tpu/agent/zygote.py``.  Restart-to-first-step latency
is goodput lost to every failure, and a fresh worker first pays for its
imports: ``import torch`` and the port's modules, and ``torch._dynamo``,
which the meta-device census of ``auto_accelerate`` pulls in
(``torch._refs``' ``normal_`` reaches ``torch._compile``): 5.8-9.0 s
and 7.1-10.4 s of a restart on an H100 without the zygote
(``PERF.md``).  The agent instead keeps a **zygote** process alive —
started once, with those modules imported but CUDA never touched — and
forks each worker
incarnation from it.  A fork inherits the warm ``sys.modules``, so a
restarted worker starts at its CUDA context.

Safety rules baked in:

- the zygote NEVER initialises CUDA: no ``torch.cuda.is_available()``
  or ``device_count()`` (each calls ``cuInit`` unless the NVML check is
  on), no device, no tensor on ``cuda``.  A CUDA context does not
  survive ``fork``; after preload it refuses to serve if
  ``torch.cuda.is_initialized()``, and each child checks
  ``torch.cuda.is_initialized()`` and ``torch.cuda._is_in_bad_fork()``
  before it runs the worker, and fails loudly if either is set;
- the zygote runs no torch op, so torch's intra-op pool never starts,
  opens no gRPC channel, and is single-threaded in Python (reaping is
  polled between socket requests, no SIGCHLD handler, no reaper
  thread), so a forked child cannot inherit a lock held by a
  background thread.  ``import numpy`` starts OpenBLAS's worker
  threads; OpenBLAS shuts them down in its own ``pthread_atfork``
  handler and the child starts its own;
- environment read at import time: libgomp (loaded with torch) takes
  ``OMP_NUM_THREADS`` then, so the child re-applies a spawn env's value
  with ``torch.set_num_threads``; the variables that ``torch._dynamo``,
  ``torch._inductor``, ``torch.jit`` and the BLAS libraries read at
  import (``IMPORT_TIME_ENV_PREFIXES``) cannot be re-applied, so a
  spawn env that changes one of them is not forked (a logged plain
  spawn).  What the port and the rest of torch read, they read when
  called, in the child, from its env: ``PYTORCH_CUDA_ALLOC_CONF`` (at
  the allocator's first use), ``CUDA_VISIBLE_DEVICES`` (at ``cuInit``),
  ``DLROVER_TPU_TORCH_BUILD_DIR`` (``ops/_build.build_dir``), the NCCL
  settings (at the communicator's creation) and
  ``DLROVER_TPU_EVENTS_FILE`` (the child drops any event logger the
  zygote made).

The agent talks to the zygote over a length-prefixed pickled unix
socket (the repo's standard local IPC frame, ``common/multi_process``);
``ZygotePool`` exposes Popen-shaped handles so the agent's monitor loop
is oblivious to how a worker was spawned.  A spawn while the zygote is
still importing waits for it (those are the imports the worker would
pay itself); a spawn with the zygote gone or broken falls back to plain
``subprocess`` spawn, logged.  A forked child has
``DLROVER_TPU_SPAWN=zygote`` in its environment; the agent sets
``plain`` for a ``subprocess`` spawn.
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    _recv_msg,
    _send_msg,
    _socket_path,
)

# modules worth pre-importing: torch, the port's worker-side surface, and
# torch._dynamo, which auto_accelerate's census on the meta device pulls
# in (none of them reads the environment at import, see the module doc)
DEFAULT_PRELOAD = (
    "torch",
    "numpy",
    "torch._dynamo",
    "dlrover_tpu_torch.accelerate",
    "dlrover_tpu_torch.models.llama",
    "dlrover_tpu_torch.optimizers",
    "dlrover_tpu_torch.trainer.elastic",
)

#: read once when torch (libgomp) is imported; the child re-applies a
#: spawn env's value with ``torch.set_num_threads``
THREADS_ENV = "OMP_NUM_THREADS"

#: environment read when the preloaded modules are imported and never
#: again (``torch._dynamo``/``torch._inductor`` configs, ``torch.jit``,
#: the BLAS libraries' thread pools): a spawn env that differs from the
#: zygote's in one of these is not forked
IMPORT_TIME_ENV_PREFIXES = (
    "TORCHDYNAMO_",
    "TORCHINDUCTOR_",
    "TORCH_COMPILE",
    "TORCH_LOGS",
    "PYTORCH_JIT",
    "OPENBLAS_",
    "MKL_",
    "KMP_",
    "GOMP_",
)

#: the environment variable that tells a worker how it was spawned
SPAWN_ENV = "DLROVER_TPU_SPAWN"


def import_time_env_diff(zygote_env: Dict[str, str],
                         spawn_env: Dict[str, str]) -> List[str]:
    """Names of import-time variables (``IMPORT_TIME_ENV_PREFIXES``)
    whose value differs between the zygote's env and a spawn env."""
    keys = {k for k in (*zygote_env, *spawn_env)
            if k.startswith(IMPORT_TIME_ENV_PREFIXES)}
    return sorted(k for k in keys
                  if zygote_env.get(k) != spawn_env.get(k))


def _exit_code(status: int) -> int:
    """waitpid status -> Popen-style returncode (negative signal)."""
    if os.WIFSIGNALED(status):
        return -os.WTERMSIG(status)
    if os.WIFEXITED(status):
        return os.WEXITSTATUS(status)
    return 1


def exit_record_dir(sock_path: str) -> str:
    return sock_path + ".exits"


def _record_exit(exit_dir: str, pid: int, code: int):
    """Atomically record a child's own exit code: the fallback truth
    source when the zygote (and its waitpid bookkeeping) is gone.  A
    signal-killed child writes nothing — absence means abnormal."""
    try:
        tmp = os.path.join(exit_dir, f".{pid}.tmp")
        with open(tmp, "w") as f:
            f.write(str(code))
        os.rename(tmp, os.path.join(exit_dir, str(pid)))
    except OSError:
        pass


def _os_threads() -> int:
    try:
        return len(os.listdir("/proc/self/task"))
    except OSError:
        return -1


def cuda_driver_loaded() -> bool:
    """Whether the CUDA driver library is mapped into this process (the
    runtime loads it at its first call; ``import torch`` does not): a
    check that does not itself touch the driver."""
    try:
        with open("/proc/self/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return False


def read_exit_record(exit_dir: str, pid: int) -> Optional[int]:
    try:
        with open(os.path.join(exit_dir, str(pid))) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _fixup_torch(spawn_env: Dict[str, str]):
    """Align the preloaded torch with the CHILD's env and check that it
    is still fit to take the card: re-apply ``OMP_NUM_THREADS``, drop
    the zygote's event logger, refuse if CUDA was initialised before
    the fork (no-op when torch is not preloaded)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    if torch.cuda.is_initialized() or torch.cuda._is_in_bad_fork():
        raise RuntimeError(
            "zygote child: CUDA was initialised before the fork "
            f"(initialized={torch.cuda.is_initialized()}, bad fork="
            f"{torch.cuda._is_in_bad_fork()}): this worker cannot use "
            "the card")
    raw = spawn_env.get(THREADS_ENV, "")
    if raw.isdigit() and int(raw) > 0 and torch.get_num_threads() != int(raw):
        torch.set_num_threads(int(raw))
    events = sys.modules.get("dlrover_tpu_torch.observability.events")
    if events is not None:
        events._default_logger = None  # the child's own, from its env


def _run_child(argv: Sequence[str], env: Dict[str, str]) -> int:
    """Become the worker: runs in the forked child, never returns to
    the server loop (caller os._exit()s with the return value)."""
    import runpy

    os.environ.clear()
    os.environ.update(env)
    os.environ[SPAWN_ENV] = "zygote"
    # the zygote ignores nothing special, but inherited dispositions
    # must not leak into trainers that install their own handlers
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    if argv and argv[0] == "-m":
        sys.argv = list(argv[1:])
        target, mode = argv[1], "module"
    else:
        sys.argv = list(argv)
        target, mode = argv[0], "path"
    try:
        _fixup_torch(env)
        if mode == "module":
            runpy.run_module(
                target, run_name="__main__", alter_sys=True
            )
        else:
            runpy.run_path(target, run_name="__main__")
        return 0
    except SystemExit as e:
        code = e.code
        if code is None:
            return 0
        return code if isinstance(code, int) else 1
    except BaseException:  # noqa: BLE001 - worker crash surface
        import traceback

        traceback.print_exc()
        return 1


class ZygoteServer:
    """Single-threaded fork server (run via ``python -m
    dlrover_tpu_torch.agent.zygote``)."""

    def __init__(self, sock_name: str, preload: Sequence[str]):
        self._path = _socket_path(sock_name)
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._listener = socket.socket(
            socket.AF_UNIX, socket.SOCK_STREAM
        )
        self._listener.bind(self._path)
        self._listener.listen(4)
        self._listener.settimeout(0.2)
        self._exit_codes: Dict[int, int] = {}
        self._live: set = set()
        self._conn: Optional[socket.socket] = None
        # children record their OWN exit code here (exit_record_dir):
        # if the zygote dies, the agent can still distinguish a clean
        # worker completion from a crash instead of failing the rank
        self._exit_dir = exit_record_dir(self._path)
        os.makedirs(self._exit_dir, exist_ok=True)
        for stale in os.listdir(self._exit_dir):
            try:
                os.unlink(os.path.join(self._exit_dir, stale))
            except OSError:
                pass
        self._preload(preload)

    def _preload(self, modules: Sequence[str]):
        import importlib

        t0 = time.time()
        for mod in modules:
            try:
                importlib.import_module(mod)
            except Exception as e:  # noqa: BLE001
                print(
                    f"zygote: preload {mod} failed: {e}",
                    file=sys.stderr,
                    flush=True,
                )
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            # a CUDA context would not survive fork — refuse to serve
            raise RuntimeError(
                "zygote preload initialised CUDA; remove the offending "
                "preload module"
            )
        print(
            f"zygote: ready ({len(modules)} modules in "
            f"{time.time() - t0:.1f}s, {_os_threads()} OS threads, CUDA "
            f"driver {'loaded' if cuda_driver_loaded() else 'not loaded'})",
            file=sys.stderr,
            flush=True,
        )

    def _reap(self):
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            self._live.discard(pid)
            self._exit_codes[pid] = _exit_code(status)

    def _spawn(self, argv: Sequence[str], env: Dict[str, str]) -> int:
        pid = os.fork()
        if pid != 0:
            # the kernel recycles pids: stale exit state recorded for a
            # PREVIOUS child under this pid would make poll report the
            # old exit code for the live worker
            self._exit_codes.pop(pid, None)
            try:
                os.unlink(os.path.join(self._exit_dir, str(pid)))
            except OSError:
                pass
        if pid == 0:
            code = 1
            try:
                # drop BOTH server fds: a worker holding the accepted
                # agent connection would keep it from seeing EOF after
                # a zygote crash (poll RPCs would block to timeout)
                self._listener.close()
                if self._conn is not None:
                    self._conn.close()
                code = _run_child(argv, env)
            finally:
                code = code if isinstance(code, int) else 1
                _record_exit(self._exit_dir, os.getpid(), code)
                os._exit(code)
        self._live.add(pid)
        return pid

    def _handle(self, req) -> Tuple:
        cmd = req.get("cmd")
        if cmd == "spawn":
            # the entrypoint always starts with a python executable;
            # the fork IS the interpreter, so drop it
            argv = list(req["argv"])
            if argv and os.path.basename(argv[0]).startswith("python"):
                argv = argv[1:]
            return ("ok", self._spawn(argv, req["env"]))
        if cmd == "poll":
            self._reap()
            return ("ok", self._exit_codes.get(req["pid"]))
        if cmd == "ping":
            return ("ok", os.getpid())
        if cmd == "shutdown":
            return ("bye", None)
        return ("err", f"unknown cmd {cmd!r}")

    def serve_forever(self):
        try:
            while True:
                self._reap()
                if self._conn is None:
                    try:
                        self._conn, _ = self._listener.accept()
                        self._conn.settimeout(0.2)
                    except socket.timeout:
                        continue
                try:
                    req = _recv_msg(self._conn)
                except socket.timeout:
                    continue
                except (ConnectionError, EOFError, OSError):
                    self._conn.close()
                    self._conn = None
                    continue
                resp = self._handle(req)
                try:
                    _send_msg(self._conn, resp)
                except OSError:
                    self._conn.close()
                    self._conn = None
                if resp[0] == "bye":
                    return
        finally:
            if self._conn is not None:
                self._conn.close()
            self._listener.close()
            try:
                os.unlink(self._path)
            except OSError:
                pass


class ZygoteHandle:
    """Popen-shaped handle for a zygote-forked worker."""

    def __init__(self, pid: int, pool: "ZygotePool"):
        self.pid = pid
        self._pool = pool
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        try:
            self.returncode = self._pool._rpc(
                {"cmd": "poll", "pid": self.pid}
            )
        except (ConnectionError, OSError):
            # zygote gone: its children were reparented to init and
            # keep running.  The child's own exit record is consulted
            # FIRST: after a clean exit the kernel may recycle the pid
            # for an unrelated process, and a liveness probe alone
            # would then report the dead rank as running forever
            # (ADVICE-r4).  A signal death writes no record; only then
            # does the probe decide alive vs ORPHAN_EXIT.
            recorded = read_exit_record(
                self._pool.exit_dir, self.pid
            )
            if recorded is not None:
                self.returncode = recorded
            else:
                try:
                    os.kill(self.pid, 0)
                except ProcessLookupError:
                    self.returncode = ZygotePool.ORPHAN_EXIT
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired(
                    f"zygote-worker-{self.pid}", timeout
                )
            time.sleep(0.05)

    def send_signal(self, sig: int):
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass

    def terminate(self):
        self.send_signal(signal.SIGTERM)

    def kill(self):
        self.send_signal(signal.SIGKILL)


class ZygotePool:
    """Agent-side client; spawns workers through the fork server.

    ``spawn`` falls back to ``subprocess.Popen``, with a warning, when
    the zygote is missing or broken, or the spawn env changes what the
    zygote read at import — worker startup must never fail because the
    LATENCY optimization did.
    """

    # sentinel returncode when the zygote died and took the exit
    # status with it (nonzero -> the agent treats the worker as failed)
    ORPHAN_EXIT = -257

    def __init__(
        self,
        name: str = "zygote",
        preload: Sequence[str] = DEFAULT_PRELOAD,
        start_timeout: float = 120.0,
    ):
        self._sock_name = name
        self._preload = tuple(preload)
        self._start_timeout = start_timeout
        self._proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self._env: Dict[str, str] = {}
        self._ready = False

    @property
    def exit_dir(self) -> str:
        return exit_record_dir(_socket_path(self._sock_name))

    # ----------------------------------------------------------- server
    def start(
        self, env: Optional[Dict[str, str]] = None, wait: bool = False
    ) -> bool:
        """Launch the fork server with the agent's worker base env.

        Non-blocking by default: the preload takes seconds and runs
        beside whatever the agent does before its first spawn (the
        node check, the rendezvous); ``spawn`` waits for what is left
        of it.  ``wait=True`` blocks until ready and returns whether
        the zygote came up."""
        env = dict(env or os.environ)
        # the server must import dlrover_tpu_torch regardless of how
        # the caller made it importable (sys.path edits don't inherit)
        import dlrover_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(dlrover_tpu_torch.__file__))
        )
        parts = env.get("PYTHONPATH", "").split(os.pathsep)
        if pkg_root not in parts:
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in [pkg_root, *parts] if p
            )
        self._env = env
        # should anything in the preload ask whether CUDA is there, NVML
        # answers (no cuInit; the zygote's own env, not the workers')
        zygote_env = dict(env)
        zygote_env.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
        self._proc = subprocess.Popen(  # noqa: S603
            [
                sys.executable,
                "-m",
                "dlrover_tpu_torch.agent.zygote",
                "--socket",
                self._sock_name,
                "--preload",
                ",".join(self._preload),
            ],
            env=zygote_env,
        )
        if not wait:
            return True
        if self.wait_ready():
            return True
        self.close()
        return False

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the zygote answers a ping (its preload done);
        False when it exited or did not answer within ``timeout``
        (default ``start_timeout``)."""
        if self._ready:
            return True
        deadline = time.time() + (
            self._start_timeout if timeout is None else timeout)
        while time.time() < deadline:
            if not self.alive:
                logger.warning(
                    "zygote exited %s during startup",
                    None if self._proc is None else self._proc.returncode,
                )
                return False
            try:
                if self._rpc({"cmd": "ping"}):
                    self._ready = True
                    return True
            except (ConnectionError, OSError):
                time.sleep(0.2)
        logger.warning("zygote did not come up in time")
        return False

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(10.0)
            s.connect(_socket_path(self._sock_name))
            self._sock = s
        return self._sock

    def _rpc(self, req):
        try:
            sock = self._connect()
            _send_msg(sock, req)
            status, result = _recv_msg(sock)
        except (ConnectionError, OSError, socket.timeout):
            if self._sock is not None:
                self._sock.close()
                self._sock = None
            raise ConnectionError("zygote unreachable")
        if status == "err":
            raise RuntimeError(result)
        return result

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    # ----------------------------------------------------------- spawn
    def spawn(self, argv: List[str], env: Dict[str, str]):
        """Fork a worker (zygote) or Popen it (fallback, logged);
        returns a Popen-shaped handle either way."""
        why = "the zygote is not running"
        changed = import_time_env_diff(self._env, env)
        if changed:
            why = f"the spawn env changes import-time {changed}"
        elif self.alive and self.wait_ready():
            try:
                pid = self._rpc(
                    {"cmd": "spawn", "argv": argv, "env": env}
                )
                return ZygoteHandle(pid, self)
            except (ConnectionError, RuntimeError) as e:
                why = f"the zygote's spawn failed ({e})"
        elif self._proc is not None:
            why = "the zygote did not come up"
        logger.warning("plain spawn of %s: %s", argv, why)
        return subprocess.Popen(  # noqa: S603
            argv, env=dict(env, **{SPAWN_ENV: "plain"}))

    def close(self):
        if self._sock is not None:
            try:
                _send_msg(self._sock, {"cmd": "shutdown"})
                _recv_msg(self._sock)
            except (ConnectionError, OSError, socket.timeout, EOFError):
                pass
            self._sock.close()
            self._sock = None
        self._ready = False
        if self._proc is not None:
            if self._proc.poll() is None:
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.wait()
            self._proc = None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dlrover_tpu_torch.agent.zygote")
    parser.add_argument("--socket", required=True)
    parser.add_argument(
        "--preload", default=",".join(DEFAULT_PRELOAD)
    )
    args = parser.parse_args(argv)
    preload = [m for m in args.preload.split(",") if m]
    server = ZygoteServer(args.socket, preload)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
