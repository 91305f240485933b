"""``python -m dlrover_tpu_torch.run`` — the elastic launcher CLI
(torchrun analog).

Copy of ``dlrover_tpu/trainer/elastic_run.py``; the local master it
spawns is the port's (``dlrover_tpu_torch.master.main``), and
``--compile_cache_dir`` names the kernels' build directory
(``DLROVER_TPU_TORCH_BUILD_DIR``).  ``--prefork`` forks the workers from
a zygote that imported torch once (``agent/zygote.py``),
``--network_check`` checks the node's cards before each rendezvous
(``agent/node_check.py``), ``--no_restart_overlap`` makes a restarted
worker restore serially (``trainer/restart_path.py``), and the agent
watches the cloud metadata server for a maintenance event
(``agent/preemption.py``).

Reference parity: ``dlrover/trainer/torch/elastic_run.py`` —
``parse_args:125``, auto-launch of a local master on the rank-0 node
``:245``, reachability check + standalone fallback ``:335``, ``run:351``
and ``main:399``.

Usage::

    python -m dlrover_tpu_torch.run --nnodes=1 --nproc_per_node=1 \
        [--prefork] [--network_check] [--max-restarts=3] train.py --flag ...

The launcher starts (on node rank 0, when no master address is set) a
local job master subprocess, then runs the per-node
``ElasticTrainingAgent`` which spawns/monitors ``nproc_per_node``
training processes wired up for ``torch.distributed``
(``trainer/elastic/context.py``).
"""

import argparse
import os
import re
import subprocess
import sys
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.agent.training import (
    ElasticLaunchConfig,
    launch_agent,
)
from dlrover_tpu_torch.common.comm import addr_connectable, wait_channel_ready
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.env import control_longpoll_enabled, get_free_port
from dlrover_tpu_torch.common.log import default_logger as logger


def parse_nnodes(value: str) -> Tuple[int, int]:
    if ":" in value:
        lo, hi = value.split(":", 1)
        return int(lo), int(hi)
    n = int(value)
    return n, n


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="dlrover_tpu_torch.run", description="elastic training launcher"
    )
    parser.add_argument(
        "--nnodes", default="1", help="N or MIN:MAX node range"
    )
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument(
        "--master_addr",
        default="",
        help="job master host:port; empty = auto (env, then local spawn)",
    )
    parser.add_argument("--node_rank", type=int, default=-1)
    parser.add_argument("--max_restarts", "--max-restarts",
                        dest="max_restarts", type=int, default=3)
    parser.add_argument("--node_unit", type=int, default=1)
    parser.add_argument("--rdzv_timeout", type=int, default=600)
    parser.add_argument(
        "--rdzv_waiting_timeout", type=float, default=-1.0,
        help="master window rule: seconds after the last join before "
        "an under-max round completes with what it has (<0 = "
        "rdzv_timeout); shorten for fast elastic re-mesh after a "
        "preemption without shrinking the join wait",
    )
    parser.add_argument("--monitor_interval", type=float, default=3.0)
    parser.add_argument(
        "--stop_timeout", type=float, default=15.0,
        help="SIGTERM->SIGKILL grace when stopping workers; workers "
        "blocked in collectives always eat the full grace, so this "
        "bounds restart latency",
    )
    parser.add_argument(
        "--failure_stop_timeout", type=float, default=1.0,
        help="shorter grace used when restarting after a worker "
        "FAILURE (the group is already broken; survivors are wedged "
        "in collectives and the shm ckpt is flushed agent-side)",
    )
    parser.add_argument(
        "--prefork",
        action="store_true",
        help="fork restarted workers from a pre-imported zygote "
        "(removes import torch and torch._dynamo from restart latency)",
    )
    parser.add_argument(
        "--no_restart_overlap",
        action="store_true",
        help="disable the overlapped restart critical path (the restore "
        "prefetch beside the state build; trainer/restart_path.py) — "
        "workers then restore serially (exports "
        "DLROVER_TPU_RESTART_OVERLAP=0)",
    )
    parser.add_argument(
        "--network-check",
        "--network_check",
        dest="network_check",
        action="store_true",
        help="run a health check of the node's cards (matmul and "
        "all-reduce) before each rendezvous",
    )
    parser.add_argument(
        "--standalone",
        action="store_true",
        help="single-node without any master (plain spawn)",
    )
    parser.add_argument(
        "--compile_cache_dir",
        default=os.getenv(NodeEnv.KERNEL_BUILD_DIR, ""),
        help="the kernels' build directory every incarnation loads "
        "from (DLROVER_TPU_TORCH_BUILD_DIR)",
    )
    parser.add_argument(
        "--events_file",
        default=os.getenv("DLROVER_TPU_EVENTS_FILE", ""),
        help="node-local JSONL timeline every process appends to "
        "(spans: step/compile/rendezvous/checkpoint/restart...); the "
        "agent ships it to the master's goodput ledger",
    )
    # torchrun-style: with -m/--module the positional IS the module
    # name; the required positional keeps REMAINDER working for
    # option-like script/module args, and a "-m" token after the
    # script stays in REMAINDER (belongs to the script).
    parser.add_argument(
        "-m",
        "--module",
        dest="module",
        action="store_true",
        help="treat the entrypoint as 'python -m MODULE'",
    )
    parser.add_argument(
        "training_script", help="training script path (or module with -m)"
    )
    parser.add_argument(
        "training_script_args", nargs=argparse.REMAINDER
    )
    return parser.parse_args(argv)


def _launch_local_master(node_num: int) -> Tuple[subprocess.Popen, str]:
    """Spawn ``python -m dlrover_tpu_torch.master.main`` and parse its address
    line (reference ``_launch_dlrover_local_master`` ``elastic_run.py:245``)."""
    port = get_free_port()
    proc = subprocess.Popen(  # noqa: S603
        [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.master.main",
            "--platform",
            "local",
            "--port",
            str(port),
            "--node_num",
            str(node_num),
        ],
        stdout=subprocess.PIPE,
        stderr=None,
        text=True,
    )
    addr = f"127.0.0.1:{port}"
    deadline = time.time() + 30
    # trailing whitespace required: a 4096-byte read chunk can split
    # the line mid-address and \S+ would happily capture the prefix
    # (e.g. '127.0' instead of '127.0.0.1:8080')
    pattern = re.compile(rb"DLROVER_TPU_MASTER_ADDR=(\S+)\s")
    # non-blocking reads on the RAW fd: a live master that never prints
    # the address line must not hang the launcher past the deadline
    # (the pre-computed 127.0.0.1:port stays the fallback).  select on
    # the raw fd + os.read avoids both TextIOWrapper buffering (a line
    # already buffered would never wake select) and readline blocking
    # on a partial line.
    import select as _select

    fd = proc.stdout.fileno()
    buf = b""
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError("local master exited during startup")
        readable, _, _ = _select.select([fd], [], [], 0.5)
        if not readable:
            continue
        chunk = os.read(fd, 4096)
        if not chunk:
            # EOF: stdout closed without the address line; select would
            # report the fd readable forever — fall back to the
            # precomputed address instead of hot-spinning
            break
        buf += chunk
        m = pattern.search(buf)
        if m:
            addr = m.group(1).decode()
            break
    # stop consuming stdout; master logs go to stderr
    return proc, addr


def _wait_master(addr: str, timeout: float = 60.0) -> bool:
    """Wait for the master's gRPC port to come up.  Default: park on
    grpc's channel-ready future (its own reconnect backoff drives the
    probing); ``DLROVER_TPU_CONTROL_LONGPOLL=0`` restores the 0.5 s
    TCP-connect polling loop."""
    if control_longpoll_enabled():
        return wait_channel_ready(addr, timeout=timeout)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if addr_connectable(addr):
            return True
        time.sleep(0.5)
    return False


def _build_entrypoint(args) -> List[str]:
    script_args = list(args.training_script_args)
    if args.module:
        return [
            sys.executable, "-m", args.training_script, *script_args
        ]
    return [sys.executable, args.training_script, *script_args]


def run(args) -> int:
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    node_rank = args.node_rank
    if node_rank < 0:
        node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))

    entrypoint = _build_entrypoint(args)

    if args.events_file:
        # exported BEFORE any spawn so the master, the agent, and every
        # training process append to the same node-local timeline
        os.environ["DLROVER_TPU_EVENTS_FILE"] = os.path.abspath(
            args.events_file
        )

    if args.standalone:
        # no master / agent: spawn procs directly with local coordinator
        return _run_standalone(args, entrypoint)

    master_addr = args.master_addr or os.getenv(NodeEnv.MASTER_ADDR, "")
    master_proc: Optional[subprocess.Popen] = None
    if not master_addr:
        if node_rank != 0:
            raise SystemExit(
                "no master address: set --master_addr or "
                f"${NodeEnv.MASTER_ADDR} on non-zero node ranks"
            )
        master_proc, master_addr = _launch_local_master(max_nodes)
        logger.info("launched local master at %s", master_addr)
    if not _wait_master(master_addr):
        raise SystemExit(f"master at {master_addr} is unreachable")

    os.environ[NodeEnv.MASTER_ADDR] = master_addr
    os.environ[NodeEnv.NODE_RANK] = str(node_rank)

    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node,
        rdzv_timeout=args.rdzv_timeout,
        rdzv_waiting_timeout=args.rdzv_waiting_timeout,
        node_unit=args.node_unit,
        network_check=args.network_check,
        max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        stop_timeout=args.stop_timeout,
        failure_stop_timeout=args.failure_stop_timeout,
        prefork=args.prefork,
        restart_overlap=not args.no_restart_overlap,
        node_rank=node_rank,
        compile_cache_dir=args.compile_cache_dir,
    )
    from dlrover_tpu_torch.observability.events import get_event_logger

    events = get_event_logger()
    events.instant(
        "job_start",
        nnodes=args.nnodes,
        nproc_per_node=args.nproc_per_node,
        node_rank=node_rank,
    )
    rc = 1
    try:
        rc = launch_agent(config, entrypoint, master_addr)
        return rc
    finally:
        events.instant("job_end", exit_code=rc)
        if master_proc is not None and master_proc.poll() is None:
            master_proc.terminate()
            try:
                master_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                master_proc.kill()


def _run_standalone(args, entrypoint: List[str]) -> int:
    """Plain local spawn without elasticity (reference falls back to
    vanilla torchrun — ``elastic_run.py:335``)."""
    nproc = args.nproc_per_node
    coord = f"127.0.0.1:{get_free_port()}"
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(
            {
                NodeEnv.PROCESS_RANK: str(rank),
                NodeEnv.PROCESS_COUNT: str(nproc),
                NodeEnv.LOCAL_RANK: str(rank),
                NodeEnv.LOCAL_PROCESS_COUNT: str(nproc),
                NodeEnv.COORDINATOR_ADDR: coord,
            }
        )
        procs.append(subprocess.Popen(entrypoint, env=env))  # noqa: S603
    rc = 0
    for proc in procs:
        rc = proc.wait() or rc
    return rc


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
