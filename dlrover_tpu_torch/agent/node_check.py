"""Node health-check payload: a matmul on the card and a collective.

Reference parity: ``dlrover/trainer/torch/node_check/nvidia_gpu.py:24-56``
(matmul + 16M-element allreduce timed rounds) and the agent entries
``node_health_check`` / ``comm_perf_check``
(``elastic_agent/torch/training.py:1115,1134``).  Port of
``dlrover_tpu/agent/node_check.py``, which runs the payload under
``pmap`` across a TPU-VM's local chips; here, as upstream does on
NVIDIA cards, one process a local card (``nproc_per_node`` of them,
started by the agent with ``DLROVER_TPU_NODE_CHECK_RANK`` / ``_WORLD`` /
``_ADDR``) times rounds of a 1024 x 1024 matmul on its card and a
16M-element fp32 ``all_reduce`` over the node's processes: NCCL on the
card, gloo on the CPU (``DLROVER_TPU_NODE_CHECK_DEVICE=cpu``; the
default is the card, and without one the check fails).  A plain
``torch.matmul``: no Pallas kernel stands behind the reference's.

The payload runs in a throwaway subprocess (forked from the agent's
zygote under ``--prefork``) so a wedged card cannot hang the agent; the
elapsed time goes back to the master's
``NetworkCheckRendezvousManager``, which shuffles pair groups across two
rounds to isolate the straggler / fault node.
"""

import json
import os
import time

from dlrover_tpu_torch.agent.zygote import SPAWN_ENV
from dlrover_tpu_torch.common.log import default_logger as logger

# the reference's payload scale (matmul K x K, 16M-element allreduce)
_MATMUL_DIM = 1024
_MATMUL_ROUNDS = 3
_ALLREDUCE_ELEMS = 1 << 24

RESULT_FILE_ENV = "DLROVER_TPU_NODE_CHECK_RESULT_FILE"
RANK_ENV = "DLROVER_TPU_NODE_CHECK_RANK"
WORLD_ENV = "DLROVER_TPU_NODE_CHECK_WORLD"
ADDR_ENV = "DLROVER_TPU_NODE_CHECK_ADDR"
DEVICE_ENV = "DLROVER_TPU_NODE_CHECK_DEVICE"


def mock_error() -> bool:
    """Fault injection switch (reference ``node_check/utils.py:49``)."""
    return os.getenv("DLROVER_TPU_MOCK_NODE_ERROR", "") == "1"


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_health_check(device=None, rank: int = 0, world: int = 1,
                     addr: str = "") -> dict:
    """Run the compute + collective payload as ``rank`` of ``world``
    processes, in a process group over ``tcp://addr`` (with no address,
    at world 1, the matmul alone).

    Returns ``{"elapsed", "matmul_ms", "allreduce_ms", "device",
    "world"}`` (seconds, and milliseconds per matmul round and for the
    all-reduce after a warm-up); raises on failure (no card, an
    injected fault).  torch is imported here, so the agent process
    itself never touches the card."""
    if mock_error():
        raise RuntimeError("injected node-check failure")

    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.common.device import resolve_device

    dev = resolve_device(device if device is not None else os.getenv(
        DEVICE_ENV) or torch.device("cuda", rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        name = torch.cuda.get_device_name(dev)
    else:
        name = "cpu"
    logger.info("node check: rank %d of %d on %s (%s)", rank, world, dev,
                name)
    start = time.time()
    group = None
    if world > 1 and not addr:
        raise RuntimeError(f"node check: world {world} needs an address")
    if addr:  # the agent's payload: a group even at world 1 (NCCL runs)
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{addr}", world_size=world, rank=rank)
        group = dist.group.WORLD
    try:
        gen = torch.Generator(device=dev).manual_seed(rank)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        x = torch.randn(_MATMUL_DIM, _MATMUL_DIM, generator=gen,
                        device=dev, dtype=dtype) / _MATMUL_DIM ** 0.5
        y = torch.tanh(x @ x)  # warm-up (cuBLAS handle, kernels)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(_MATMUL_ROUNDS):
            y = torch.tanh(y @ x)
        _sync(dev)
        matmul_ms = (time.perf_counter() - t0) * 1e3 / _MATMUL_ROUNDS
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("node check: the matmul is not finite")
        # bandwidth probe: 16M fp32 elements (64 MB), reference
        # ``bm_allreduce`` (node_check/utils.py:88)
        big = torch.ones(_ALLREDUCE_ELEMS, device=dev)
        if group is not None:
            # warm-up (the communicator), on a tensor of its own
            dist.all_reduce(torch.ones(1024, device=dev), group=group)
        _sync(dev)
        t0 = time.perf_counter()
        if group is not None:
            dist.all_reduce(big, group=group)
        _sync(dev)
        allreduce_ms = (time.perf_counter() - t0) * 1e3
        if float(big[0]) != float(world):
            raise RuntimeError(
                f"node check: all_reduce gave {float(big[0])}, "
                f"not {world}")
    finally:
        if group is not None:
            dist.destroy_process_group()
    elapsed = time.time() - start
    result = {"elapsed": elapsed, "matmul_ms": matmul_ms,
              "allreduce_ms": allreduce_ms, "device": name,
              "world": world}
    logger.info(
        "node check passed in %.3fs on %s: matmul %dx%d %.4f ms a round, "
        "all_reduce of %d fp32 over %d process(es) %.4f ms", elapsed,
        name, _MATMUL_DIM, _MATMUL_DIM, matmul_ms, _ALLREDUCE_ELEMS, world,
        allreduce_ms)
    return result


def main() -> int:
    """Subprocess entry: ``python -m dlrover_tpu_torch.agent.node_check``."""
    try:
        result = run_health_check(
            rank=int(os.getenv(RANK_ENV, "0")),
            world=int(os.getenv(WORLD_ENV, "1")),
            addr=os.getenv(ADDR_ENV, ""),
        )
    except Exception as e:  # noqa: BLE001
        logger.error("node check failed: %s", e)
        return 1
    # how the agent started this payload: forked from its zygote, or not
    result["spawn"] = os.getenv(SPAWN_ENV, "plain")
    # elapsed seconds on the first line, as the reference writes it (the
    # agent forwards it to the master: report_network_status), then the
    # timings as JSON
    out = os.getenv(RESULT_FILE_ENV, "")
    if out:
        with open(out, "w") as f:
            f.write(f"{result['elapsed']:.6f}\n{json.dumps(result)}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
