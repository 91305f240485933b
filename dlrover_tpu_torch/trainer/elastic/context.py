"""Training-process bootstrap: ``torch.distributed`` from the agent's env.

Port of ``dlrover_tpu/trainer/elastic/context.py``.  The agent exports
``DLROVER_TPU_COORDINATOR_ADDR`` / ``PROCESS_RANK`` / ``PROCESS_COUNT``
(``dlrover_tpu_torch.agent.training._worker_env``) and
:func:`init_distributed` hands them to
``torch.distributed.init_process_group`` (``init_method="tcp://<addr>"``):
NCCL when the process's device is CUDA, gloo on the CPU.  Beside an
NCCL world it makes a gloo group of the same ranks (``host_group``), so
that a barrier of the host loops never waits on the card's stream.  At
world 1 it makes no group, as the JAX version makes no
``jax.distributed`` world.
The device is ``cuda:<local_rank>`` unless the caller passes
``device="cpu"``; without a card and without an explicit CPU it raises.

The JAX version's coordination-service helpers
(``coordination_client``, ``control_plane_barrier``) have no counterpart:
the restart overlap needs none (``trainer/restart_path.py``), and a
barrier of the host loops is ``torch.distributed.barrier`` on
``host_group``.
"""

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import torch

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger


def process_rank() -> int:
    return int(os.getenv(NodeEnv.PROCESS_RANK, "0"))


def process_count() -> int:
    return int(os.getenv(NodeEnv.PROCESS_COUNT, "1"))


def local_rank() -> int:
    return int(os.getenv(NodeEnv.LOCAL_RANK, "0"))


def node_rank() -> int:
    return int(os.getenv(NodeEnv.NODE_RANK, "0"))


def restart_count() -> int:
    return int(os.getenv("DLROVER_TPU_RESTART_COUNT", "0"))


@dataclass
class ElasticContext:
    rank: int
    world_size: int
    local_rank: int
    node_rank: int
    restart_count: int
    coordinator_addr: str
    master_addr: str
    device: torch.device
    # a group whose collectives run on the host (gloo): the NCCL world's
    # gloo twin, or None where the default group is gloo or absent
    host_group: Optional[object] = None


_context: Optional[ElasticContext] = None


def init_distributed(device: DeviceLike = None) -> ElasticContext:
    """Join the agent-provided world on ``device`` (default
    ``cuda:<local_rank>``).

    Safe to call when launched standalone (single process, no
    coordinator): it becomes a world of size 1 with no process group.
    A second call returns the same world; at world 1 it may name another
    device (the context then carries that one).
    """
    global _context
    lrank = local_rank()
    if device is None or torch.device(device).type == "cuda":
        dev = resolve_device(
            torch.device("cuda", lrank) if device is None else device)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    if _context is not None:
        if _context.device != dev:
            if _context.world_size > 1:
                raise ValueError(
                    f"this process joined its world on {_context.device}, "
                    f"not {dev}")
            _context = dataclasses.replace(_context, device=dev)
        return _context
    rank = process_rank()
    world = process_count()
    coord = os.getenv(NodeEnv.COORDINATOR_ADDR, "")
    host_group = None
    if world > 1:
        if not coord:
            raise RuntimeError(
                f"world {world} without {NodeEnv.COORDINATOR_ADDR}: "
                "launch through python -m dlrover_tpu_torch.run")
        import torch.distributed as dist

        from dlrover_tpu_torch.observability.events import get_event_logger

        backend = "nccl" if dev.type == "cuda" else "gloo"
        # trainer-side rendezvous: connecting to the coordinator and
        # assembling the world is restart overhead the goodput ledger
        # must see
        with get_event_logger().span("rendezvous"):
            dist.init_process_group(
                backend=backend,
                init_method=f"tcp://{coord}",
                world_size=world,
                rank=rank,
            )
            if backend == "nccl":
                host_group = dist.new_group(backend="gloo")
        logger.info(
            "torch.distributed (%s%s) initialized: rank %d/%d via %s",
            backend, ", gloo host group" if host_group else "", rank,
            world, coord,
        )
    _context = ElasticContext(
        rank=rank,
        world_size=world,
        local_rank=lrank,
        node_rank=node_rank(),
        restart_count=restart_count(),
        coordinator_addr=coord,
        master_addr=os.getenv(NodeEnv.MASTER_ADDR, ""),
        device=dev,
        host_group=host_group,
    )
    return _context


def get_context() -> Optional[ElasticContext]:
    return _context


def shutdown_distributed():
    """Destroy the process group :func:`init_distributed` made, if any,
    and forget the context."""
    global _context
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _context = None
