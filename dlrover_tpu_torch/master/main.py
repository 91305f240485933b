"""Master CLI: ``python -m dlrover_tpu_torch.master.main --port ...
--node-num N``.

Copy of ``dlrover_tpu/master/main.py``.  ``--platform local`` builds the
local master; ``k8s`` and ``ray`` build a ``DistributedJobMaster``, as
the reference does: on k8s with an ``ElasticJobScaler`` (ScalePlan
custom resources for the operator, ``master/controller.py``), on ray
with no scaler (the master only observes).  A k8s master on a machine
without the ``kubernetes`` package raises its ``ImportError``; it never
falls back to the local master.  ``--brain_db`` opens the durable
datastore (journal, replay, fencing) and ``--status_port`` the
``/metrics`` and ``/status`` server, as in the reference.

Reference parity: ``dlrover/python/master/main.py:43-70`` +
``master/args.py``.
"""

import argparse
import sys

from dlrover_tpu_torch.common.log import default_logger as logger


def parse_master_args(argv=None):
    parser = argparse.ArgumentParser(description="dlrover_tpu job master")
    parser.add_argument("--port", type=int, default=0,
                        help="gRPC port (0 = pick a free port)")
    parser.add_argument("--node_num", "--node-num", dest="node_num",
                        type=int, default=1)
    parser.add_argument("--platform", default="local",
                        choices=["local", "k8s", "ray"])
    parser.add_argument("--job_name", default="local-job")
    parser.add_argument("--pending_timeout", type=int, default=900)
    parser.add_argument(
        "--brain_db", default="",
        help="sqlite path for the durable Brain datastore (speed "
        "history, strategy calibration, node events survive master "
        "restarts); also via $DLROVER_TPU_BRAIN_DB",
    )
    parser.add_argument(
        "--workers", type=int, default=0,
        help="gRPC thread-pool size (0 = $DLROVER_TPU_MASTER_WORKERS "
        "or 64).  Each parked long-poll holds one worker for its "
        "whole wait — raise this before a 256+ agent fan-in; the "
        "occupancy gauges say when.",
    )
    parser.add_argument(
        "--status_port", type=int, default=None,
        help="serve plain-HTTP /metrics (Prometheus text) + /status "
        "(observatory JSON snapshot) on this port (0 = pick a free "
        "one; omit = off).  Also via $DLROVER_TPU_STATUS_PORT.",
    )
    return parser.parse_args(argv)


def run(args) -> int:
    import os

    from dlrover_tpu_torch.common.env import get_free_port
    from dlrover_tpu_torch.master.master import (
        DistributedJobMaster,
        LocalJobMaster,
    )

    if args.platform == "k8s":
        # before the environment is touched: without the kubernetes
        # package the master raises its ImportError as it is, and the
        # caller's environment stays as it was
        import kubernetes  # noqa: F401
    if args.brain_db:
        os.environ["DLROVER_TPU_BRAIN_DB"] = args.brain_db
    if args.workers:
        # through the env so the servicer's parked-wait cap, the
        # create_master_service pool and the occupancy gauge all read
        # ONE value
        os.environ["DLROVER_TPU_MASTER_WORKERS"] = str(args.workers)
    if args.status_port is not None:
        os.environ["DLROVER_TPU_STATUS_PORT"] = str(args.status_port)
    os.environ.setdefault("DLROVER_TPU_JOB_NAME", args.job_name)

    port = args.port or get_free_port()
    if args.platform == "local":
        master = LocalJobMaster(port, args.node_num)
    else:
        # platform-appropriate scaler: without one, BOTH the relaunch
        # path and the autoscale cycle are observers only
        if args.platform == "k8s":
            from dlrover_tpu_torch.master.scaler import ElasticJobScaler

            scaler = ElasticJobScaler(args.job_name)
        else:
            # ray masters get their ActorScaler from the ray
            # scheduler layer (needs a live client); no default here
            scaler = None
        master = DistributedJobMaster(
            port,
            args.node_num,
            scaler=scaler,
            pending_timeout=args.pending_timeout,
        )
    master.prepare()
    logger.info("job %s master listening on %s", args.job_name,
                master.addr)
    print(f"DLROVER_TPU_MASTER_ADDR={master.addr}", flush=True)
    if master.status_server is not None:
        # the BOUND port (a requested 0 resolves here)
        print(
            f"DLROVER_TPU_STATUS_PORT={master.status_server.port}",
            flush=True,
        )
    return master.run()


def main(argv=None) -> int:
    return run(parse_master_args(argv))


if __name__ == "__main__":
    sys.exit(main())
