"""A drained world grows back, on two gloo nodes.

``scripts/torch_brain_nccl.py``'s grow run at the CPU model: a
``DistributedJobMaster`` in this process with an ``ElasticJobScaler``
and an ``ElasticJobController`` over one fake k8s client whose worker
pods are launchers.  Node 1 is slowed, the Brain drains it and, once
node 0 has re-meshed into a world of 1, a ScalePlan brings its
replacement (node 2): node 0's worlds are 2, 1, 2, the two replicas
agree by digest at every step after the grow, and two nodes resumed from
a copy of the checkpoint the grow restored run those steps bit for bit
(the script's ``check_grow``; it raises ``SystemExit`` on a failed
check).
"""

import importlib.util
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _brain_script():
    spec = importlib.util.spec_from_file_location(
        "torch_brain_nccl", REPO / "scripts" / "torch_brain_nccl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_gloo_nodes_a_drained_world_grows_back(tmp_path):
    script = _brain_script()
    args = types.SimpleNamespace(device="cpu", steps=11, step_sleep=0.3,
                                 slow_from=6, slow_factor=6.0,
                                 timeout=300.0, slow_rank=1)
    logs = tmp_path / "logs"
    logs.mkdir()
    r = script.run_grow(tmp_path / "runs", logs, script.CPU_MODEL, args)
    readings = script.check_grow(r, tmp_path / "runs", logs,
                                 script.CPU_MODEL, args, "cpu (gloo)")
    d = readings["decision"]
    assert (d["action"], d["target_node"]) == ("drain_replace", 1)
    assert (d["from_world"], d["to_world"]) == (2, 2)
    assert readings["worlds"][0] == 2 and readings["worlds"][-1] == 2
    assert 1 in readings["worlds"]
    assert readings["restored_step"] >= args.slow_from
    assert readings["digested_steps"][-1] == args.steps
