"""The port's worker zygote (``agent/zygote.py``) on the CPU.

- Children forked through the port's ``ZygotePool`` with its default
  preload find torch, ``torch._dynamo`` and the port's worker modules
  imported, CUDA not initialised, ``DLROVER_TPU_SPAWN=zygote``, their
  own environment, and ``OMP_NUM_THREADS`` re-applied.
- Exit codes, signal deaths (-9), exit records and ``poll`` / ``wait`` /
  ``kill`` equal the JAX ``ZygotePool``'s for the same children, both
  with an empty preload.
- A preload that initialises CUDA is refused (simulated: no card here),
  and so is a child that finds CUDA initialised; a spawn env that
  changes what the zygote read at import is a logged plain spawn.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import textwrap
import time
import uuid
from pathlib import Path

import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from dlrover_tpu.agent import zygote as jz  # noqa: E402
from dlrover_tpu_torch.agent import zygote as tz  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _sockets(monkeypatch):
    d = tempfile.mkdtemp(prefix="dzy", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d + "/t")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", d + "/j")
    os.makedirs(d + "/t")
    os.makedirs(d + "/j")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


@pytest.fixture
def pools():
    made = []

    def make(mod, preload):
        pool = mod.ZygotePool(name=f"z{uuid.uuid4().hex[:8]}",
                              preload=preload, start_timeout=120)
        assert pool.start(env=_env(), wait=True)
        made.append(pool)
        return pool

    yield make
    for pool in made:
        pool.close()


def test_forked_children_find_torch_and_no_cuda(tmp_path, pools):
    out = tmp_path / "child.json"
    script = _script(tmp_path, "child.py", f"""
        import json, os, sys
        mods = sorted(m for m in ("torch", "torch._dynamo", "numpy",
                                  "dlrover_tpu_torch.accelerate",
                                  "dlrover_tpu_torch.models.llama",
                                  "dlrover_tpu_torch.optimizers",
                                  "dlrover_tpu_torch.trainer.elastic")
                      if m in sys.modules)
        import torch
        with open({str(out)!r}, "w") as f:
            json.dump({{"preloaded": mods,
                       "cuda": torch.cuda.is_initialized(),
                       "bad_fork": torch.cuda._is_in_bad_fork(),
                       "spawn": os.environ.get("DLROVER_TPU_SPAWN"),
                       "mine": os.environ.get("CHILD_ONLY"),
                       "threads": torch.get_num_threads(),
                       "ppid": os.getppid()}}, f)
        """)
    pool = pools(tz, tz.DEFAULT_PRELOAD)
    handle = pool.spawn([sys.executable, script],
                        _env(CHILD_ONLY="yes", OMP_NUM_THREADS="3"))
    assert isinstance(handle, tz.ZygoteHandle)
    assert handle.wait(timeout=60) == 0
    got = json.loads(out.read_text())
    assert got["preloaded"] == sorted(tz.DEFAULT_PRELOAD)
    assert got["cuda"] is False and got["bad_fork"] is False
    assert got["spawn"] == "zygote" and got["mine"] == "yes"
    assert got["threads"] == 3  # the zygote imported torch with 1
    assert got["ppid"] == pool._proc.pid


_CHILDREN = {
    "ok": "import sys\nsys.exit(0)\n",
    "three": "raise SystemExit(3)\n",
    "crash": "raise ValueError('boom')\n",
    "sigkill": "import os, signal\nos.kill(os.getpid(), signal.SIGKILL)\n",
    "sleeper": "import time\ntime.sleep(60)\n",
}


def _lifecycle(mod, pool, scripts):
    """What the agent sees of each child through ``pool``."""
    out = {}
    handles = {name: pool.spawn([sys.executable, path], _env())
               for name, path in scripts.items()}
    sleeper = handles.pop("sleeper")
    with pytest.raises(subprocess.TimeoutExpired):
        sleeper.wait(timeout=0.3)
    out["sleeper_poll"] = sleeper.poll()
    sleeper.kill()
    out["sleeper"] = sleeper.wait(timeout=30)
    for name, h in sorted(handles.items()):
        rc = h.wait(timeout=60)
        out[name] = (rc, h.poll(), mod.read_exit_record(pool.exit_dir,
                                                        h.pid))
    out["kinds"] = sorted({type(h).__name__ for h in handles.values()})
    return out


def test_exit_codes_and_records_equal_the_jax_pool(tmp_path, pools):
    scripts = {name: _script(tmp_path, f"{name}.py", body)
               for name, body in _CHILDREN.items()}
    got = _lifecycle(tz, pools(tz, ()), scripts)
    want = _lifecycle(jz, pools(jz, ()), scripts)
    assert got == want
    assert got["three"] == (3, 3, 3) and got["crash"] == (1, 1, 1)
    assert got["sigkill"] == (-9, -9, None)  # a signal death writes none
    assert got["sleeper"] == -signal.SIGKILL and got["sleeper_poll"] is None
    assert got["kinds"] == ["ZygoteHandle"]
    assert tz.ZygotePool.ORPHAN_EXIT == jz.ZygotePool.ORPHAN_EXIT


def test_an_orphaned_child_reads_its_exit_record(tmp_path, pools):
    script = _script(tmp_path, "slow.py",
                     "import time\ntime.sleep(1.5)\nraise SystemExit(4)\n")
    pool = pools(tz, ())
    handle = pool.spawn([sys.executable, script], _env())
    pool._proc.kill()  # the zygote dies; its child runs on
    pool._proc.wait()
    deadline = time.time() + 30
    while handle.poll() is None and time.time() < deadline:
        time.sleep(0.05)
    assert handle.poll() == 4


# ------------------------------------------------------------- refusals


def test_a_preload_that_initialises_cuda_is_refused(monkeypatch, tmp_path):
    """No card here: the preload module marks torch's CUDA state as
    initialised, as a real ``torch.cuda.init()`` would."""
    (tmp_path / "cuda_preload.py").write_text(
        "import torch\ntorch.cuda._initialized = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "_initialized",
                        torch.cuda._initialized)
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        tz.ZygoteServer(f"z{uuid.uuid4().hex[:8]}", ["cuda_preload"])
    # as the agent starts it: the zygote exits, and spawns are plain
    pool = tz.ZygotePool(name=f"z{uuid.uuid4().hex[:8]}",
                         preload=("cuda_preload",), start_timeout=60)
    env = _env(PYTHONPATH=f"{REPO}{os.pathsep}{tmp_path}")
    assert not pool.start(env=env, wait=True)
    script = _script(tmp_path, "ok.py", "raise SystemExit(0)\n")
    handle = pool.spawn([sys.executable, script], env)
    assert isinstance(handle, subprocess.Popen)
    assert handle.wait(timeout=60) == 0
    pool.close()


def test_a_child_that_finds_cuda_initialised_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA was initialised"):
        tz._fixup_torch({})


def test_an_import_time_env_change_is_a_plain_spawn(tmp_path, pools,
                                                    monkeypatch):
    out = tmp_path / "spawn.txt"
    script = _script(tmp_path, "who.py", f"""
        import os
        with open({str(out)!r}, "w") as f:
            f.write(os.environ["DLROVER_TPU_SPAWN"])
        """)
    pool = pools(tz, ())
    warned = []
    monkeypatch.setattr(tz.logger, "warning",
                        lambda fmt, *a: warned.append(fmt % a))
    assert tz.import_time_env_diff(
        {"TORCHINDUCTOR_X": "1", "OTHER": "a"},
        {"TORCHINDUCTOR_X": "2", "OTHER": "b", "TORCH_LOGS": "+dynamo"},
    ) == ["TORCHINDUCTOR_X", "TORCH_LOGS"]
    handle = pool.spawn([sys.executable, script],
                        _env(TORCHDYNAMO_VERBOSE="1"))
    assert isinstance(handle, subprocess.Popen)
    assert handle.wait(timeout=60) == 0
    assert out.read_text() == "plain"
    assert len(warned) == 1 and "TORCHDYNAMO_VERBOSE" in warned[0]
