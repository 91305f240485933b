"""The port stands alone and runs on the card unless told otherwise.

- Importing every module of ``dlrover_tpu_torch`` pulls in neither
  ``jax`` nor ``dlrover_tpu`` (checked in a fresh interpreter, and by a
  scan of every import statement of the package and ``chip_smoke.py``).
- With no CUDA, the entry points raise unless ``device="cpu"`` is given.
- ``ops/_build.py`` imports without ``nvcc``, and building without one
  fails with a clear error rather than at import.
- ``chip_smoke.py`` alone, or without a card, exits nonzero and prints
  no result.
"""

import ast
import ctypes
import json
import os
import pkgutil
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import dlrover_tpu_torch
from dlrover_tpu_torch.common import device as device_mod
from dlrover_tpu_torch.common import env
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.convert import params_from_jax
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.rl import kv_cache, scheduler

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dlrover_tpu_torch"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            dlrover_tpu_torch.__path__, "dlrover_tpu_torch.")
    )


def _foreign(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "dlrover_tpu")


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "dlrover_tpu_torch.rl.scheduler" in mods and len(mods) >= 60
    for m in ("ops.flash_attention", "ops.quantization", "optimizers.agd",
              "optimizers.low_bit",
              "parallel.train_step", "accelerate.api", "trainer.trainer",
              "examples.llama_pretrain", "agent.ckpt_shm",
              "agent.ckpt_saver", "common.multi_process",
              "common.parallel_io", "common.storage",
              "common.fault_injection", "observability.events",
              "observability.metrics", "trainer.checkpoint.engine",
              "trainer.checkpoint.reshard",
              "trainer.checkpoint.checkpointer",
              "trainer.checkpoint.dcp_interop",
              # the elastic launch
              "run", "common.comm", "common.messages", "common.node",
              "common.global_context", "common.singleton",
              "common.constants", "common.env", "master.master",
              "master.main", "master.servicer", "master.rendezvous",
              "master.net_topology", "master.kv_store",
              "master.job_manager", "master.status_flow",
              "master.error_monitor", "master.node_managers",
              "master.speed_monitor", "master.shard.task_manager",
              "master.shard.dataset_manager",
              "master.shard.dataset_splitter", "agent.master_client",
              "agent.training", "agent.monitor", "trainer.elastic_run",
              "trainer.drain", "trainer.fault_tolerance",
              "trainer.elastic.context", "trainer.elastic.trainer",
              # the worker's restart path and the agent's services
              "trainer.restart_path", "agent.zygote", "agent.node_check",
              "agent.preemption", "agent.replica", "common.netio",
              # the data plane, and data-parallel and FSDP training
              "data.prefetch", "data.shm_dataloader",
              "data.elastic_dataloader", "data.coworker",
              "trainer.elastic.sampler", "trainer.sharding",
              "parallel.mesh", "parallel.sharding", "parallel.collectives",
              "accelerate.analyser", "accelerate.strategy",
              "accelerate.solver",
              # the durable, observed master
              "master.datastore", "master.failover", "master.stats",
              "master.diagnosis", "observability.health",
              "observability.self_telemetry",
              "observability.status_server", "observability.attribution",
              "agent.diagnosis_collector",
              # the Brain, replay and callbacks
              "master.resource_optimizer", "master.scaler", "master.brain",
              "master.auto_scaler", "scheduler.kubernetes",
              "trainer.replay", "trainer.callbacks"):
        assert f"dlrover_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _foreign(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_scan_finds_no_foreign_import():
    files = (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("torch_*.py")))
    assert len(files) >= 60
    for sub in ("master", "agent", "common", "trainer"):
        assert any(f.parent.name == sub or sub in f.parent.parts
                   for f in files)
    assert PKG / "run.py" in files
    bad = [(str(f.relative_to(REPO)), name)
           for f in files for name in _imports(f) if _foreign(name)]
    assert bad == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_needs_cuda_or_an_explicit_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device("cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device_mod.resolve_device("meta")


def test_entry_points_raise_without_cuda_unless_given_cpu(no_cuda):
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler.ContinuousBatchingScheduler(cfg)
    pcfg = kv_cache.PagedCacheConfig(2, 2, 16, 8, 4, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv_cache.init_block_pool(pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [1.0]})
    # the same calls with an explicit CPU
    params = llama.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    sch = scheduler.ContinuousBatchingScheduler(cfg, device="cpu")
    assert sch.stats()["device"] == "cpu"
    assert kv_cache.init_block_pool(pcfg, "cpu")["k"].shape == (
        2, 8, 4, 2, 16)


def test_build_module_imports_and_fails_cleanly_without_nvcc(
    monkeypatch, tmp_path
):
    proc = subprocess.run(
        [sys.executable, "-c",
         "import dlrover_tpu_torch.ops._build as b; print(b.SOURCES)"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env={"PATH": "", "PYTHONPATH": str(REPO),
             "HOME": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["rms_norm"])
    assert "rms_norm" not in _build._libs


def test_build_target_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    a = _build._target("rms_norm", verbose=False)
    b = _build._target("paged_attention", verbose=False)
    c = _build._target("rms_norm", verbose=True)
    assert a.parent == tmp_path and a.suffix == ".so"
    assert len({a, b, c}) == 3
    assert a == _build._target("rms_norm", verbose=False)
    default = REPO / "build" / "dlrover_tpu_torch"
    monkeypatch.delenv(_build.BUILD_DIR_ENV)
    assert _build.build_dir() == default
    assert (REPO / ".gitignore").read_text().splitlines().count(
        "build/") == 1


def test_build_target_changes_when_a_header_changes(monkeypatch, tmp_path):
    """The sources include ``hopper.cuh``: an edit to a header must
    rebuild every library, not reuse one built from the old header."""
    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "ops" / "csrc", csrc)
    assert (csrc / "hopper.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "build"))
    before = {n: _build._target(n, verbose=False) for n in _build.SOURCES}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._target(n, verbose=False) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert after == {n: _build._target(n, verbose=False)
                     for n in _build.SOURCES}


_CTYPE = {"const void*": "c_void_p", "void*": "c_void_p",
          "int": "c_int", "float": "c_float",
          "int64_t": ctypes.c_int64.__name__}


def _c_signature(source: str, fn: str):
    text = (PKG / "ops" / "csrc" / f"{source}.cu").read_text()
    start = text.index(f"int {fn}(") + len(f"int {fn}(")
    params = text[start:text.index(")", start)].split(",")
    return [_CTYPE[" ".join(p.split()[:-1])] for p in params]


@pytest.mark.parametrize("source,fn,module,attr", [
    ("rms_norm", "dl_rms_norm_fwd", "dlrover_tpu_torch.ops.fused",
     "ARGTYPES"),
    ("rms_norm", "dl_add_rms_norm_fwd", "dlrover_tpu_torch.ops.fused",
     "ADD_ARGTYPES"),
    ("rms_norm", "dl_rms_norm_bwd", "dlrover_tpu_torch.ops.fused",
     "BWD_ARGTYPES"),
    ("paged_attention", "dl_paged_decode",
     "dlrover_tpu_torch.ops.paged_kernels", "DECODE_ARGTYPES"),
    ("paged_attention", "dl_paged_decode_smem",
     "dlrover_tpu_torch.ops.paged_kernels", "DECODE_SMEM_ARGTYPES"),
    ("paged_attention", "dl_paged_verify",
     "dlrover_tpu_torch.ops.paged_kernels", "VERIFY_ARGTYPES"),
    ("paged_attention", "dl_paged_verify_smem",
     "dlrover_tpu_torch.ops.paged_kernels", "VERIFY_SMEM_ARGTYPES"),
    ("flash_attention", "dl_flash_fwd",
     "dlrover_tpu_torch.ops.flash_attention", "FWD_ARGTYPES"),
    ("flash_attention", "dl_flash_fwd_smem",
     "dlrover_tpu_torch.ops.flash_attention", "FWD_SMEM_ARGTYPES"),
    ("flash_attention_bwd", "dl_flash_bwd_dkv",
     "dlrover_tpu_torch.ops.flash_attention", "DKV_ARGTYPES"),
    ("flash_attention_bwd", "dl_flash_bwd_dq",
     "dlrover_tpu_torch.ops.flash_attention", "DQ_ARGTYPES"),
    ("flash_attention_bwd", "dl_flash_bwd_smem",
     "dlrover_tpu_torch.ops.flash_attention", "SMEM_ARGTYPES"),
    ("quantization", "dl_quantize",
     "dlrover_tpu_torch.ops.quantization", "QUANT_ARGTYPES"),
    ("quantization", "dl_dequantize",
     "dlrover_tpu_torch.ops.quantization", "DEQUANT_ARGTYPES"),
    ("quantization", "dl_int8_adam",
     "dlrover_tpu_torch.ops.quantization", "ADAM_ARGTYPES"),
])
def test_ctypes_argtypes_match_the_c_entry(source, fn, module, attr):
    """The wrapper's ctypes signature is the C entry's, argument by
    argument (a pointer passed as a 32-bit int would be cut)."""
    import importlib

    argtypes = getattr(importlib.import_module(module), attr)
    assert [t.__name__ for t in argtypes] == _c_signature(source, fn)


@pytest.mark.parametrize("fn", ["dl_flash_bwd_dkv", "dl_flash_bwd_dq"])
def test_flash_backward_entries_live_in_their_own_source(fn):
    """The backward kernels build from ``flash_attention_bwd.cu`` (one
    ``nvcc`` beside the forward's), which declares each entry once; no
    other source declares it, so no older body can be loaded instead."""
    assert "flash_attention_bwd" in _build.SOURCES
    decl = f"int {fn}("
    where = {p.stem: p.read_text().count(decl)
             for p in (PKG / "ops" / "csrc").glob("*.cu")}
    assert where.pop("flash_attention_bwd") == 1
    assert set(where.values()) == {0}


@pytest.mark.parametrize("fn,source", [
    ("dl_flash_fwd", "flash_attention"),
    ("dl_flash_fwd_smem", "flash_attention"),
    ("dl_flash_bwd_dkv", "flash_attention_bwd"),
    ("dl_flash_bwd_dq", "flash_attention_bwd"),
    ("dl_flash_bwd_smem", "flash_attention_bwd"),
])
def test_each_flash_entry_is_declared_in_one_source(fn, source):
    """Both flash sources include ``hopper.cuh``; each C entry is
    declared in exactly one source (and in no header), so no other body
    can be loaded under its name."""
    decl = f"int {fn}("
    csrc = PKG / "ops" / "csrc"
    where = {p.name: p.read_text().count(decl)
             for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))}
    assert where.pop(f"{source}.cu") == 1
    assert set(where.values()) == {0}


def test_paged_decode_is_the_split_kv_entry_and_the_first_design_is_gone():
    """B5 runs through ``dl_paged_decode``, declared once, in
    ``paged_attention.cu`` only; the first design's entry
    ``dl_paged_attention`` (and its decode flag) is named nowhere in the
    port, its wrappers or ``chip_smoke.py``, so no path can reach it."""
    csrc = PKG / "ops" / "csrc"
    where = {p.name: p.read_text().count("int dl_paged_decode(")
             for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))}
    assert where.pop("paged_attention.cu") == 1
    assert set(where.values()) == {0}
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(PKG.parent / "chip_smoke.py")
    for p in files:
        assert "dl_paged_attention" not in p.read_text(), p.name
    kernels = (csrc / "paged_attention.cu").read_text()
    for needle in ("decode_split<", "merge_splits<", "cp.async.cg.shared",
                   "stage_rows<"):
        assert needle in kernels, needle


def _entry_body(source: str, fn: str) -> str:
    text = (PKG / "ops" / "csrc" / f"{source}.cu").read_text()
    start = text.index(f"int {fn}(")
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("source,fn", [
    ("flash_attention", "dl_flash_fwd"),
    ("flash_attention", "dl_flash_fwd_smem"),
    ("flash_attention_bwd", "dl_flash_bwd_dkv"),
    ("flash_attention_bwd", "dl_flash_bwd_dq"),
    ("flash_attention_bwd", "dl_flash_bwd_smem"),
])
def test_flash_dispatch_names_every_head_dim(source, fn):
    """Each flash entry dispatches D = 16, 32, 64 and 128 (the head dims
    of the reference's presets; ``LlamaConfig.tiny()`` has 16), as the
    wrapper's ``HEAD_DIMS`` says."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    assert fa.HEAD_DIMS == (16, 32, 64, 128)
    body = _entry_body(source, fn)
    for d in fa.HEAD_DIMS:
        assert f"case {d}:" in body, (fn, d)


def _with_headers(source: str) -> str:
    """A source's text followed by that of every local header it
    includes."""
    csrc = PKG / "ops" / "csrc"
    text = (csrc / f"{source}.cu").read_text()
    headers = [line.split('"')[1] for line in text.splitlines()
               if line.startswith('#include "')]
    return "\n".join([text] + [(csrc / h).read_text() for h in headers])


def test_flash_backward_source_is_the_hopper_design():
    """The bf16 backward issues wgmma and loads its tiles by TMA through
    mbarriers (the helpers in ``hopper.cuh``, which it includes); the
    mma.sync bodies of the first design are gone."""
    text = _with_headers("flash_attention_bwd")
    assert '#include "hopper.cuh"' in text
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "cuTensorMapEncodeTiled",
                   "__grid_constant__"):
        assert needle in text, needle
    for p in (PKG / "ops" / "csrc").glob("flash_attention*.cu"):
        body = p.read_text()
        assert "dq_mma" not in body and "dkv_mma" not in body, p.name


def test_flash_forward_source_is_the_hopper_design():
    """The bf16 forward runs on wgmma with its tiles loaded by TMA from
    tensor maps through mbarriers; no mma.sync or ldmatrix is left in
    it, and the shared helpers live only in ``hopper.cuh``."""
    fwd = (PKG / "ops" / "csrc" / "flash_attention.cu").read_text()
    text = _with_headers("flash_attention")
    assert '#include "hopper.cuh"' in fwd
    # the code, without its comments (the design note names the first
    # design's instructions)
    fwd = "\n".join(line.split("//")[0] for line in fwd.splitlines())
    for needle in ("wgmma_ss(", "wgmma_rs(", "tma_tile<D>", "tensor_map(",
                   "mbar_wait(", "__grid_constant__ CUtensorMap",
                   "wgmma.mma_async", "cp.async.bulk.tensor"):
        assert needle in text, needle
    for gone in ("mma.sync", "ldmatrix", "fwd_mma"):
        assert gone not in fwd, gone
    for p in (PKG / "ops" / "csrc").glob("flash_attention*.cu"):
        body = p.read_text()
        for helper in ("asm volatile(\"wgmma.", "mbarrier.try_wait",
                       "cuTensorMapEncodeTiled"):
            assert helper not in body, (p.name, helper)


def test_every_source_is_built_and_every_kernel_counted():
    assert set(_build.SOURCES) == {
        p.stem for p in (PKG / "ops" / "csrc").glob("*.cu")}
    assert set(_build.launches) == {
        "rms_norm", "rms_norm_bwd", "paged_decode", "paged_verify",
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "quantize",
        "dequantize", "int8_adam"}


def test_env_knobs_mirror_the_jax_package(monkeypatch):
    for name in (env.KV_INCREMENTAL_ENV, env.KV_GROW_BLOCKS_ENV,
                 env.KV_ADMIT_WATERMARK_ENV, env.KV_PREFIX_CACHE_ENV,
                 env.DECODE_STEPS_ENV):
        assert name.startswith("DLROVER_TPU_")
        monkeypatch.delenv(name, raising=False)
    assert env.kv_incremental_enabled() and env.kv_prefix_cache_enabled()
    assert env.kv_grow_blocks() == 2 and env.decode_steps() == 1
    assert env.kv_admit_watermark() == 0.1
    monkeypatch.setenv(env.KV_INCREMENTAL_ENV, "off")
    monkeypatch.setenv(env.KV_ADMIT_WATERMARK_ENV, "5")
    monkeypatch.setenv(env.DECODE_STEPS_ENV, "junk")
    monkeypatch.setenv(env.KV_GROW_BLOCKS_ENV, "0")
    assert not env.kv_incremental_enabled()
    assert env.kv_admit_watermark() == 0.9
    assert env.decode_steps() == 1 and env.kv_grow_blocks() == 1


def test_chip_smoke_alone_exits_nonzero_without_a_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_checkpoint_namespace_is_the_ports_own(monkeypatch):
    """A JAX job and a port job on one machine never attach to each
    other's sockets or shm segments; they share the ``.drckpt`` format
    and the checkpoint layout only."""
    from dlrover_tpu.agent import ckpt_shm as jshm
    from dlrover_tpu.common import constants as jconst
    from dlrover_tpu.common import multi_process as jmp
    from dlrover_tpu_torch.agent import ckpt_shm
    from dlrover_tpu_torch.common import constants, multi_process

    for m in (jmp, multi_process):
        monkeypatch.delenv(m.SOCKET_DIR_ENV, raising=False)
    assert multi_process.SOCKET_DIR_ENV != jmp.SOCKET_DIR_ENV
    ours, theirs = multi_process._socket_path("x"), jmp._socket_path("x")
    assert ours == "/tmp/dlrover_tpu_torch/sockets/x.sock"
    assert os.path.dirname(ours) != os.path.dirname(theirs)
    assert ckpt_shm.SHM_PREFIX == "dlrover_tpu_torch_ckpt"
    assert not ckpt_shm.SHM_PREFIX.startswith(jshm.SHM_PREFIX + "_")
    assert ckpt_shm.SharedMemoryHandler.__init__.__defaults__ == (
        jshm.SharedMemoryHandler.__init__.__defaults__)
    for name in ("CKPT_DIR_PREFIX", "STAGE_DIR", "TRACKER_FILE"):
        assert (getattr(constants.CheckpointConstant, name)
                == getattr(jconst.CheckpointConstant, name))
    assert ckpt_shm._HDR.format == jshm._HDR.format


def test_socket_paths_fit_af_unix_whatever_the_temp_dir(monkeypatch):
    """The saver's and the agent's AF_UNIX sockets live in the port's
    socket dir, not under pytest's ``--basetemp`` (xdist's
    ``/tmp/pytest-of-<user>/pytest-NN/popen-gwN/...`` pushed paths past
    107 bytes): the longest name the checkpoint path makes fits in the
    default dir and in the short dirs the tests make."""
    from dlrover_tpu_torch.agent.ckpt_saver import EVENT_QUEUE, FACTORY_QUEUE
    from dlrover_tpu_torch.common import multi_process

    monkeypatch.delenv(multi_process.SOCKET_DIR_ENV, raising=False)
    name = "d" + "f" * 8  # CheckpointEngine's name for a checkpoint dir
    longest = max((f"dict_ckpt_meta_{name}_{1023}",
                   f"queue_{EVENT_QUEUE}_{name}", f"queue_{FACTORY_QUEUE}",
                   f"lock_ckpt_{name}_{1023}"), key=len)
    assert len(multi_process._socket_path(longest)) < 100
    short = tempfile.gettempdir()
    base = short if len(short) <= 40 else "/tmp"
    assert len(os.path.join(base, "dteXXXXXXXX", longest + ".sock")) < 100


def test_a_worker_reuses_the_library_built_with_the_ptxas_report(
        monkeypatch, tmp_path):
    """``chip_smoke.py`` builds with ``-Xptxas -v``, which keys another
    target: a worker the agent starts (no report) must load that
    library, not compile every source again."""
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    assert _build._reusable("rms_norm", verbose=False) is None
    verbose = _build._target("rms_norm", verbose=True)
    verbose.write_bytes(b"")
    assert _build._reusable("rms_norm", verbose=False) == verbose
    plain = _build._target("rms_norm", verbose=False)
    plain.write_bytes(b"")
    assert _build._reusable("rms_norm", verbose=False) == plain
    assert _build._reusable("rms_norm", verbose=True) == verbose
