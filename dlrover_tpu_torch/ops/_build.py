"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so <name>.cu

and loaded with ``ctypes`` (pointers and the stream as ``c_void_p``,
ints as ``c_int``).  The sources include no PyTorch header, so a build
takes seconds rather than the minutes of
``torch.utils.cpp_extension.load``.  All sources are compiled in
parallel (one ``nvcc`` each, started together) at first CUDA use.

The output is keyed by a hash of the source, every header in ``csrc/``
(``*.cuh``, which the sources include) and the flags, so an edited
kernel or header is rebuilt and an unchanged one is reused.  The build
directory is ``build/dlrover_tpu_torch/`` at the root of the checkout
(listed in ``.gitignore``), or ``$DLROVER_TPU_TORCH_BUILD_DIR``.

Every C entry returns ``cudaGetLastError()`` after its launch; the
wrapper raises on a nonzero code (:func:`check`).  A failed build and a
failed launch raise :class:`KernelError`, which the dry runner never
takes for a candidate that cannot run (``accelerate/dry_runner.py``).
Importing this module needs neither ``nvcc`` nor a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

from dlrover_tpu_torch.common.constants import NodeEnv

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rms_norm", "paged_attention", "flash_attention",
           "flash_attention_bwd", "quantization")
BUILD_DIR_ENV = NodeEnv.KERNEL_BUILD_DIR
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class KernelError(RuntimeError):
    """A kernel failed to build (``nvcc``) or to launch (a CUDA error
    code from its C entry)."""


#: Launch counts per kernel: each wrapper adds one where it launches
#: its kernel, and nowhere else.  Plain-version calls never count.
launches: Dict[str, int] = {
    "rms_norm": 0,
    "rms_norm_bwd": 0,
    "paged_decode": 0,
    "paged_verify": 0,
    "flash_fwd": 0,
    "flash_bwd_dkv": 0,
    "flash_bwd_dq": 0,
    "quantize": 0,
    "dequantize": 0,
    "int8_adam": 0,
}

#: ``nvcc`` output of the last build of each source (``-Xptxas -v``
#: register/shared-memory report when built with ``verbose=True``),
#: kept beside the library and read back when the library is reused.
build_logs: Dict[str, str] = {}

#: sources this process compiled with ``nvcc`` (the rest it loaded
#: from an earlier build: an elastic restart should compile nothing)
compiled: List[str] = []

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches():
    for name in launches:
        launches[name] = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (take the plain
    version), False when all lie on CUDA (launch the kernel).  Any
    other mix raises: a kernel never silently runs on the host."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors on more than one CUDA device")
        return False
    raise ValueError(f"tensors on unsupported device mix {sorted(kinds)}")


def build_dir() -> Path:
    env = os.getenv(BUILD_DIR_ENV)
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "dlrover_tpu_torch"


def find_nvcc() -> str:
    for home in (os.getenv("CUDA_HOME"), os.getenv("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelError(
        "nvcc not found (set CUDA_HOME): the port's kernels are built "
        "from ops/csrc at first CUDA use"
    )


def _target(name: str, verbose: bool) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    flags = " ".join(NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ()))
    h.update(flags.encode())
    digest = h.hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def _reusable(name: str, verbose: bool) -> Optional[Path]:
    """An up-to-date library of ``name``: the one built with these flags
    or, failing that, the one built with ``ptxas``'s report toggled
    (``-Xptxas -v`` only prints: the code is the same)."""
    for v in (verbose, not verbose):
        target = _target(name, v)
        if target.exists():
            return target
    return None


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> float:
    """Compile every named source that has no up-to-date library yet,
    one ``nvcc`` per source, all running at once; load the libraries.
    Returns the wall seconds spent.  Raises with the compiler's output
    if any build fails."""
    t0 = time.monotonic()
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return 0.0
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            target = _reusable(name, verbose)
            if target is not None:
                log = target.with_suffix(".log")
                if log.exists():
                    build_logs[name] = log.read_text()
                continue
            target = _target(name, verbose)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
                ),
                tmp,
                target,
            )
        failed = []
        for name, (proc, tmp, target) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(name)
                continue
            target.with_suffix(".log").write_text(build_logs[name])
            os.replace(tmp, target)
            compiled.append(name)
        if failed:
            raise KernelError(
                "nvcc failed for "
                + ", ".join(failed)
                + ":\n"
                + "\n".join(build_logs[n] for n in failed)
            )
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_reusable(name, verbose)))
    return time.monotonic() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``ops/csrc/<name>.cu``, built on first
    use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name]
    return lib


def check(code: int, lib: ctypes.CDLL, what: str):
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        lib.dl_error_string.restype = ctypes.c_char_p
        lib.dl_error_string.argtypes = [ctypes.c_int]
        msg = lib.dl_error_string(code).decode(errors="replace")
        raise KernelError(f"{what}: CUDA error {code}: {msg}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
