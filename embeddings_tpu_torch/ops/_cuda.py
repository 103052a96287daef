"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` for ``sm_90a`` into a shared library under
``embeddings_tpu_torch/_build/`` (git-ignored), then loaded with ctypes.
The library name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited kernel
rebuilds and a stale build is never loaded. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# each source's nvcc output from the build in this process (ptxas's -v
# report: registers, spills, and its C75xx notes, one for each wgmma
# serialized)
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = str(Path(home) / "bin" / "nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc``
    process per source, all started together. Returns each source's
    build seconds (0.0 when already built); their nvcc output goes to
    ``BUILD_LOGS``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def on_device(what: str, device: torch.device, **operands):
    """The guard of one kernel launch on ``device``: raises a
    ``ValueError`` naming the first operand (a tensor, or None for an
    absent one) that lies elsewhere, since the kernel would read a
    foreign pointer; else returns the context that makes ``device`` the
    CUDA runtime's current one for the launch (the libraries' per-device
    attributes and caches read it). On one card it changes nothing."""
    for name, t in operands.items():
        if t is not None and t.device != device:
            raise ValueError(f"{what}: operand {name} is on {t.device}, "
                             f"the launch on {device}")
    return torch.cuda.device(device)


def check(status: int, error_string, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch;
    ``error_string`` is the library's ``cudaGetErrorString`` export."""
    if status != 0:
        msg = error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
