"""Build the port's C ABI host and the reference's dlopen demo.

``csrc/capi.cpp`` exports the ABI of ``native/embeddings_c.h`` (the
reference's ``bert.h`` surface) and serves it with the port's Engine in
an embedded CPython interpreter — the counterpart of ``native/capi.cpp``,
which hosts the JAX engine. ``build()`` compiles it with ``g++`` at first
use (``utils.gxx.build_once``, as ``tokenizer/native.py`` builds the
native tokenizer) into
``embeddings_tpu_torch/_build/capi-<hash>/libembeddings_c.so``
(git-ignored), with the include and link flags of this interpreter's
``sysconfig`` (no ``python3-config``). The hash covers the sources, this
file, the interpreter and the repository root, which are fixed in the
library at build time. ``build_demo()`` compiles
``examples/capi_demo.cpp`` (``-ldl``) beside it::

    lib = capi.build()            # Path to libembeddings_c.so
    demo = capi.build_demo()      # Path to capi_demo
    # capi_demo <lib> <model> [dtype] [prompt...]; the device is
    # EMBEDDINGS_TPU_TORCH_DEVICE (default cuda)

Nothing runs at import.
"""

from __future__ import annotations

import hashlib
import sys
import sysconfig
from pathlib import Path

from .utils.gxx import build_once

_PKG = Path(__file__).resolve().parent
ROOT = _PKG.parent
SOURCE = _PKG / "csrc" / "capi.cpp"
HEADER = ROOT / "native" / "embeddings_c.h"
DEMO_SOURCE = ROOT / "examples" / "capi_demo.cpp"
BUILD_DIR = _PKG / "_build"
DEVICE_VAR = "EMBEDDINGS_TPU_TORCH_DEVICE"


def python_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed this interpreter, from its
    ``sysconfig``. Raises where it has no shared libpython."""
    cv = sysconfig.get_config_var
    if not cv("Py_ENABLE_SHARED"):
        raise RuntimeError("this interpreter has no shared libpython "
                           "(Py_ENABLE_SHARED=0): the C ABI host links one")
    lib = cv("LDLIBRARY")  # libpython3.12.so
    name = lib[3:].split(".so")[0]
    libdir = cv("LIBDIR")
    return ([f"-I{cv('INCLUDEPY')}"],
            [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}"])


def _hashed(kind: str, *parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return f"{kind}-{h.hexdigest()[:12]}"


def build(build_dir: Path | None = None) -> Path:
    """Build ``libembeddings_c.so`` if it is not built yet; returns its
    path."""
    build_dir = Path(build_dir or BUILD_DIR)
    cflags, ldflags = python_flags()
    tag = _hashed("capi", SOURCE.read_bytes(), HEADER.read_bytes(),
                  Path(__file__).read_bytes(), sys.executable.encode(),
                  str(ROOT).encode(), " ".join(cflags + ldflags).encode())
    out = build_dir / tag / "libembeddings_c.so"
    return build_once(out, lambda _tmp: [
        "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", str(SOURCE),
        *cflags, f"-I{HEADER.parent}",
        f'-DET_PYTHON_EXECUTABLE="{sys.executable}"',
        f'-DET_REPO_ROOT="{ROOT}"', *ldflags, "-ldl"], "C ABI host")


def build_demo(build_dir: Path | None = None) -> Path:
    """Build ``examples/capi_demo.cpp`` (a dlopen client of any library
    with the ABI) if it is not built yet; returns its path."""
    build_dir = Path(build_dir or BUILD_DIR)
    tag = _hashed("capi_demo", DEMO_SOURCE.read_bytes(),
                  Path(__file__).read_bytes())
    return build_once(build_dir / tag / "capi_demo", lambda _tmp: [
        "-O2", "-std=c++17", "-Wall", str(DEMO_SOURCE), "-ldl"],
        "C ABI demo")
