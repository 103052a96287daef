"""Build a host library or program with ``g++`` at first use, once across
processes: the port's native tokenizer (``tokenizer/native.py``) and its
C ABI host and demo (``capi.py``) build through ``build_once``."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Sequence


def build_once(out: Path, args: Callable[[Path], Sequence[str]], what: str,
               *, keep: Sequence[str] = ()) -> Path:
    """Make ``out`` with ``g++`` (``$CXX``) unless it exists. The build
    runs in a temporary directory beside ``out``'s parent under a file
    lock (``<parent of out's directory>/<what>.lock``: other processes
    wait, then find it built); ``args(tmp)`` returns the compiler's
    arguments, ``-o`` excepted, and may first write sources into
    ``tmp``; the files of ``tmp`` named in ``keep`` are moved beside
    ``out``. Returns ``out``; raises RuntimeError with the compiler's
    output when it fails, or when there is no compiler."""
    import fcntl
    out = Path(out)
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) for the {what}")
    build_dir = out.parent.parent
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"{what.replace(' ', '_')}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            tmp = Path(tmp)
            proc = subprocess.run(
                [cxx, *args(tmp), "-o", str(tmp / out.name)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the {what} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            out.parent.mkdir(exist_ok=True)
            for name in keep:
                os.replace(tmp / name, out.parent / name)
            os.replace(tmp / out.name, out)
    return out
