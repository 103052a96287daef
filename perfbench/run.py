"""Run one cell of the benchmark once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line (the last line of
standard output); see ``perfbench/README.md``.
"""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (from its age in
    /proc, to the kernel's 10 ms tick)."""
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - started / os.sysconf("SC_CLK_TCK"))


def main() -> int:
    t_start = process_start()
    # every cache of the program inside the checkout, at fixed paths
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    # one process with few threads: the host side is one Python thread
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "2"
    sys.path[0] = str(ROOT)  # the repository, not this folder
    from perfbench import harness
    return harness.main(sys.argv[1:], ROOT, t_start)


if __name__ == "__main__":
    sys.exit(main())
