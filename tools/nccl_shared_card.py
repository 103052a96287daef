"""Two processes on one card try NCCL, to see what it says.

Each process joins ``torch.distributed.init_process_group("nccl")`` on a
localhost coordinator with cuda:0 as its device, then runs one
``all_reduce`` of a CUDA tensor. NCCL is expected to refuse two ranks on
one device. The script prints each process's exit code and the end of
its output as one JSON line, and exits 0 once both have ended (a process
that runs past ``TIMEOUT_S`` is killed and reported so). It is a probe:
the port never tries NCCL to fall back on failure; ``parallel.mesh``'s
backend rule gives processes that share a card gloo through host memory.

    python3 tools/nccl_shared_card.py
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

TIMEOUT_S = 120
WORKER = """
import sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
t = torch.full((4,), float(rank + 1), device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print("all_reduce returned", t.tolist(), flush=True)
dist.destroy_process_group()
"""


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "NCCL_DEBUG": "WARN"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    out = []
    for r, p in enumerate(procs):
        try:
            text, timed_out = p.communicate(timeout=TIMEOUT_S)[0], False
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            text, timed_out = p.communicate()[0], True
        out.append({"rank": r, "exit_code": p.returncode,
                    "timed_out": timed_out, "output_tail": text[-2500:]})
    import torch
    print(json.dumps({"nccl_two_ranks_one_card": out,
                      "torch": torch.__version__,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version()))
                      }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
