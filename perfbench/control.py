"""The readings that a cell's correctness limits are set from, in one
process on the card:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 6 [--out FILE]

For each of ``--seeds`` the program as the configuration states it (bf16
compute) runs a short window at the cell's own load and its rows are
compared with the reference, as in a run; for each of
``--control-seeds`` the control does the same: the program with its
int8 path switched on (``int8_compute``: K3's int8 tensor-core products,
the precision below the stated bf16). Prints one JSON line a reading;
``--out`` also writes them all to FILE, each with its rows' cosine gaps
and lengths.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, int8: bool, seconds: float, device) -> list:
    from perfbench import compare, harness
    out = []
    for seed in seeds:
        engine, traffic, phases = harness.prepare(cell, seed, device, int8)
        harness.settle()
        win = harness.drive(engine, traffic, cell.mix, seed, seconds, False)
        del engine
        harness.release(device)
        t0 = time.perf_counter()
        rows = harness.compared_rows(cell.mix, seed, win)
        got, want = harness.reference(cell, seed, rows, device)
        values = compare.numbers(got, want)
        gap = compare.row_gaps(got, want)
        harness.release(device)
        row = {"cell": cell.name, "seed": seed,
               "path": "int8_compute" if int8 else "program",
               "requests": win.attempted, "failed": win.failed,
               "rows": len(rows),
               "reference_s": time.perf_counter() - t0,
               "setup_phases_s": phases, **values}
        print(json.dumps(row), flush=True)
        row["per_row"] = {"gap": gap.tolist(),
                          "len": [len(s) for s, _ in rows]}
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.load_cell(ROOT, args.workload)

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    rows = readings(cell, ints(args.seeds), False, args.seconds, device)
    rows += readings(cell, ints(args.control_seeds), True, args.seconds,
                     device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    for path in ("program", "int8_compute"):
        for key in ("cos_gap_max", "cos_gap_mean", "emb_err_max",
                    "emb_err_mean"):
            vals = [r[key] for r in rows if r["path"] == path]
            if vals:
                print(f"{path} {key}: min {min(vals)!r} max {max(vals)!r}",
                      file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
