#!/usr/bin/env python3
"""Readings that set a cell's limits, several seeds in one process.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13 --seconds 3 [--control NAME]

Sound runs read the program as the configuration states it.  ``--control
NAME`` applies the overrides the workload file's ``controls`` name (the
program's own path in the next precision below the configuration's, as TF32
for a float32 cell, or the plain reference in the program's place computed
in that precision, as float8 for a bfloat16 cell) and must come out not
correct.  One JSON line per seed: the compared numbers and whether the run
was correct.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds, seconds: float, control=None, device="cuda:0",
             overrides=None, log=None):
    """``[(seed, result), ...]`` of the cell run once per seed, as the
    workload's control ``control`` has it where that is named."""
    sys.path.insert(0, str(ROOT))
    from port_bench import core

    wl = core.load_cell(workload).workload
    ov = dict(overrides or {})
    if control:
        for part, keys in wl["controls"][control].items():
            ov[part] = {**ov.get(part, {}), **keys}
    out = []
    for seed in seeds:
        cell = core.load_cell(workload, ov)
        out.append((seed, core.run_cell(cell, seed, seconds, False, device,
                                        time.perf_counter(), log)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", default=None, help="a name under the workload's controls")
    args = p.parse_args(argv)
    for seed, r in readings(args.workload, args.seeds, args.seconds, args.control):
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
