#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json``, once, on the CUDA
device this process finds.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and ``checks`` last.  Exits non-zero and
prints no result without a CUDA device, without the program, or where JAX or
the JAX package got loaded.  Build and kernel caches stay inside the
checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".port_bench_cache"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # fixed cache directories inside the checkout; libraries that would
    # otherwise load JAX are told not to
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from port_bench import core

    cell = core.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"port_bench: JAX-side modules loaded in this process: {loaded}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
