"""The harness: one cell, once per process.

A cell is found by name: ``BENCHMARK.json`` gives its configuration and
traffic mix, ``workloads/<cell>.json`` the entry point it drives (a module
``drivers/<entry>.py``), its check's sample and the limits of the numbers
compared; ``configs/<config>.json`` holds the model's sizes and precision,
``traffic/<mix>.json`` the traffic's parameters.  Each per-layer metric the
cell reports is read by ``metrics/<metric>.py``.  Adding a cell, a
configuration, a mix or a metric adds files; it edits none.

A run: set-up (program, weights and inputs from the seed, every shape the
window uses warmed), the measured window of ``--seconds``, the device's
peak memory, the program's state freed, then the check against the plain
reference, and the result line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "egm_unet_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def entry(self) -> str:
        return self.workload["entry"]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: the run is correct where every
    value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, overrides: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` and its files describe it;
    ``overrides`` (``{"config": {...}, "traffic": {...}, "workload": {...}}``)
    replace keys, for rehearsals and controls."""
    bench_dir = Path(root) / BENCH_DIR.name
    bench = _json(Path(root) / "BENCHMARK.json")
    ov = overrides or {}
    rows = [w for w in bench["workloads"] if w["name"] == name]
    if not rows:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    row = rows[0]
    workload = _merge(_json(bench_dir / "workloads" / f"{name}.json"), ov.get("workload"))
    config = _merge(_json(bench_dir / "configs" / f"{row['config']}.json"), ov.get("config"))
    traffic = _merge(_json(bench_dir / "traffic" / f"{row['traffic']}.json"), ov.get("traffic"))
    workload["chips"] = row["chips"]

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(name, config, traffic, workload,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if name in m.get("workloads", [])])


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``metrics/<metric>.py``'s ``read``."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", metric), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(entry: str):
    return importlib.import_module(f"port_bench.drivers.{entry}").Driver


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a run hands the per-layer readers."""
    cell: Cell
    e2e: Dict[str, float]
    counts: Dict[str, Any]
    trace: Optional[dict]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None) -> dict:
    """Set up, measure, check; returns the result line as a dict.  On a
    device other than CUDA (a rehearsal) every metric and device reading
    is left unmeasured (None)."""
    import torch

    from port_bench.trace import Tracer

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    on_device = torch.device(device).type == "cuda"
    drv = driver_class(cell.entry)(cell, seed, torch.device(device), log)
    if on_device:  # every kernel library at once (cached after a checkout's first run)
        from egm_unet_torch.ops.cuda.build import build_all

        build_all()
    drv.setup()
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(trace, cuda=on_device)
    drv.window(seconds, tracer)
    peak = drv.memory_peak()
    e2e = drv.e2e()
    e2e["setup_s"] = setup_s
    attempted, failed = drv.attempted, drv.failed
    drv.release()
    checks: List[Check] = drv.check()
    summary = tracer.summary
    counts = drv.counts()
    run = Run(cell, e2e, counts, summary)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v if on_device else None, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            metrics[m["name"]] = {"value": v if on_device else None, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_device else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if on_device else None,
           "count": cell.chips if on_device else 0,
           "memory_peak_bytes": peak if on_device else None}
    result = {"correct": bool(checks) and all(c.ok for c in checks) and failed == 0,
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"] if on_device and summary else None
        dev["window_s"] = summary["window_s"] if on_device and summary else None
        if on_device and summary:
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}")
    return result
