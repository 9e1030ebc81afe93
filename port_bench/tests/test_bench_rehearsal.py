"""A rehearsal of every cell on the CPU at a tiny size with the kernels'
plain versions: the harness's control flow end to end, the result line's
keys, and no device number filled from a CPU run.  Also: a cell,
configuration, mix and metric added as new files are found without editing
any file the benchmark has."""

import json
import shutil
import time

import pytest

from port_bench import core

TINY_CLIP = {"width": 64, "layers": 2, "patch": 16, "resolution": 64, "embed_dim": 32,
             "text_width": 64, "text_layers": 2, "context": 32, "vocab": 512,
             "extract_layers": [0, 1], "reduce_dim": 16}
TINY = {
    "egm_unet.bucket_b32": {
        "config": {"base_c": 8},
        "traffic": {"frames": [[60, 90, 1.0]], "pool": 4, "batch": 2, "pool_batches": 2},
        "workload": {"check_block": 2}},
    "clipseg_fusion.folder_f32": {
        "config": {"clipseg": TINY_CLIP, "unet": {"base_c": 8}, "clip_size": 64,
                   "clip_batch": 4, "unet_batch": 2, "base_size": 60},
        "traffic": {"frames": [[60, 90, 0.5], [90, 60, 0.5]], "pool": 6, "folder": 3,
                    "pool_folders": 2},
        "workload": {"check_block": 2}},
}


def bench_cells():
    return [w["name"] for w in json.loads((core.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_every_cell_has_a_rehearsal():
    assert set(bench_cells()) == set(TINY)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(TINY))
def test_rehearsal_result_line(name, trace):
    cell = core.load_cell(name, TINY[name])
    r = core.run_cell(cell, 2 ** 31 + 17, 1.0, trace, "cpu", time.perf_counter(),
                      log=lambda *a: None)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"] and all(set(v) == {"value", "limit"} for v in r["checks"].values())
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["kind"] is None and dev["memory_peak_bytes"] is None
    assert all(m["value"] is None for m in r["metrics"].values())
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) <= {m["name"] for m in wanted}
    if trace:
        assert dev["busy_s"] is None and dev["window_s"] is None and "breakdown" not in r
    else:
        assert set(r["metrics"]) == {m["name"] for m in wanted}
    json.dumps(r)


def test_new_files_are_discovered(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH_DIR, root / core.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    d = root / core.BENCH_DIR.name
    (d / "configs" / "egm_unet_small.json").write_text(
        json.dumps({**json.loads((d / "configs" / "egm_unet.json").read_text()), "base_c": 8}))
    (d / "traffic" / "bucket_b4.json").write_text(
        json.dumps({"frames": [[60, 90, 1.0]], "pool": 4, "batch": 4, "pool_batches": 1}))
    (d / "workloads" / "egm_unet_small.bucket_b4.json").write_text(
        (d / "workloads" / "egm_unet.bucket_b32.json").read_text())
    (d / "metrics" / "bench.new_metric.py").write_text("def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "egm_unet_small", "source": "x",
                             "file": "port_bench/configs/egm_unet_small.json",
                             "reduced": ["base_c"], "why": "x"})
    bench["workloads"].append({"name": "egm_unet_small.bucket_b4", "config": "egm_unet_small",
                               "traffic": "bucket_b4", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "bench.new_metric", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "batch_img_per_s",
                               "workloads": ["egm_unet_small.bucket_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = core.load_cell("egm_unet_small.bucket_b4", root=root)
    assert cell.config["base_c"] == 8 and cell.traffic["batch"] == 4
    assert cell.entry == "bucket_forward"
    assert [m["name"] for m in cell.per_layer] == ["bench.new_metric"]
    assert core.reader("bench.new_metric", d)(None) == 42.0
