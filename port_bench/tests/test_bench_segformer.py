"""The SegFormer cell, ``segformer_b5.bucket_b32``, on the CPU: a rehearsal
at a tiny size (the result line, no device number filled from a CPU run),
runs whose program is broken underneath (each fails its own number), the
float8 stand-in failing where the program passes, a program without
SegFormer failing the cell at once, the readers, the yardstick's FLOPs and
attention sites, and the cell's declaration in ``BENCHMARK.json``.  On the
card (``-m card``): the control not correct where the sound program is.

The tiny widths are [32, 64, 160, 256]: this CPU's bfloat16 convolution
(oneDNN) returns wrong sums for some strided convolutions of 8 to 24
channels (e.g. 8 channels at kernel 8, stride 8), which the reduction convs
at [8, 16, 40, 64] would hit.  The cell's tiny sizes enter
``test_bench_rehearsal.TINY`` from here, as ``test_bench_clip_rn.py``
enters its own."""

import json
import subprocess
import sys
import time

import pytest
import test_bench_rehearsal
import torch

from port_bench import core
from port_bench.control import readings

CELL = "segformer_b5.bucket_b32"
TINY_ARCH = {"hidden_sizes": [32, 64, 160, 256], "depths": [1, 1, 2, 1],
             "num_attention_heads": [1, 2, 5, 8], "decoder_hidden_size": 32}
TINY = {"config": {"segformer": TINY_ARCH, "base_size": 60},
        "traffic": {"frames": [[60, 90, 1.0]], "pool": 4, "batch": 2, "pool_batches": 2},
        "workload": {"check_block": 2}}
test_bench_rehearsal.TINY.setdefault(CELL, TINY)
NUMBERS = {"logit_err_ratio", "mask_logit_off"}
METRICS = {"device.idle_share.batch", "segformer_forward.mfu",
           "segformer_forward.launches_per_batch", "segformer_attention_bf16_roofline",
           "segformer.attention_calls_per_forward"}


def run(trace=False, seed=2 ** 31 + 17, overrides=TINY):
    cell = core.load_cell(CELL, overrides)
    return cell, core.run_cell(cell, seed, 1.0, trace, "cpu", time.perf_counter(),
                               log=lambda *a: None)


def failing(r):
    return {k for k, c in r["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_result_line(trace):
    from egm_unet_torch.utils import profiling

    profiling.reset_table()
    cell, r = run(trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 2 == 0
    assert set(r["checks"]) == NUMBERS and r["checks"]["mask_logit_off"]["value"] == 0
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["kind"] is None and dev["memory_peak_bytes"] is None
    assert all(m["value"] is None for m in r["metrics"].values())
    if trace:
        assert set(r["metrics"]) <= METRICS
        assert {"segformer_forward.mfu", "segformer.attention_calls_per_forward"} \
            <= set(r["metrics"])
        assert dev["busy_s"] is None and "breakdown" not in r
        # the counter's reading, which the CPU run leaves unreported
        assert core.reader("segformer.attention_calls_per_forward")(None) == 5.0
    else:
        assert set(r["metrics"]) == {"batch_img_per_s", "setup_s"}
    profiling.reset_table()


@pytest.mark.parametrize("fault", ["align_corners", "dwconv_skipped", "masks_flipped"])
def test_a_broken_program_fails_its_own_number(monkeypatch, fault):
    import torch.nn.functional as F

    from egm_unet_torch import serving
    from egm_unet_torch.models import segformer

    if fault == "align_corners":  # the head's resizes with the other corner rule
        def corners(x, hw):
            return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                                 align_corners=True).permute(0, 2, 3, 1)
        monkeypatch.setattr(segformer, "resize_map", corners)
    elif fault == "dwconv_skipped":  # Mix-FFN without its depthwise conv
        monkeypatch.setattr(segformer.MixFFN, "forward",
                            lambda self, x, hw: self.fc2(F.gelu(self.fc1(x))))
    else:  # masks that are not the argmax of the logits served
        forward = serving.Predictor.forward
        monkeypatch.setattr(serving.Predictor, "forward", lambda self, x: 1 - forward(self, x))
    _, r = run()
    assert r["correct"] is False
    assert failing(r) == ({"mask_logit_off"} if fault == "masks_flipped"
                          else {"logit_err_ratio"})


def test_float8_stand_in_fails_where_the_program_passes():
    wl = core.load_cell(CELL).workload
    ov = {**TINY, "workload": {**TINY["workload"], **wl["controls"]["float8_reference"]["workload"]}}
    _, r = run(overrides=ov)
    assert failing(r) == {"logit_err_ratio"}
    assert r["checks"]["logit_err_ratio"]["value"] > 3 * r["checks"]["logit_err_ratio"]["limit"]


def test_a_program_without_segformer_fails_at_once():
    code = ("import sys; sys.path.insert(0, '.');"
            "sys.modules['egm_unet_torch.models.segformer'] = None;"
            "from port_bench import core; core.driver_class('segformer_forward')")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=str(core.ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "ModuleNotFoundError: import of egm_unet_torch.models" \
        ".segformer halted" in out.stderr
    assert time.perf_counter() - t0 < 120


def test_attention_calls_reader(monkeypatch):
    from egm_unet_torch.utils import profiling

    read = core.reader("segformer.attention_calls_per_forward")
    full = {"segformer.forwards": {"value": 3}, "segformer.attention_calls": {"value": 156}}
    for tab, want in ((full, 52.0), ({}, None), ({"segformer.forwards": {"value": 3}}, None),
                      ({**full, "segformer.forwards": {"value": 0}}, None)):
        monkeypatch.setattr(profiling, "table", lambda t=tab: {k: dict(v) for k, v in t.items()})
        assert read(None) == want
    monkeypatch.delattr(profiling, "table")
    assert read(None) is None


def _full_arch():
    return core.load_cell(CELL).config["segformer"]


def test_flops_by_hand():
    from port_bench.roofline.segformer_flops import segformer_flops

    arch = {**_full_arch(), **TINY_ARCH}
    total, hw, cin, d, labels = 0, (64, 64), 3, 32, 2
    grids = []
    for c, depth, k, s, r in zip(arch["hidden_sizes"], arch["depths"], arch["patch_sizes"],
                                 arch["strides"], arch["sr_ratios"]):
        hw = tuple((v + 2 * (k // 2) - k) // s + 1 for v in hw)
        n = hw[0] * hw[1]
        m = (hw[0] // r) * (hw[1] // r)
        total += 2 * n * k * k * cin * c  # the patch embed
        block = (2 * n * c * c  # q
                 + (2 * m * r * r * c * c if r > 1 else 0)  # the reduction conv
                 + 2 * m * c * 2 * c  # kv
                 + 4 * n * m * c  # q k^T and P v
                 + 2 * n * c * c  # proj
                 + 2 * n * c * 4 * c + 2 * n * 9 * 4 * c + 2 * n * 4 * c * c)  # Mix-FFN
        total += depth * block + 2 * n * c * d  # and the head's Linear
        grids.append(n)
        cin = c
    total += 2 * grids[0] * 4 * d * d + 2 * grids[0] * d * labels  # fuse and pred
    assert segformer_flops(arch, labels, (64, 64)) == total
    assert segformer_flops(_full_arch(), 2, (576, 768)) == pytest.approx(393.57e9, rel=1e-4)


def test_attention_sites():
    from port_bench.roofline.segformer_sites import segformer_attention_sites, stage_grids

    arch = _full_arch()
    assert stage_grids(arch, (576, 768)) == [(144, 192, 18, 24), (72, 96, 18, 24),
                                            (36, 48, 18, 24), (18, 24, 18, 24)]
    sites = segformer_attention_sites(arch, 32, (576, 768), "bfloat16")
    assert len(sites) == 52 and {s.op for s in sites} == {"segformer_attention"}
    assert sites[0].flops == 4.0 * 32 * 27648 * 432 * 64
    assert sites[0].nbytes == 32 * (2 * 27648 + 2 * 432) * 64 * 2
    assert sum(s.flops for s in sites) == pytest.approx(1.8468e12, rel=1e-4)


def test_attention_kernel_names_are_the_cells_own():
    from port_bench.roofline import NAMES_DIR, kernel_names

    ours = kernel_names("segformer_attention")
    assert ours
    others = {p.name for p in NAMES_DIR.glob("*/*") if p.parent.name != "segformer_attention"}
    others |= {"conv1x1_gemm_kernel", "mca_gate_sums_kernel", "eafe_edge_kernel"}
    assert not [n for n in ours for o in others if n in o or o in n]


def test_the_cell_is_declared():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    cell = core.load_cell(CELL)
    assert cell.chips == 1 and cell.entry == "segformer_forward"
    assert [m["name"] for m in cell.end_to_end] == ["batch_img_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert all(m["moves"] == "batch_img_per_s" for m in cell.per_layer)
    cfg = [c for c in bench["configs"] if c["name"] == "segformer_b5"][0]
    assert cfg["reduced"] == cell.config["reduced"] == ["num_labels"]
    assert cfg["source"] == cell.config["source"]
    assert cell.traffic == json.loads((core.BENCH_DIR / "traffic" / "bucket_b32.json").read_text())
    assert set(cell.workload["reasons"]) == set(cell.workload["limits"]) == NUMBERS
    assert cell.workload["limits"]["mask_logit_off"] == 0
    assert set(cell.workload["controls"]) == {"float8_reference"}


def test_the_configuration_is_the_programs_preset():
    from egm_unet_torch.models.segformer import SEGFORMER_B5
    from port_bench.drivers.segformer_forward import program_config

    assert program_config(core.load_cell(CELL).config) == SEGFORMER_B5


@pytest.mark.card
def test_control_fails_where_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    quiet = lambda *a: None  # noqa: E731
    sound = readings(CELL, [81, 82], 2.0, None, log=quiet)
    low = readings(CELL, [81, 82], 2.0, "float8_reference", log=quiet)
    assert all(r["correct"] for _, r in sound), [r["checks"] for _, r in sound]
    assert not any(r["correct"] for _, r in low), [r["checks"] for _, r in low]
