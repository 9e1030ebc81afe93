"""The control of each cell, on the card, must come out not correct on
every seed where the sound program comes out correct: for the bfloat16 cell
the plain reference in the program's place with its convolutions in
float8, for the float32 fusion the program with TF32 on.  At a size a test run
holds (fewer images per batch and a shorter window than the cells'); the
limits were set from readings at the cells' own sizes (PERF.md).

    python -m pytest port_bench/tests/test_bench_control.py -m card
"""

import pytest
import torch

from port_bench.control import readings

SMALLER = {
    "egm_unet.bucket_b32": {"traffic": {"batch": 8, "pool": 16, "pool_batches": 2},
                            "workload": {"check_batches": 1}},
    "clipseg_fusion.folder_f32": {"traffic": {"pool": 16, "pool_folders": 1},
                                  "workload": {"check_folders": 1}},
}
CONTROLS = [("egm_unet.bucket_b32", "float8_reference"),
            ("clipseg_fusion.folder_f32", "tf32_program")]


@pytest.mark.card
@pytest.mark.parametrize("name,control", CONTROLS)
def test_control_fails_where_the_program_passes(name, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    quiet = lambda *a: None  # noqa: E731
    sound = readings(name, [71, 72, 73], 2.0, None, overrides=SMALLER[name], log=quiet)
    low = readings(name, [71, 72, 73], 2.0, control, overrides=SMALLER[name], log=quiet)
    assert all(r["correct"] for _, r in sound), [r["checks"] for _, r in sound]
    assert not any(r["correct"] for _, r in low), [r["checks"] for _, r in low]
