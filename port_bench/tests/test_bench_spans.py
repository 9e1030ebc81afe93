"""The readers of the program's span and counter table: None on an empty
table, on a table without their span or counter, on one that counted no
image and on a program without the table; the right value on a filled one."""

import pytest

from port_bench import core

FILLED = {
    "fusion": {"count": 2, "seconds": 1.2, "self_seconds": 0.01, "parent": None},
    "fusion.preprocess": {"count": 2, "seconds": 0.5, "self_seconds": 0.48, "parent": "fusion"},
    "fusion.clip.pack": {"count": 2, "seconds": 0.04, "self_seconds": 0.04, "parent": "fusion"},
    "fusion.unet.pack": {"count": 4, "seconds": 0.03, "self_seconds": 0.024, "parent": "fusion"},
    "fusion.fuse": {"count": 2, "seconds": 0.4, "self_seconds": 0.08, "parent": "fusion"},
    "fusion.readback": {"count": 32, "seconds": 0.32, "self_seconds": 0.32,
                        "parent": "fusion.fuse"},
    "fusion.images": {"value": 32},
    "fusion.h2d_bytes": {"value": 32 * 8286208},
}
EXPECT = {"fusion.preprocess_ms_per_image": 15.0, "fusion.pack_ms_per_image": 2.0,
          "fusion.readback_ms_per_image": 10.0, "fusion.h2d_mb_per_image": 8.286208}
NEEDS = {"fusion.preprocess_ms_per_image": "fusion.preprocess",
         "fusion.pack_ms_per_image": "fusion.unet.pack",
         "fusion.readback_ms_per_image": "fusion.readback",
         "fusion.h2d_mb_per_image": "fusion.h2d_bytes"}


def with_table(monkeypatch, tab):
    from egm_unet_torch.utils import profiling

    monkeypatch.setattr(profiling, "table", lambda: {k: dict(v) for k, v in tab.items()})


@pytest.mark.parametrize("metric", sorted(EXPECT))
def test_reader_reads_the_table(monkeypatch, metric):
    read = core.reader(metric)
    with_table(monkeypatch, {})
    assert read(None) is None
    with_table(monkeypatch, FILLED)
    assert read(None) == pytest.approx(EXPECT[metric], rel=1e-12)
    with_table(monkeypatch, {k: v for k, v in FILLED.items() if k != NEEDS[metric]})
    assert read(None) is None
    with_table(monkeypatch, {**FILLED, "fusion.images": {"value": 0}})
    assert read(None) is None


@pytest.mark.parametrize("metric", sorted(EXPECT))
def test_reader_on_a_program_without_the_table(monkeypatch, metric):
    from egm_unet_torch.utils import profiling

    monkeypatch.delattr(profiling, "table")
    assert core.reader(metric)(None) is None


def test_the_readers_are_declared_for_the_fusion_cell():
    cell = core.load_cell("clipseg_fusion.folder_f32")
    declared = {m["name"]: m for m in cell.per_layer}
    for metric in EXPECT:
        m = declared[metric]
        assert m["moves"] == "fusion_img_per_s"
        assert m["layer"] == "cli/eval_clipseg.py fused_masks"
        assert m["source"] == ("program_counter" if metric == "fusion.h2d_mb_per_image"
                               else "program_span")
