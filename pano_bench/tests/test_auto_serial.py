"""``loops/auto_serial.py`` through ``run_cell`` on the CPU, on a copy of
the benchmark to which its cells were added by files alone (``added``):
a row of three rooted at its middle image, image 1, and a 2x2 grid.

The port's global composite puts its anchor at the canvas pixel nearest
its exact place (``pipeline.blend_global``), where it warps the other
images to. The planted fault ``anchor_a_pixel_off`` moves the anchor a
pixel off its neighbours, which the comparison must catch."""

import time

import pytest
import torch

from pano_bench import drivers
from pano_bench.control import control_run
from pano_bench.run import run_cell
from pano_bench.spec import Spec
from pano_bench.tests.added import add_auto_cell, copy_bench
from pano_bench.tests.small import SEED, overrides


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    bench_dir = copy_bench(tmp_path_factory.mktemp("auto"))
    for shape in ("row3", "grid2x2"):
        add_auto_cell(bench_dir, shape)
    return Spec(bench_dir)


def run(spec, name, trace=False):
    return run_cell(spec, spec.workload(name), SEED, 0.3, trace,
                    [torch.device("cpu")], time.perf_counter(),
                    overrides(name, spec.dir))


@pytest.fixture
def anchors(monkeypatch):
    """The anchor of every answer the loop makes."""
    seen = []
    real = drivers._answer

    def answer(*args, **kwargs):
        a = real(*args, **kwargs)
        seen.append(a["anchor"])
        return a
    monkeypatch.setattr(drivers, "_answer", answer)
    return seen


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_row_rooted_at_image_1(spec, anchors, trace):
    out = run(spec, "auto.row3", trace)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert anchors and set(anchors) == {1}
    assert list(out)[-1] == "compared"
    if trace:
        assert "breakdown" in out and out["device"]["window_s"] > 0
    else:
        assert set(out["metrics"]) == {"panoramas_per_s", "latency_p95_ms",
                                       "peak_mem_mib", "setup_s"}


def test_grid_2x2(spec, anchors):
    out = run(spec, "auto.grid2x2")
    assert out["correct"], out["compared"]
    assert anchors


def test_control_is_not_correct(spec):
    got = control_run(spec, spec.workload("auto.row3"), SEED,
                      torch.device("cpu"), overrides("auto.row3", spec.dir))
    assert not got["correct"], got


def test_estimate_altered(spec, monkeypatch):
    """Every pair's estimate row with its x translation 2 px off."""
    from pano_tpu_torch import pipeline
    real = pipeline.auto_pair_row

    def row(*args, **kwargs):
        r = real(*args, **kwargs)
        return r + torch.nn.functional.one_hot(
            torch.tensor(2), r.shape[0]).to(r) * 2.0
    monkeypatch.setattr(pipeline, "auto_pair_row", row)
    out = run(spec, "auto.row3")
    assert not out["correct"]
    assert out["compared"]["h_err_px"]["value"] >= 1.5


def test_anchor_a_pixel_off(spec, monkeypatch):
    """The anchor one pixel left of where its neighbours are warped:
    ``blend_global`` takes the canvas translation only to place the
    anchor, the warps being planned already."""
    from pano_tpu_torch import pipeline
    real = pipeline.blend_global

    def blend(anchor_img, t_mat, *args, **kwargs):
        t_mat = t_mat.copy()
        t_mat[0, 2] -= 1.0
        return real(anchor_img, t_mat, *args, **kwargs)
    monkeypatch.setattr(pipeline, "blend_global", blend)
    out = run(spec, "auto.row3")
    assert not out["correct"]
    assert out["compared"]["pixel_max_d"]["value"] > 20
