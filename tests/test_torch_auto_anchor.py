"""The global composite's anchor, and auto mode on unordered captures,
on the CPU.

``blend_global`` puts the anchor at the canvas pixel nearest its exact
place, where the other images are warped to. The JAX package truncates
the translation instead (ROADMAP E's recorded differences): when the
estimates put the extent a hair short of an integer and the anchor is
not the canvas's top-left image, as auto mode's root often is, the
anchor lands a pixel off its neighbours. The panoramas here are held to
the benchmark's plain reference (``pano_bench/reference.py``), which
draws each scene from its planted placements in the anchor's frame, at
the CPU sizes and limits of the ``oilseed_auto.host_serial`` cell."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pano_bench import reference, scenes  # noqa: E402
from pano_bench.run import merged, pano_config  # noqa: E402
from pano_bench.spec import HERE, Spec  # noqa: E402
from pano_tpu_torch import DEFAULT_CONFIG  # noqa: E402
from pano_tpu_torch import pipeline as TP  # noqa: E402

SEED = 2 ** 31 + 977
CONFIG = "oilseed_auto_3x4_multiband"
CELL = "oilseed_auto.host_serial"
# A row of three at the CPU size, whose middle image overlaps both others
# and roots the panorama.
ROW3 = [[[0, 0], [83, 5], [171, 9]], [[0, 0], [79, 3], [165, 12]]]


def _cell():
    """(the cell's PanoConfig at its CPU size, its limits, its CPU
    traffic)."""
    spec = Spec()
    shrunk = json.loads((HERE / "tests" / "shrunk" / f"{CELL}.json")
                        .read_text())
    cfg = merged(spec.config(CONFIG), shrunk["config"])
    return cfg, spec.limits(CONFIG), shrunk["traffic"]


def _auto_answers(pool, cfg, monkeypatch):
    """Each scene of `pool` through stitch_all_images(mode="auto"): the
    answers as ``reference.judge`` takes them (placements in image 0's
    frame, the panorama, the root as the anchor)."""
    seen = []
    real = TP.composite_global

    def capture(images, devs, globals_h, config, anchor=0, *a, **k):
        seen.append((globals_h, anchor))
        return real(images, devs, globals_h, config, anchor, *a, **k)

    monkeypatch.setattr(TP, "composite_global", capture)
    answers = []
    for k, scene in enumerate(pool):
        pano = TP.stitch_all_images(scene.images,
                                    pano_config(cfg["pano_config"]), False,
                                    "", "cpu", mode="auto")
        globals_h, anchor = seen[-1]
        back = np.linalg.inv(globals_h[0])
        answers.append({"scene": k, "pano": pano, "anchor": anchor,
                        "placed": [None if g is None else back @ g
                                   for g in globals_h]})
    return answers


@pytest.mark.parametrize("frac", [-1e-5, 0.4, 0.6],
                         ids=["hair_short", "k+0.4", "k+0.6"])
def test_anchor_at_the_nearest_pixel(frac):
    """The anchor (image 0) with the other image up and left of it by
    (7 + frac, 5 + frac) px: the anchor lands whole at the rounded
    translation, on the canvas (its extent's ceiling) even rounded up,
    and nothing else is drawn."""
    h, w = 24, 32
    anchor = np.random.default_rng(0).integers(1, 255, (h, w, 3),
                                               dtype=np.uint8)
    tx, ty = 7 + frac, 5 + frac
    globals_h = [np.eye(3), scenes.translation(-tx, -ty)]
    t_mat, ch, cw = TP.global_canvas_geometry(
        [anchor, np.zeros_like(anchor)], globals_h, 0)
    np.testing.assert_allclose(t_mat[:2, 2], [tx, ty], rtol=0, atol=1e-9)
    pano = TP.blend_global(torch.from_numpy(anchor), t_mat, ch, cw, iter(()),
                           DEFAULT_CONFIG).copy()
    x0, y0 = int(round(tx)), int(round(ty))
    assert (x0, y0) == ((7, 5) if frac < 0.5 else (8, 6))
    assert y0 + h <= ch and x0 + w <= cw
    np.testing.assert_array_equal(pano[y0:y0 + h, x0:x0 + w], anchor)
    pano[y0:y0 + h, x0:x0 + w] = 0
    assert not pano.any()


def test_row_rooted_at_its_middle_image_matches_the_reference(monkeypatch):
    """A row of three rooted at image 1, whose estimates put the extent a
    hair short of the planted integer (t = 78.99999 and 82.99998): with
    the anchor truncated it read pixel_max_d 252 and 254 against the
    reference; at the nearest pixel it is within the cell's limits."""
    cfg, limits, _ = _cell()
    pool = scenes.make_pool(ROW3, cfg["image_h"], cfg["image_w"], SEED,
                            "cpu", "host")
    answers = _auto_answers(pool, cfg, monkeypatch)
    assert [a["anchor"] for a in answers] == [1, 1]
    judged = reference.judge(answers, pool, limits)
    assert judged["failed"] == 0, judged["compared"]
    assert judged["compared"]["pixel_max_d"]["value"] <= limits["pixel_max_d"]


def test_unordered_3x4_grid_matches_the_reference(monkeypatch):
    """The cell's CPU traffic: 3x4 grids whose offsets are listed in a
    non-raster order. Every image is placed, the root is an inner image
    (image 0 is not the canvas's top-left one), and each panorama is
    within the cell's limits."""
    cfg, limits, traffic = _cell()
    pool = scenes.make_pool(traffic["scenes"], cfg["image_h"],
                            cfg["image_w"], SEED, "cpu", "host")
    answers = _auto_answers(pool, cfg, monkeypatch)
    for a, scene in zip(answers, pool):
        assert len(a["placed"]) == 12 and all(
            g is not None for g in a["placed"])
        assert scene.offsets[0] != min(scene.offsets, key=sum)
        xs = sorted(x for x, _ in scene.offsets)   # 4 columns of 3
        ys = sorted(y for _, y in scene.offsets)   # 3 rows of 4
        rx, ry = scene.offsets[a["anchor"]]
        assert xs[2] < rx < xs[-3] and ys[3] < ry < ys[-4], (rx, ry)
    judged = reference.judge(answers, pool, limits)
    assert judged["failed"] == 0, judged["compared"]
    assert reference.within(judged["compared"]), judged["compared"]
