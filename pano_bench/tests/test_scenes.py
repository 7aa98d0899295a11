"""The generators' planted geometry, and the plain reference."""

import numpy as np
import pytest
import torch

from pano_bench import reference, scenes

SCENES = [[[0, 0], [83, 5]], [[0, 0], [97, 11]], [[0, 0], [61, 2]]]


def test_texture_values_and_squares():
    gen = scenes.generator(5, "cpu")
    img = scenes.texture(120, 160, gen, "cpu")
    assert img.shape == (120, 160, 3) and img.dtype == torch.uint8
    bright = (img >= scenes.SQUARE_LOW).all(-1)
    assert 0.05 < float(bright.float().mean()) < 0.4
    assert int(img.max()) < scenes.SQUARE_HIGH


def test_crops_are_the_scene_at_the_planted_offsets():
    gen = scenes.generator(9, "cpu")
    offs = [(0, 0), (40, 7), (85, 3)]
    imgs = scenes.scene_images(offs, 50, 60, gen, "cpu")
    for (xa, ya), a in zip(offs, imgs):
        for (xb, yb), b in zip(offs, imgs):
            dx, dy = xb - xa, yb - ya
            if dx >= 0 and dy >= 0 and dx < 60:   # b's origin inside a
                ov_a = a[dy:, dx:]
                assert torch.equal(ov_a, b[:ov_a.shape[0], :ov_a.shape[1]])


def test_pool_from_the_seed():
    a = scenes.make_pool(SCENES, 40, 120, 2 ** 31 + 3, "cpu", "host")
    b = scenes.make_pool(SCENES, 40, 120, 2 ** 31 + 3, "cpu", "host")
    c = scenes.make_pool(SCENES, 40, 120, 2 ** 31 + 4, "cpu", "device")
    assert all(np.array_equal(x, y) for sa, sb in zip(a, b)
               for x, y in zip(sa.images, sb.images))
    assert isinstance(a[0].images[0], np.ndarray)
    assert isinstance(c[0].images[0], torch.Tensor)
    # every seed: the same set of offsets, in its own order
    assert sorted(s.offsets for s in a) == sorted(s.offsets for s in c)
    g = scenes.planted_globals(a[0])
    assert np.array_equal(g[1], scenes.translation(*a[0].offsets[1]))


def test_reference_is_the_scene():
    gen = scenes.generator(11, "cpu")
    offs = [(0, 0), (30, 4), (64, 9)]
    imgs = scenes.scene_images(offs, 40, 50, gen, "cpu")
    gen = scenes.generator(11, "cpu")
    tex = scenes.texture(40 + 9, 50 + 64, gen, "cpu")
    pano = reference.panorama(imgs, [scenes.translation(x, y)
                                     for x, y in offs])
    assert pano.shape == tex.shape
    covered = torch.zeros(tex.shape[:2], dtype=torch.bool)
    for x, y in offs:
        covered[y:y + 40, x:x + 50] = True
    assert torch.equal(pano[covered], tex[covered])
    assert int(pano[~covered].max()) == 0


def test_corner_error():
    t = scenes.translation(300.0, 7.0)
    assert reference.corner_error(t, t, 40, 50) == 0.0
    off = scenes.translation(300.0, 7.5)
    assert reference.corner_error(off, t, 40, 50) == pytest.approx(0.5)
    unplaced = reference.UNPLACED_PX
    assert reference.corner_error(None, t, 40, 50) == unplaced
    assert reference.corner_error(np.full((3, 3), np.nan), t, 40, 50) \
        == unplaced
    assert reference.corner_error(np.zeros((3, 3)), t, 40, 50) == unplaced


def test_judge_on_exact_answers_and_on_altered_ones():
    pool = scenes.make_pool([[[0, 0], [300, 5]]], 40, 400, 3, "cpu", "device")
    truth = scenes.planted_globals(pool[0])
    ref = reference.panorama(pool[0].images, truth)
    limits = {"h_err_px": 0.5, "canvas_px": 1, "pixel_max_d": 2}
    good = [{"scene": 0, "placed": truth, "pano": ref.clone()}]
    judged = reference.judge(good, pool, limits)
    assert judged["failed"] == 0 and reference.within(judged["compared"])
    bad_h = [{"scene": 0, "placed": [truth[0], scenes.translation(301, 5)],
              "pano": None}]
    assert reference.judge(bad_h, pool, limits)["failed"] == 1
    shifted = torch.roll(ref, 1, dims=1)
    got = reference.judge([{"scene": 0, "placed": truth, "pano": shifted}],
                          pool, limits)
    assert got["failed"] == 1
    assert got["compared"]["pixel_max_d"]["value"] > 100
    gone = reference.judge([{"scene": 0, "placed": None, "pano": None}],
                           pool, limits)
    assert gone["compared"]["missing"]["value"] == 1
    left_out = reference.judge([{"scene": 0, "placed": truth[:1],
                                 "pano": None}], pool, limits)
    assert left_out["failed"] == 1
    nan = reference.judge([{"scene": 0, "placed": [truth[0], np.full(
        (3, 3), np.nan)], "pano": None}], pool, limits)
    assert nan["failed"] == 1 and not reference.within(nan["compared"])


def test_bfloat16_reference_is_not_correct():
    """The control's precision: offsets that bfloat16 cannot hold (here
    301 -> 300) move the placement and the sampling."""
    pool = scenes.make_pool([[[0, 0], [301, 5]]], 40, 400, 3, "cpu", "device")
    from pano_bench.control import control_answers
    limits = {"h_err_px": 0.5, "canvas_px": 1, "pixel_max_d": 2}
    judged = reference.judge(control_answers(pool), pool, limits)
    assert not reference.within(judged["compared"])
    assert judged["compared"]["h_err_px"]["value"] >= 1.0


def _blocks():
    """Two flat images that differ (10 and 200), the second 30 px to the
    right and 4 down: where they overlap, the one drawn last shows."""
    a = torch.full((40, 50, 3), 10, dtype=torch.uint8)
    b = torch.full((40, 50, 3), 200, dtype=torch.uint8)
    return [a, b], [scenes.translation(0, 0), scenes.translation(30, 4)]


def test_reference_draws_the_anchor_first():
    imgs, hs = _blocks()
    first = reference.panorama(imgs, hs)
    assert torch.equal(first, reference.panorama(imgs, hs, torch.float32,
                                                 0))
    assert first.shape == (44, 80, 3)
    assert int(first[10, 40, 0]) == 200 and int(first[2, 10, 0]) == 10
    second = reference.panorama(imgs, hs, torch.float32, 1)
    assert int(second[10, 40, 0]) == 10      # image 0 drawn over image 1
    assert int(second[30, 70, 0]) == 200


def test_edge_band_leaves_out_the_anchor():
    imgs, hs = _blocks()
    band0 = reference.edge_band((44, 80), imgs, hs)
    assert torch.equal(band0, reference.edge_band((44, 80), imgs, hs, 0))
    want = torch.zeros((44, 80), dtype=torch.bool)   # image 1's edges
    want[3:5, 29:80] = want[43:45, 29:80] = True
    want[3:44, 29:31] = want[3:44, 79:81] = True
    assert torch.equal(band0, want)
    band1 = reference.edge_band((44, 80), imgs, hs, 1)
    want = torch.zeros((44, 80), dtype=torch.bool)   # image 0's edges
    want[0:1, 0:51] = want[39:41, 0:51] = True
    want[0:41, 0:1] = want[0:41, 49:51] = True
    assert torch.equal(band1, want)


def test_judge_without_an_anchor_is_anchor_0():
    offs = [(0, 0), (30, 4), (64, 9)]
    gen = scenes.generator(13, "cpu")
    pool = [scenes.Scene(scenes.scene_images(offs, 40, 50, gen, "cpu"),
                         tuple(offs), tuple(scenes.translation(x, y)
                                            for x, y in offs))]
    truth = scenes.planted_globals(pool[0])
    ref = reference.panorama(pool[0].images, truth)
    off = [truth[0], truth[1], scenes.translation(64.4, 9)]
    limits = {"h_err_px": 0.25, "canvas_px": 5, "pixel_max_d": 20}
    answers = [{"scene": 0, "placed": truth, "pano": ref},
               {"scene": 0, "placed": off, "pano": ref.flip(1)},
               {"scene": 0, "placed": None, "pano": None}]
    plain = reference.judge(answers, pool, limits)
    zero = reference.judge([dict(a, anchor=0) for a in answers], pool,
                           limits)
    assert plain == zero
    assert plain["failed"] == 2
    assert plain["compared"]["h_err_px"]["value"] == pytest.approx(0.4)
    assert plain["compared"]["missing"]["value"] == 1
