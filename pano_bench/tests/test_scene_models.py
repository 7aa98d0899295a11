"""Scene models, found by the traffic's "scene" key (``Spec.pool``).

The crops model, the one every traffic file without the key runs, must
give what the harness gave before scene models existed. So its pool,
planted homographies, canvases, reference panoramas, edge bands, sample
sizes and window work are held, bit for bit, to copies of the formulas
of that harness (``parent_*`` below, kept as they were), for every
traffic file at its cell's CPU size.

The rotating model: its homographies place each image's pixels on the
rays they see, its images agree with them, every seed gives the same
poses with its own textures, and the judge holds its scenes as it holds
crops. Its rehearsal cell runs through ``run_cell`` on the CPU; whether
it is correct there is recorded (``record_property``), not asserted.
(``test_runs.py`` holds its control and its altered estimate.)"""

import json
import math
import random
import time

import numpy as np
import pytest
import torch

from pano_bench import reference, roofline, scenes
from pano_bench.run import make_sample, merged, run_cell, window_work
from pano_bench.spec import HERE, Spec
from pano_bench.tests.small import READY, REHEARSALS, SEED, cpu_devices, \
    overrides

SPEC = Spec()
CELLS = SPEC.bench["workloads"] + READY


def shrunk(cell: dict):
    """(cfg, traffic) of `cell` at its CPU size."""
    over = overrides(cell["name"])
    return (merged(SPEC.config(cell["config"]), over["config"]),
            merged(SPEC.traffic(cell["traffic"]), over["traffic"]))


def traffic_cells():
    """{traffic file under traffic/: a cell that runs it, or None}."""
    return {p.stem: next((c for c in CELLS if c["traffic"] == p.stem), None)
            for p in sorted((HERE / "traffic").glob("*.json"))}


CROP_CELLS = [c for n, c in traffic_cells().items()
              if c is not None and "scene" not in SPEC.traffic(n)]
ROTATING = next(c for c in READY if c["name"] == "pair4k.rotate_pair")


# --- the harness's formulas before scene models, kept as they were ----------


def parent_pool(traffic, h, w, seed, device):
    order = list(range(len(traffic)))
    random.Random(seed).shuffle(order)
    gen = scenes.generator(seed, device)
    pool = []
    for k in order:
        offsets = tuple((int(x), int(y)) for x, y in traffic[k])
        x0 = min(x for x, _ in offsets)
        y0 = min(y for _, y in offsets)
        sh = h + max(y for _, y in offsets) - y0
        sw = w + max(x for x, _ in offsets) - x0
        tex = scenes.texture(sh, sw, gen, device)
        pool.append(([tex[y - y0:y - y0 + h, x - x0:x - x0 + w].contiguous()
                      for x, y in offsets], offsets))
    return pool


def parent_globals(offsets):
    (x0, y0) = offsets[0]
    return [scenes.translation(x - x0, y - y0) for x, y in offsets]


def parent_canvas(offsets, h, w):
    xs, ys = [x for x, _ in offsets], [y for _, y in offsets]
    return (h + max(ys) - min(ys), w + max(xs) - min(xs))


def parent_sample_sizes(pool, h, w):
    sizes = {}
    for k, scene in enumerate(pool):
        xs = [x for x, _ in scene.offsets]
        ys = [y for _, y in scene.offsets]
        sizes[k] = (h + max(ys) - min(ys) + 2) \
            * (w + max(xs) - min(xs) + 2) * 3
    return sizes


def parent_window_work(answers, cfg, pool, alpha, pairs):
    work = {}
    h, w = cfg["image_h"], cfg["image_w"]
    harris = cfg["pano_config"].get("harris", {})
    k = harris.get("max_keypoints", 8192)
    p = harris.get("patch_size", 5)
    for a in answers:
        offs = pool[a["scene"]].offsets
        steps = parent_steps([(h, w)] * len(offs),
                             parent_canvas(offs, h, w), k, p, alpha, pairs)
        for s, v in steps.items():
            work[s] = work.get(s, 0.0) + v
    return work


def parent_steps(images, canvas, keypoints, patch, alpha, pairs):
    d = patch * patch * 3
    steps = {"detect": 0.0, "describe": 0.0, "match": 0.0,
             "warp_compose": 0.0, "eigvec": 0.0}
    for h, w in images:
        score_px = math.ceil(h / 2) * math.ceil(w / 2)
        steps["detect"] += roofline.least_seconds(
            h * w * 3 + score_px * 4,
            {"f32": roofline.DETECT_OPS_PER_PX * h * w})
        steps["describe"] += roofline.least_seconds(
            keypoints * (d + 8 + 1 + d * 4 + 1), {})
    n_pairs = roofline.estimates(len(images), pairs)
    kk = keypoints * keypoints
    steps["match"] = n_pairs * roofline.least_seconds(
        2 * keypoints * (d * 4 + 1) + keypoints * 12,
        {"int8": 2.0 * kk * d, "f32": roofline.MATCH_EPILOGUE_OPS * kk})
    steps["eigvec"] = n_pairs * roofline.least_seconds(
        81 * 4 + 9 * 4, {"f64": roofline.EIGVEC_OPS})
    warped_px = sum(h * w for h, w in images[1:])
    per_px = roofline.WARP_OPS_PER_PX + (roofline.ALPHA_OPS_PER_PX
                                         if alpha else 0)
    steps["warp_compose"] = roofline.least_seconds(
        sum(h * w * 3 for h, w in images) + canvas[0] * canvas[1] * 3,
        {"f32": per_px * warped_px})
    return steps


def parent_panorama(images, globals_h, dtype=torch.float32, anchor=0):
    _to_dtype, _warp_over = reference._to_dtype, reference._warp_over
    dev = images[0].device
    corners = []
    for img, g in zip(images, globals_h):
        h, w = img.shape[:2]
        c = _to_dtype([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], dtype,
                      dev)
        p = c @ _to_dtype(g, dtype, dev).T
        corners.append(p[:, :2] / p[:, 2:3])
    allc = torch.cat(corners)
    lo = torch.minimum(allc.min(0).values, torch.zeros((), dtype=dtype,
                                                       device=dev))
    hi = allc.max(0).values
    size = torch.ceil(hi - lo)
    canvas_w, canvas_h = int(size[0].float()), int(size[1].float())
    canvas = torch.zeros((canvas_h, canvas_w, 3), dtype=torch.uint8,
                         device=dev)
    shift = np.array([[1.0, 0.0, -float(lo[0].float())],
                      [0.0, 1.0, -float(lo[1].float())], [0.0, 0.0, 1.0]])
    order = [anchor] + [i for i in range(len(images)) if i != anchor]
    for i in order:
        img, g, cw = images[i], globals_h[i], corners[i]
        m_inv = _to_dtype(np.linalg.inv(shift @ np.asarray(g, np.float64)),
                          dtype, dev)
        cw = cw - lo
        x0 = max(int(math.floor(float(cw[:, 0].min().float()))), 0)
        y0 = max(int(math.floor(float(cw[:, 1].min().float()))), 0)
        x1 = min(int(math.ceil(float(cw[:, 0].max().float()))), canvas_w)
        y1 = min(int(math.ceil(float(cw[:, 1].max().float()))), canvas_h)
        if x1 <= x0 or y1 <= y0:
            continue
        _warp_over(canvas, img, m_inv, x0, y0, x1, y1, dtype)
    return canvas


def parent_band(shape, images, globals_h, anchor):
    ch, cw = shape
    band = torch.zeros((ch, cw), dtype=torch.bool)
    lo_x = min(0.0, min(float(g[0, 2]) for g in globals_h))
    lo_y = min(0.0, min(float(g[1, 2]) for g in globals_h))
    for i, (img, g) in enumerate(zip(images, globals_h)):
        if i == anchor:
            continue
        h, w = img.shape[:2]
        x0 = int(round(float(g[0, 2]) - lo_x))
        y0 = int(round(float(g[1, 2]) - lo_y))
        xa, xb = max(x0 - 1, 0), min(x0 + w + 1, cw)
        ya, yb = max(y0 - 1, 0), min(y0 + h + 1, ch)
        for r in (y0, y0 + h):
            band[max(r - 1, 0):max(r + 1, 0), xa:xb] = True
        for c in (x0, x0 + w):
            band[ya:yb, max(c - 1, 0):max(c + 1, 0)] = True
    return band


# --- the crops model against them ----------------------------------------------


def test_every_traffic_file_has_a_cell():
    assert None not in traffic_cells().values()
    assert CROP_CELLS and ROTATING not in CROP_CELLS


@pytest.mark.parametrize("cell", CROP_CELLS, ids=lambda c: c["traffic"])
def test_crops_are_what_the_harness_made_before(cell):
    cfg, traffic = shrunk(cell)
    h, w = cfg["image_h"], cfg["image_w"]
    pool = SPEC.pool(dict(traffic, resident="device"), cfg, SEED, "cpu")
    old = parent_pool(traffic["scenes"], h, w, SEED, "cpu")
    assert len(pool) == len(old)
    for scene, (imgs, offsets) in zip(pool, old):
        assert scene.offsets == offsets
        assert all(torch.equal(a, b) for a, b in zip(scene.images, imgs))
        truth = scenes.planted_globals(scene)
        assert all(np.array_equal(a, b) for a, b in
                   zip(truth, parent_globals(offsets)))
        assert all(a.dtype == np.float64 for a in truth)
        assert reference.canvas(reference.shapes(imgs), truth) \
            == parent_canvas(offsets, h, w)
        for anchor in sorted({0, len(imgs) - 1}):
            ref = reference.panorama(imgs, truth, torch.float32, anchor)
            assert torch.equal(ref, parent_panorama(imgs, truth,
                                                    torch.float32, anchor))
            assert torch.equal(
                reference.edge_band(ref.shape[:2], imgs, truth, anchor),
                parent_band(ref.shape[:2], imgs, truth, anchor))
    host = SPEC.pool(dict(traffic, resident="host"), cfg, SEED, "cpu")
    assert all(np.array_equal(a, b.numpy()) for s, (imgs, _) in
               zip(host, old) for a, b in zip(s.images, imgs))
    sample = make_sample(SEED, pool, cfg, 2, False)
    assert {k: v.numel() for k, v in sample.store.items()} \
        == parent_sample_sizes(pool, h, w)
    n = len(pool[0].images)
    answers = [{"scene": k, "anchor": a} for k in range(len(pool))
               for a in sorted({0, n - 1})]
    pairs = traffic.get("pairs", "adjacent")
    for alpha in (False, True):
        assert window_work(answers, cfg, pool, alpha, pairs) \
            == parent_window_work(answers, cfg, pool, alpha, pairs)


# --- the rotating model ----------------------------------------------------------


@pytest.fixture(scope="module")
def rotating():
    """(model, cfg, traffic, pool) of the rehearsal cell at its CPU
    size."""
    cfg, traffic = shrunk(ROTATING)
    model = SPEC.scene_model(traffic["scene"])
    return model, cfg, traffic, SPEC.pool(traffic, cfg, SEED, "cpu")


def planted_of(model, cfg, traffic):
    """Each traffic scene's homographies, from its poses."""
    k = model.intrinsics(cfg["image_h"], cfg["image_w"], traffic["hfov_deg"])
    return k, [[model.rotation(*pose) for pose in s]
               for s in traffic["scenes"]]


def test_rotating_homographies_put_pixels_on_their_rays(rotating):
    model, cfg, traffic, pool = rotating
    h, w = cfg["image_h"], cfg["image_w"]
    k, rots = planted_of(model, cfg, traffic)
    k_inv = np.linalg.inv(k)
    rng = np.random.default_rng(7)
    p = np.stack([rng.uniform(0, w - 1, 200), rng.uniform(0, h - 1, 200),
                  np.ones(200)])
    for scene_rots in rots:
        g = model.planted_homographies(k, scene_rots)
        assert np.array_equal(g[0], np.eye(3))
        for gi, ri in zip(g, scene_rots):
            q = gi @ p
            q = q / q[2]
            ray_i = ri.T @ k_inv @ p
            ray_0 = scene_rots[0].T @ k_inv @ q
            ray_i, ray_0 = (r / np.linalg.norm(r, axis=0)
                            for r in (ray_i, ray_0))
            assert np.abs(ray_i - ray_0).max() <= 1e-9
    # the pool carries these, in its own order
    want = sorted(model.planted_homographies(k, r)[1].tobytes()
                  for r in rots)
    assert sorted(scenes.planted_globals(s)[1].tobytes()
                  for s in pool) == want


def test_rotating_images_agree_with_their_homographies(rotating):
    """Where two images overlap, image 1 drawn through its planted
    homography reads like image 0 (both sample one texture), and less so
    through one moved by 1 px."""
    _, _, _, pool = rotating
    for scene in pool:
        im0, im1 = scene.images
        g = scenes.planted_globals(scene)
        blank0, blank1 = torch.zeros_like(im0), torch.zeros_like(im1)
        only0 = reference.panorama([im0, blank1], g)
        band = reference.edge_band(only0.shape[:2], [im0, im1], g)

        def mean_d(g1):
            only1 = reference.panorama([blank0, im1], [g[0], g1])
            hh = min(only0.shape[0], only1.shape[0])
            ww = min(only0.shape[1], only1.shape[1])
            a, b = only0[:hh, :ww], only1[:hh, :ww]
            both = a.ne(0).any(-1) & b.ne(0).any(-1) & ~band[:hh, :ww]
            assert int(both.sum()) > 1000
            d = (a.int() - b.int()).abs().amax(-1)[both]
            return float(d.float().mean())
        planted = mean_d(g[1])
        assert planted < 0.5 * mean_d(scenes.translation(1.0, 0.0) @ g[1])
        assert planted < 10


def test_rotating_pool_from_the_seed(rotating):
    model, cfg, traffic, pool = rotating
    again = SPEC.pool(traffic, cfg, SEED, "cpu")
    other = SPEC.pool(traffic, cfg, SEED + 1, "cpu")
    host = SPEC.pool(dict(traffic, resident="host"), cfg, SEED, "cpu")
    for a, b, c in zip(pool, again, host):
        assert all(torch.equal(x, y) for x, y in zip(a.images, b.images))
        assert all(np.array_equal(x.numpy(), y)
                   for x, y in zip(a.images, c.images))
        assert a.offsets is None
        assert all(x.dtype == torch.uint8 and x.shape == (
            cfg["image_h"], cfg["image_w"], 3) for x in a.images)

    def key(s):
        return scenes.planted_globals(s)[1].tobytes()
    assert sorted(map(key, pool)) == sorted(map(key, other))
    by_key = {key(s): s for s in other}
    for s in pool:
        assert not torch.equal(s.images[0], by_key[key(s)].images[0])


def test_rotating_poses_off_image_0s_hemisphere_are_refused(rotating):
    _, cfg, traffic, _ = rotating
    wide = dict(traffic, scenes=[[[0, 0, 0], [75, 0, 0]]])
    with pytest.raises(ValueError):
        SPEC.pool(wide, cfg, SEED, "cpu")


def test_judge_on_a_rotating_scene(rotating):
    _, _, _, pool = rotating
    limits = SPEC.limits(ROTATING["config"])
    truth = scenes.planted_globals(pool[0])
    ref = reference.panorama(pool[0].images, truth)
    good = reference.judge([{"scene": 0, "placed": truth,
                             "pano": ref.clone()}], pool, limits)
    assert good["failed"] == 0
    assert good["compared"]["h_err_px"]["value"] == 0
    assert good["compared"]["pixel_max_d"]["value"] == 0
    assert good["compared"]["canvas_px"]["value"] == 0
    moved = [truth[0], scenes.translation(1.0, 0.0) @ truth[1]]
    bad = reference.judge([{"scene": 0, "placed": moved, "pano": None}],
                          pool, limits)
    assert bad["failed"] == 1
    assert bad["compared"]["h_err_px"]["value"] >= 0.9


def test_footprint_of_a_rotated_image(rotating):
    """The roofline counts a warped image's pixels as its projected
    quadrilateral: h * w for a translation, more for the rotated pair's
    second image, whose far side is magnified."""
    _, cfg, _, pool = rotating
    h, w = cfg["image_h"], cfg["image_w"]
    assert roofline.quad_area(h, w, scenes.translation(37, -5)) == h * w
    for scene in pool:
        g = scenes.planted_globals(scene)
        area = roofline.quad_area(h, w, g[1])
        ch, cw = reference.canvas([(h, w)] * 2, g)
        assert h * w < area < ch * cw
        steps = roofline.panorama_steps([(h, w)] * 2, (ch, cw), 1024, 5,
                                        False, "adjacent", g)
        flat = roofline.panorama_steps([(h, w)] * 2, (ch, cw), 1024, 5,
                                       False)
        assert steps["warp_compose"] >= flat["warp_compose"]


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", REHEARSALS)
def test_rehearsal_cell_runs(name, trace, record_property):
    cell = next(c for c in READY if c["name"] == name)
    out = run_cell(SPEC, cell, SEED, 0.5, trace, cpu_devices(cell),
                   time.perf_counter(), overrides(name))
    record_property("correct", out["correct"])
    record_property("compared", json.dumps(out["compared"]))
    assert out["attempted"] > 0
    assert list(out)[-1] == "compared"
    assert set(out["compared"]) == {"h_err_px", "canvas_px", "pixel_max_d",
                                    "missing"}
    assert all(math.isfinite(v["value"]) for v in out["compared"].values())
    assert out["compared"]["missing"]["value"] == 0
    if trace:
        assert "breakdown" in out and out["device"]["window_s"] > 0
