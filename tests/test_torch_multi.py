"""pano_tpu_torch multi-image modes vs the JAX package on the CPU: the
chain step (blend_window_outputs in chain mode, with gain), the mip
source and level, the global canvas and composite, the spanning tree and
bundle gate, and the fold, chain and auto modes as a whole with RANSAC's
sample table injected.

Which JAX route the composite is held to: off the TPU, JAX's
composite_global warps with XLA and feathers against the canvas
rectangle's ramp; its TPU route feathers against the accumulated weight
canvas, which is what the port does. So overlay (which reads no weight)
is held to the whole JAX function, and feather, multiband and gain to the
TPU route built step by step from JAX's blend_window_outputs in chain
mode, fed with the port's own windowed warp."""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import pano_tpu  # noqa: E402
from pano_tpu import pipeline as JP  # noqa: E402
from pano_tpu.ops import pallas_warp as PW  # noqa: E402
from pano_tpu.ops import warp as JW  # noqa: E402
from pano_tpu_torch import config as TC  # noqa: E402
from pano_tpu_torch import pipeline as TP  # noqa: E402
from pano_tpu_torch.ops import cuda_warp  # noqa: E402
from pano_tpu_torch.ops import mip as TM  # noqa: E402
from pano_tpu_torch.ops import warp as TW  # noqa: E402

JAX_SMALL = pano_tpu.PanoConfig(
    harris=pano_tpu.HarrisOptions(max_keypoints=512),
    ransac=pano_tpu.RansacOptions(num_iterations=500),
)

CONFIGS = [("overlay", False), ("feather", False), ("multiband", False),
           ("overlay", True), ("feather", True), ("multiband", True)]
CONFIG_IDS = ["overlay", "feather", "multiband", "overlay+gain",
              "feather+gain", "multiband+gain"]


def _configs(blend="overlay", gain=False):
    jc = JAX_SMALL.replace(stitch=dataclasses.replace(
        JAX_SMALL.stitch, blend=blend, gain_compensation=gain))
    return jc, TC.config_from_reference(jc)


def checkerboard_texture(h, w, seed=0):
    """tests/test_pipeline.py's texture: noise with bright 6x6 squares."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(max(60, h * w // 150)):
        y, x = r.integers(2, h - 10), r.integers(2, w - 10)
        img[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    return img


def jax_sampler(seed=0, n=500):
    """RANSAC's JAX sample table (the same for every pair of a run)."""
    def sample(n_valid):
        idx = jax.random.randint(
            jax.random.PRNGKey(seed), (n, 4), 0, max(int(n_valid), 1)
        )
        return torch.from_numpy(np.array(idx)).long()

    return sample


SAMPLER = jax_sampler()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pack(rgb: np.ndarray) -> np.ndarray:
    """(h, w, 3) u8 -> JAX's packed (h, w) int32 B | G << 8 | R << 16."""
    p = rgb.astype(np.int32)
    return p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)


def _check_blend(got, want, blend, win_px):
    """Overlay exact; feather within 1 (f32 rounding at .5); multiband
    |d| > 1 on < 0.5 % of the window (the seam mask flips at exact ties
    of the two weights, where XLA multiplies by a reciprocal)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    if blend == "overlay":
        assert d.max() == 0, (d.max(), (d != 0).sum())
    elif blend == "feather":
        assert d.max() <= 1, d.max()
    else:
        assert (d > 1).sum() < 5e-3 * win_px, (d > 1).sum()


# --- the chain step: blend_window_outputs in chain mode, and gain -----------


@pytest.mark.parametrize("blend,gain", CONFIGS, ids=CONFIG_IDS)
def test_blend_window_outputs_chain_matches_jax(blend, gain):
    """A canvas-sized left with the accumulated weight over an unaligned
    window (16-multiple sides, as JAX's pyramid needs): the same canvas
    and the same merged weight max(w_left_win, w_win). The window is the
    canvas's pixels darkened by 0.8 with black holes, so gain engages
    (g ~ 1.25)."""
    rng = np.random.default_rng(11)
    out_h, out_w = 150, 230
    wy0, wx0, win_h, win_w = 13, 37, 112, 176
    canvas = rng.integers(0, 256, (out_h, out_w, 3), dtype=np.uint8)
    wcan = np.where(rng.random((out_h, out_w)) < 0.3, 0.0,
                    rng.random((out_h, out_w))).astype(np.float32)
    win = canvas[wy0:wy0 + win_h, wx0:wx0 + win_w]
    rgb = np.round(win * 0.8).astype(np.uint8)
    hole = rng.random((win_h, win_w)) < 0.2
    rgb[hole] = 0
    w = np.where(hole, 0.0, rng.random((win_h, win_w))).astype(np.float32)
    s = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    w_left = wcan[wy0:wy0 + win_h, wx0:wx0 + win_w]
    want, want_w = JW.blend_window_outputs(
        jnp.asarray(canvas), jnp.asarray(_pack(rgb)), jnp.asarray(w), s(0),
        s(0), s(wx0), s(wy0), out_h, out_w, win_h, win_w, blend,
        w_left_win=jnp.asarray(w_left), gain=gain,
    )
    got_canvas = _t(canvas).clone()
    got, got_w = TW.blend_window_outputs(
        got_canvas, _t(rgb), _t(w), 0, 0, wx0, wy0, out_h, out_w, blend,
        w_left_win=_t(w_left), gain=gain,
    )
    assert got is got_canvas  # chain mode updates the canvas in place
    _check_blend(got.numpy(), np.asarray(want), blend, win_h * win_w)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    if gain and blend != "multiband":
        # The warped pixels came out brighter than they went in.
        got_win = got.numpy()[wy0:wy0 + win_h, wx0:wx0 + win_w]
        only_r = (w > 0) & (w_left <= 0)
        assert got_win[only_r].mean() > rgb[only_r].mean() + 10


def test_blend_window_outputs_chain_mode_wants_the_canvas():
    img = torch.zeros((8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="chain mode"):
        TW.blend_window_outputs(img, img[:4, :4], torch.zeros(4, 4), 0, 0, 0,
                                0, 8, 9, "overlay",
                                w_left_win=torch.zeros(4, 4))


# --- the mip source and level ---------------------------------------------


@pytest.mark.parametrize("shape,lvl", [((101, 77), 1), ((101, 77), 2),
                                       ((64, 96), 2), ((33, 50), 1)])
def test_downsample_pow2_exact(shape, lvl):
    """Round-half-up 2x2 box means, odd rows and columns cropped."""
    img = np.random.default_rng(5).integers(0, 256, shape + (3,),
                                            dtype=np.uint8)
    want = np.asarray(JW.downsample_pow2(jnp.asarray(img), lvl))
    got = TW.downsample_pow2(_t(img), lvl)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_mip_m_inv_exact():
    m = np.array([[0.98, 0.01, 310.5], [-0.02, 1.01, -22.25],
                  [1e-5, 2e-5, 1.0]])
    for lvl in range(3):
        np.testing.assert_array_equal(TM.mip_m_inv(m, lvl),
                                      PW.mip_m_inv(m, lvl))
    assert (TM.MAX_MIP, TM.SCALE_MAX, TM.TH, TM.TW) == (
        PW.MAX_MIP, PW.SCALE_MAX, PW.TH, PW.TW)


@pytest.mark.parametrize("s,lvl", [(1.0, 0), (2.0, 1), (4.0, 2), (8.0, None)])
def test_pick_mip_level_on_scalings(s, lvl):
    """tests/test_pallas_warp.py:156-165's pure minifications."""
    m_inv = np.diag([s, s, 1.0])
    assert TM.pick_mip_level(m_inv, 256, 256) == lvl
    assert PW.pick_mip_level(m_inv, 256, 256) == lvl


@pytest.mark.parametrize("g,jax_lvl", [
    (np.array([[1.0, 0.0, 1400.0], [0.0, 1.0, 37.0], [0.0, 0.0, 1.0]]), 0),
    (np.array([[1.02, 0.0, 2800.0], [0.004, 0.99, 15.0], [2e-6, 0.0, 1.0]]),
     0),
    (np.array([[0.98, 0.01, 310.5], [-0.02, 1.01, 22.25], [1e-5, 2e-5, 1.0]]),
     None),
], ids=["translation", "scaled", "tilted"])
def test_pick_mip_level_on_chain_maps(g, jax_lvl):
    """Near-identity chain maps over their exact 4156x3117 windows: level
    0 in the port. JAX agrees inside its TPU warp's envelope; the tilted
    map (row tilt 0.02) is outside it, where JAX warps at full resolution
    with XLA (None), which the port's level 0 is."""
    m_inv = np.linalg.inv(g)
    wy0, wx0, wy1, wx1 = TW.warp_window(TW.warp_corners(g, 3117, 4156),
                                        3300, 8400)
    args = (m_inv, wy1 - wy0, wx1 - wx0, wx0, wy0)
    assert TM.pick_mip_level(*args) == 0
    assert PW.pick_mip_level(*args) == jax_lvl


# --- global canvas and composite -------------------------------------------

# A 128-row strip of four images at integer offsets; the middle windows
# are 160 wide (156 + the 2-px margin each side) and the last is cut by
# the canvas edge at 158 + 2, so every window is a 16-multiple.
STRIP_X = (0, 120, 220)
STRIP_W = (160, 156, 158)


def strip(seed=11, gain=1.0):
    base = checkerboard_texture(128, STRIP_X[-1] + STRIP_W[-1], seed)
    imgs = [base[:, x:x + w].copy() for x, w in zip(STRIP_X, STRIP_W)]
    if gain != 1.0:  # the middle image's exposure is off
        imgs[1] = np.clip(imgs[1] * gain, 0, 255).astype(np.uint8)
    globals_h = []
    for x in STRIP_X:
        g = np.eye(3)
        g[0, 2] = x
        globals_h.append(g)
    return base, imgs, globals_h


@pytest.mark.parametrize("anchor", [0, 1])
def test_global_canvas_geometry_matches_jax(anchor):
    _, imgs, gs = strip()
    gs = [np.linalg.inv(gs[anchor]) @ g for g in gs]
    gs[2] = gs[2] @ np.array([[0.99, 0.02, 0.5], [-0.01, 1.0, 3.25],
                              [1e-5, -2e-5, 1.0]])
    t_mat, ch, cw = TP.global_canvas_geometry(imgs, gs, anchor)
    want = JP.global_canvas_geometry(imgs, gs, anchor, 128)
    np.testing.assert_array_equal(t_mat, want[0])
    assert (ch, cw) == want[1:3]


def _port_composite(imgs, gs, cfg, anchor=0):
    weights = []
    pano = TP.composite_global(imgs, [_t(i) for i in imgs], gs, cfg,
                               anchor=anchor, _weights_out=weights)
    return pano, weights[0]


@pytest.mark.parametrize("shift", [0.0, 0.5], ids=["integer", "subpixel"])
def test_composite_global_overlay_matches_jax(shift):
    """Overlay reads no weight: the whole JAX composite_global is the
    oracle. Integer translations: exact; a half-pixel one rounds within 1
    on < 0.1 % of the canvas."""
    _, imgs, gs = strip()
    gs[1][0, 2] += shift
    jc, tc = _configs("overlay")
    want = JP.composite_global(imgs, [jnp.asarray(i) for i in imgs], gs, jc)
    got, _ = _port_composite(imgs, gs, tc)
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= (0 if shift == 0 else 1), d.max()
    assert (d != 0).mean() < 1e-3


def jax_tpu_route(imgs, gs, blend, gain, anchor=0):
    """The JAX TPU route's composite, step by step: the anchor and its
    ramp, then per image JAX's blend_window_outputs in chain mode against
    the weight canvas, fed with the port's windowed warp (K4b's plain
    version) packed to int32, and the merged weight written back."""
    t_mat, ch, cw = JP.global_canvas_geometry(imgs, gs, anchor, 128)[:3]
    # The anchor at the nearest pixel, as the port places it: the JAX
    # package truncates, which puts an anchor that is not the canvas's
    # top-left image a pixel off its neighbours when the extent falls a
    # hair short of an integer (a recorded difference, ROADMAP E; JAX's
    # side is the wrong one).
    ty0, tx0 = int(np.round(t_mat[1, 2])), int(np.round(t_mat[0, 2]))
    s = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    canvas = lax.dynamic_update_slice(
        jnp.zeros((ch, cw, 3), jnp.uint8), jnp.asarray(imgs[anchor]),
        (s(ty0), s(tx0), s(0)))
    wcan = lax.dynamic_update_slice(
        jnp.zeros((ch, cw), jnp.float32), JW._edge_ramp(*imgs[anchor].shape[:2]),
        (s(ty0), s(tx0)))
    for i, g in enumerate(gs):
        if i == anchor:
            continue
        m = t_mat @ g
        hr, wr = imgs[i].shape[:2]
        wy0, wx0, wy1, wx1 = TW.warp_window(JW.warp_corners(m, hr, wr), ch, cw)
        rgb, w = cuda_warp.warp_packed(_t(imgs[i]), np.linalg.inv(m),
                                       (wy0, wx0, wy1, wx1),
                                       has_alpha=blend != "overlay")
        win_h, win_w = wy1 - wy0, wx1 - wx0
        canvas, new_w = JW.blend_window_outputs(
            canvas, jnp.asarray(_pack(rgb.numpy())), jnp.asarray(w.numpy()),
            s(0), s(0), s(wx0), s(wy0), ch, cw, win_h, win_w, blend,
            w_left_win=lax.dynamic_slice(wcan, (s(wy0), s(wx0)),
                                         (win_h, win_w)),
            gain=gain,
        )
        wcan = lax.dynamic_update_slice(wcan, new_w, (s(wy0), s(wx0)))
    return np.asarray(canvas), np.asarray(wcan)


@pytest.mark.parametrize("blend,gain", CONFIGS, ids=CONFIG_IDS)
def test_composite_global_matches_jax_tpu_route(blend, gain):
    """Every blend and gain against the step-by-step TPU route, with the
    middle image's exposure x1.3 (gain engages): canvas within the blend's
    bar, the weight canvas (through _weights_out) equal, and every
    image's region covered (tests/test_pipeline.py:363-401)."""
    base, imgs, gs = strip(gain=1.3)
    want, want_w = jax_tpu_route(imgs, gs, blend, gain)
    got, got_w = _port_composite(imgs, gs, _configs(blend, gain)[1])
    _check_blend(got, want, blend, got.shape[0] * got.shape[1])
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6, atol=0)
    assert got_w[64, 80] > 0 and got_w[64, 250] > 0 and got_w[64, 370] > 0
    assert got_w.min() > 0
    # Where image 2 alone covers the canvas (x in [160, 220)), gain pulls
    # its exposure back to the scene's; without gain it stays x1.3.
    err = abs(got[:, 165:215].mean() - base[:, 165:215].mean())
    off = abs(imgs[1][:, 45:95].mean() - base[:, 165:215].mean())
    assert (err < off / 3) == gain, (err, off)


def test_composite_global_weight_ramp_of_the_anchor():
    """The weight canvas starts as the anchor's ramp, not masked by black
    anchor pixels; an image placed off the anchor rectangle adds its own
    weight (the in-bounds weight for overlay)."""
    _, imgs, gs = strip()
    imgs[0] = imgs[0].copy()
    imgs[0][10:20, 10:20] = 0
    _, w = _port_composite(imgs, gs, _configs("overlay")[1])
    ramp = TW._edge_ramp(128, 160).numpy()
    np.testing.assert_array_equal(w[:, :118], ramp[:, :118])
    np.testing.assert_array_equal(w[:, 300:], 1.0)


# --- spanning tree and bundle gate -----------------------------------------


def _graph():
    """Four images, 30-px steps with a little scale and perspective, the
    chain edges plus a cycle-closing (0, 3); edge (1, 2) is off by a few
    pixels so the globals drift and the refinement has work."""
    r = np.random.default_rng(0)
    gt = [np.eye(3)]
    for _ in range(3):
        step = np.eye(3)
        step[0, 2], step[1, 2] = 30.0 + r.uniform(-3, 3), r.uniform(-4, 4)
        step[:2, :2] *= 1.0 + r.uniform(-0.01, 0.01)
        step[2, 0] = r.uniform(-1e-5, 1e-5)
        gt.append(gt[-1] @ step)
    h_edge = {(i, i + 1): np.linalg.inv(gt[i]) @ gt[i + 1] for i in range(3)}
    h_edge[(0, 3)] = np.linalg.inv(gt[0]) @ gt[3]
    off = np.eye(3)
    off[0, 2], off[1, 2] = 4.0, -3.0
    h_edge[(1, 2)] = h_edge[(1, 2)] @ off
    counts = np.zeros((4, 4), np.int64)
    for (i, j), c in zip(h_edge, (120, 90, 150, 60)):
        counts[i, j] = counts[j, i] = c
    return counts, h_edge


@pytest.mark.parametrize("anchor", ["auto", "first"])
def test_max_spanning_tree_globals_matches_jax(anchor):
    counts, h_edge = _graph()
    want, root_j = JP.max_spanning_tree_globals(counts, h_edge, 4, anchor)
    got, root_t = TP.max_spanning_tree_globals(counts, h_edge, 4, anchor)
    assert root_t == root_j == (2 if anchor == "auto" else 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["off", "auto", "on"])
def test_maybe_refine_globals_matches_jax(mode, capsys):
    """The gate's decision, the refined globals and the message, letter
    for letter."""
    counts, h_edge = _graph()
    gs, root = JP.max_spanning_tree_globals(counts, h_edge, 4)
    imgs = [np.zeros((96, 128, 3), np.uint8)] * 4
    jc = JAX_SMALL.replace(stitch=dataclasses.replace(
        JAX_SMALL.stitch, bundle_adjust=mode))
    want = JP.maybe_refine_globals(gs, counts, h_edge, root, imgs, jc)
    out_j = capsys.readouterr().out
    got = TP.maybe_refine_globals(gs, counts, h_edge, root, imgs,
                                  TC.config_from_reference(jc))
    out_t = capsys.readouterr().out
    assert out_t == out_j
    assert (got is gs) == (want is gs) == (mode == "off")
    assert out_t.startswith("Bundle refinement: rms ") == (mode != "off")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if mode == "auto":  # a tree (no cycle-closing edge) is left alone
        tree = {k: v for k, v in h_edge.items() if k != (0, 3)}
        assert TP.maybe_refine_globals(gs, counts, tree, root, imgs,
                                       TC.config_from_reference(jc)) is gs


# --- the modes as a whole, against JAX -------------------------------------

TIME = re.compile(r"\d+\.\d{3} ms$", re.M)


def _run_both(capsys, imgs, blend="overlay", **kw):
    """JAX stitch_all_images and the port's (device cpu, JAX's samples):
    (want, got, JAX stdout, port stdout, JAX stderr, port stderr), the
    stage times blanked."""
    jc, tc = _configs(blend)
    want = JP.stitch_all_images(imgs, jc, **kw)
    oj = capsys.readouterr()
    got = TP.stitch_all_images(imgs, tc, device="cpu", sampler=SAMPLER, **kw)
    ot = capsys.readouterr()
    return (want, got, TIME.sub("X ms", oj.out), TIME.sub("X ms", ot.out),
            oj.err, ot.err)


def _pano_bar(got, want):
    """The canvas within a row and column (the estimates differ by ulps
    under ceil), and (d > 3) on < 1 % of the shared pixels."""
    assert got is not None and want is not None
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert all(abs(a - b) <= 1 for a, b in zip(got.shape, want.shape)), \
        (got.shape, want.shape)
    h, w = min(got.shape[0], want.shape[0]), min(got.shape[1], want.shape[1])
    d = np.abs(got[:h, :w].astype(int) - want[:h, :w].astype(int)).max(-1)
    assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


def three_strip(seed=2):
    """tests/test_pipeline.py:95-127's strip: 50 % overlaps."""
    base = checkerboard_texture(128, 280, seed)
    return base, [base[:, 0:140].copy(), base[:, 70:210].copy(),
                  base[:, 140:280].copy()]


@pytest.mark.parametrize("mode", ["fold", "chain"])
def test_mode_matches_jax(mode, capsys):
    base, imgs = three_strip()
    want, got, oj, ot, _, _ = _run_both(capsys, imgs, print_timing=True,
                                        mode=mode)
    _pano_bar(got, want)
    assert ot == oj
    lines = ["Stitching image 2 of 3...", "Stitching image 3 of 3...",
             "Total Stitching Process: X ms"]
    if mode == "fold":  # the staged pairs' stage lines
        stages = ["Harris Corner Detection: X ms"] * 2 + [
            "Harris Corner Matching: X ms", "RANSAC Homography Estimation: X ms",
            "Image Stitching: X ms"]
        lines = [lines[0], *stages, lines[1], *stages, lines[2]]
    assert ot.splitlines() == lines
    d = np.abs(got[:128, :270].astype(int) - base[:, :270].astype(int))
    assert (d.max(-1) > 30).mean() < 0.08


def test_chain_skips_failed_middle_image(capsys):
    """tests/test_pipeline.py:130-137: a featureless middle image fails,
    and image 3 is re-estimated against image 1, as in JAX."""
    base = checkerboard_texture(128, 220, seed=3)
    imgs = [base[:, 0:140].copy(), np.zeros((128, 140, 3), np.uint8),
            base[:, 80:220].copy()]
    want, got, oj, ot, ej, et = _run_both(capsys, imgs, print_timing=False,
                                          mode="chain")
    _pano_bar(got, want)
    assert got.shape[1] >= 210
    assert et == ej == "Not enough matched corners for stitching!\n" \
        "Failed to stitch image 1!\n"
    assert ot == oj


def test_auto_shuffled_matches_jax(capsys):
    """tests/test_pipeline.py:140-155: shuffled input, the middle image
    is the root; the same ordering line and panorama as JAX."""
    base, (a, b, c) = three_strip(seed=4)
    imgs = [c, a, b]
    want, got, oj, ot, _, _ = _run_both(capsys, imgs, print_timing=False,
                                        mode="auto")
    _pano_bar(got, want)
    assert ot == oj
    assert ot.startswith("Auto-ordering: root image 3, placed 3 of 3\n")


def test_fold_total_prints_pair_lines(capsys):
    """timing='total': the single-sync pair per step, an "Image
    Stitching" line each and the total; the panorama is the staged
    fold's within the bar."""
    _, imgs = three_strip()
    _, tc = _configs()
    staged = TP.stitch_all_images(imgs, tc, print_timing=False, device="cpu",
                                  sampler=SAMPLER)
    # The step lines print whatever print_timing says, as in JAX.
    assert capsys.readouterr().out == \
        "Stitching image 2 of 3...\nStitching image 3 of 3...\n"
    got = TP.stitch_all_images(imgs, tc, print_timing=True, device="cpu",
                               timing="total", sampler=SAMPLER,
                               timing_tag="GPU")
    out = TIME.sub("X ms", capsys.readouterr().out).splitlines()
    assert out == ["Stitching image 2 of 3...", "Image Stitching (GPU): X ms",
                   "Stitching image 3 of 3...", "Image Stitching (GPU): X ms",
                   "Total Stitching Process (GPU): X ms"]
    _pano_bar(got, staged)


@pytest.mark.parametrize("mode,rows", [("chain", (2, 14)), ("auto", (3, 11)),
                                       ("fold", None)])
def test_one_host_copy_for_all_estimates(monkeypatch, mode, rows):
    """Chain fetches its n-1 estimate rows with one _host_fetch, auto its
    n(n-1)/2 pair rows, the fold none (tests/test_pipeline.py:404-423
    counts one); the panorama is the one fetch_image, in every mode."""
    _, imgs = three_strip()
    seen = {"_host_fetch": [], "fetch_image": []}
    for name, shapes in seen.items():
        real = getattr(TP, name)
        monkeypatch.setattr(TP, name, lambda t, real=real, shapes=shapes: (
            shapes.append(tuple(t.shape)), real(t))[1])
    pano = TP.stitch_all_images(imgs, _configs()[1], print_timing=False,
                                device="cpu", mode=mode, sampler=SAMPLER)
    assert seen["_host_fetch"] == ([rows] if rows else [])
    assert seen["fetch_image"] == [pano.shape]


def test_no_connected_pairs_and_unknown_mode(capsys):
    imgs = [np.zeros((64, 80, 3), np.uint8)] * 2
    assert TP.stitch_all_images(imgs, _configs()[1], device="cpu",
                                mode="auto") is None
    assert capsys.readouterr().err == "No connected image pairs!\n"
    assert TP.stitch_all_images([], _configs()[1], device="cpu") is None
    with pytest.raises(ValueError, match="unknown mode"):
        TP.stitch_all_images(imgs, _configs()[1], device="cpu", mode="x")


def test_get_pair_stitcher_is_memoized():
    _, tc = _configs()
    a = TP.get_pair_stitcher(tc, False, "", "cpu", SAMPLER)
    assert TP.get_pair_stitcher(tc, False, "", "cpu", SAMPLER) is a
    assert TP.get_pair_stitcher(tc, True, "", "cpu", SAMPLER) is not a
    assert a.sampler is SAMPLER and a.device == torch.device("cpu")
