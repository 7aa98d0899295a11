"""The pano_tpu_torch pair stitch as a whole vs the JAX package's pair
stitch on the CPU: the fused path (its Pallas kernels in interpret mode)
with every blend and gain, and the staged path with its stage lines."""

import dataclasses
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import pano_tpu  # noqa: E402
from pano_tpu import pipeline as JP  # noqa: E402
from pano_tpu.ops import warp as JW  # noqa: E402
import pano_tpu_torch  # noqa: E402
from pano_tpu_torch import config as TC  # noqa: E402
from pano_tpu_torch import pipeline as TP  # noqa: E402
from pano_tpu_torch import timer as TT  # noqa: E402

SMALL = dict(max_keypoints=512, num_iterations=500)
JAX_SMALL = pano_tpu.PanoConfig(
    harris=pano_tpu.HarrisOptions(max_keypoints=SMALL["max_keypoints"]),
    ransac=pano_tpu.RansacOptions(num_iterations=SMALL["num_iterations"]),
)
PORT_SMALL = TC.config_from_reference(JAX_SMALL)


def checkerboard_texture(h, w, seed=0):
    """tests/test_pipeline.py's texture: noise with bright 6x6 squares."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(max(60, h * w // 150)):
        y, x = r.integers(2, h - 10), r.integers(2, w - 10)
        img[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    return img


def translated_pair():
    base = checkerboard_texture(128, 160 + 48)
    return base[:, 48:].copy(), base[:, :160].copy()  # (left, right)


def projective_pair():
    """Right image = the base seen through a mild projective map."""
    base = checkerboard_texture(140, 230, seed=3)
    g = np.array([[1.0, 0.01, 0.0], [0.008, 1.0, 0.0], [3e-5, 1e-5, 1.0]])
    right = np.asarray(
        JW.warp_perspective_u8(jnp.asarray(base), jnp.asarray(g, jnp.float32),
                               128, 160)
    )
    return base[:128, 48:208].copy(), right


def jax_sampler(seed, n):
    def sample(n_valid):
        idx = jax.random.randint(
            jax.random.PRNGKey(seed), (n, 4), 0, max(int(n_valid), 1)
        )
        return torch.from_numpy(np.array(idx)).long()

    return sample


@pytest.fixture(scope="module")
def jax_stitcher():
    return JP.PairStitcher(JAX_SMALL, print_timing=False)


def port_stitcher():
    return TP.PairStitcher(
        PORT_SMALL, device="cpu",
        sampler=jax_sampler(PORT_SMALL.ransac.seed, SMALL["num_iterations"]),
    )


@pytest.mark.parametrize("pair", [translated_pair, projective_pair],
                         ids=["translation", "projective"])
def test_stitch_pair_fast_matches_jax_fused(jax_stitcher, pair):
    """Same panorama shape, warped right corners within 0.1 px, and
    (d > 3).mean() < 0.01 against the JAX fused path after its crop."""
    left, right = pair()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jax_stitcher.stitch_pair_fast(
                jnp.asarray(left), jnp.asarray(right), _assume_tpu=True
            )
        )
        # The estimate stitch_pair_fast just ran (its jit cache is warm).
        row_j = np.asarray(
            jax_stitcher._fused_estimate_src(jnp.asarray(left),
                                             jnp.asarray(right))[0]
        )
    st = port_stitcher()
    got = st.stitch_pair_fast(left, right)
    assert got is not None and got.dtype == torch.uint8
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    row_t = st.last_estimate
    assert row_t[11] > 0.5 and row_j[11] > 0.5
    cj = JW.warp_corners(row_j[:9].reshape(3, 3), *right.shape[:2])
    ct = JW.warp_corners(row_t[:9].reshape(3, 3), *right.shape[:2])
    assert np.abs(cj - ct).max() < 0.1, np.abs(cj - ct).max()
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


@pytest.mark.parametrize("pair", [translated_pair, projective_pair],
                         ids=["translation", "projective"])
def test_default_sampler_estimate_matches_jax(jax_stitcher, pair):
    """No injected sampler: the port's own table is JAX's, so its estimate
    is JAX's: the warped right corners within 0.1 px, the same inlier
    count, and the panorama within test_stitch_pair_fast_matches_jax_fused's
    bar."""
    left, right = pair()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_stitcher.stitch_pair_fast(
            jnp.asarray(left), jnp.asarray(right), _assume_tpu=True))
        row_j = np.asarray(jax_stitcher._fused_estimate_src(
            jnp.asarray(left), jnp.asarray(right))[0])
    st = TP.PairStitcher(PORT_SMALL, device="cpu")
    assert st.sampler is None
    got = st.stitch_pair_fast(left, right).numpy()
    row_t = st.last_estimate
    assert row_t[11] > 0.5 and row_j[11] > 0.5
    assert row_t[9] == row_j[9], (row_t[9], row_j[9])
    cj = JW.warp_corners(row_j[:9].reshape(3, 3), *right.shape[:2])
    ct = JW.warp_corners(row_t[:9].reshape(3, 3), *right.shape[:2])
    assert np.abs(cj - ct).max() < 0.1, np.abs(cj - ct).max()
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


def test_fused_geometry_places_left_like_the_jax_crop(jax_stitcher):
    """An exact translation: the port's exact canvas equals the JAX fused
    compose's padded canvas after its crop, pixel for pixel."""
    left, right = translated_pair()
    h = np.eye(3)
    h[0, 2] = -48.0
    row = np.zeros(14, np.float32)
    row[:9] = h.ravel()
    row[11] = 1.0
    geo = TP.fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
    assert (geo.canvas_h, geo.canvas_w) == (128, 208)
    assert (geo.ty, geo.tx) == (0, 48)
    st = jax_stitcher
    est = jnp.asarray(list(row[:11]) + [1.0, 100.0, 0.0], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        packed_out, canvas = st._fused_compose(0, 128, 160)(
            jnp.asarray(left), st._pack_src()(jnp.asarray(right)), est
        )
    status, want = JP.fast_path_crop(np.asarray(packed_out), canvas)
    assert status == "ok"
    got = TP.PairStitcher(PORT_SMALL, device="cpu")._compose(
        torch.from_numpy(left), torch.from_numpy(right), geo.m_inv, geo.ty,
        geo.tx, geo.window, geo.canvas_h, geo.canvas_w,
    )
    status, got = TP.fast_path_crop(geo.row, got)
    assert status == "ok"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_featureless_right_returns_none_with_message(jax_stitcher, capsys):
    left, _ = translated_pair()
    flat = np.zeros_like(left)
    with pltpu.force_tpu_interpret_mode():
        assert jax_stitcher.stitch_pair_fast(
            jnp.asarray(left), jnp.asarray(flat), _assume_tpu=True
        ) is None
    want = capsys.readouterr().err
    assert port_stitcher().stitch_pair_fast(left, flat) is None
    got = capsys.readouterr().err
    assert got == want == "Not enough matched corners for stitching!\n"


def test_failure_ladder_composites_best_effort_h():
    """Below the inlier gate without cv2: the best-effort H goes through
    the staged geometry (truncated translation), like the JAX ladder."""
    left, right = translated_pair()
    st = port_stitcher()
    row = np.zeros(14, np.float32)
    h = np.eye(3)
    h[0, 2] = -47.6
    row[:9] = h.ravel()
    row[9], row[11], row[12] = 5, 0.0, 7
    h_got = st.interpret_fused_row(row, lambda: (None, None, np.zeros(0)))
    np.testing.assert_allclose(h_got, h.astype(np.float32))
    pano = st.composite(left, right, h_got).numpy()
    want = np.asarray(
        JP.PairStitcher(JAX_SMALL, print_timing=False).composite(
            jnp.asarray(left), jnp.asarray(right), h_got
        )
    )
    assert pano.shape == want.shape
    d = np.abs(pano.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and (d != 0).mean() < 1e-3, (d.max(), (d != 0).mean())


def test_import_leaves_jax_out():
    """Every module of the package (the multi-image ones, ops.bundle and
    ops.mip, the CLI, io, eval and parallel.shard included) imports
    without jax or pano_tpu."""
    code = (
        "import importlib, pkgutil, sys, pano_tpu_torch; "
        "mods = [m.name for m in pkgutil.walk_packages("
        "pano_tpu_torch.__path__, 'pano_tpu_torch.')]; "
        "assert {'pano_tpu_torch.ops.bundle', 'pano_tpu_torch.ops.mip', "
        "'pano_tpu_torch.pipeline', 'pano_tpu_torch.cli', "
        "'pano_tpu_torch.io', 'pano_tpu_torch.eval', "
        "'pano_tpu_torch.parallel.shard'} <= set(mods), mods; "
        "[importlib.import_module(m) for m in mods]; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'pano_tpu' or m.startswith('pano_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_config_from_reference():
    assert TC.config_from_reference(pano_tpu.DEFAULT_CONFIG) == \
        pano_tpu_torch.DEFAULT_CONFIG
    assert PORT_SMALL.harris.max_keypoints == 512
    assert PORT_SMALL.ransac.num_iterations == 500
    assert PORT_SMALL == TC.PanoConfig(
        harris=TC.HarrisOptions(max_keypoints=512),
        ransac=TC.RansacOptions(num_iterations=500),
    )


def test_unported_options_raise():
    """Every blend, gain and the staged timing are ported; an unknown
    blend name raises ValueError, as in the JAX package."""
    for blend in ("overlay", "feather", "multiband"):
        cfg = PORT_SMALL.replace(stitch=TC.StitchOptions(
            blend=blend, gain_compensation=True))
        TP.PairStitcher(cfg, print_timing=True, device="cpu")
    cfg = PORT_SMALL.replace(stitch=TC.StitchOptions(blend="nope"))
    with pytest.raises(ValueError, match="unknown blend"):
        TP.PairStitcher(cfg, device="cpu")


# --- every blend and gain through the fused path ----------------------------

CONFIGS = [("feather", False), ("multiband", False), ("overlay", True),
           ("feather", True)]
CONFIG_IDS = ["feather", "multiband", "overlay+gain", "feather+gain"]


def _configs(blend, gain):
    jc = JAX_SMALL.replace(stitch=dataclasses.replace(
        JAX_SMALL.stitch, blend=blend, gain_compensation=gain))
    return jc, TC.config_from_reference(jc)


def _port_stitcher(cfg, **kw):
    return TP.PairStitcher(
        cfg, device="cpu",
        sampler=jax_sampler(cfg.ransac.seed, SMALL["num_iterations"]), **kw,
    )


@pytest.fixture(scope="module")
def jax_blend_stitchers(jax_stitcher):
    """One JAX stitcher per configuration, kept for the module so that the
    pairs (all of one shape) share its compiled compose graphs. They share
    jax_stitcher's estimate graph too: off the TPU no stitch option
    reaches it (``_src_pack_mode`` is None)."""
    out = {}
    for blend, gain in CONFIGS:
        st = JP.PairStitcher(_configs(blend, gain)[0], print_timing=False)
        st._fused_estimate_src = jax_stitcher._fused_estimate_src
        out[blend, gain] = st
    return out


def _diff(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got.astype(int) - want.astype(int)).max(-1)


def _bar(d, blend):
    """Feather and gain: (d > 3) on < 1 %; multiband: (d > 10) on < 2 %
    (the JAX package's own fused-vs-staged bar, tests/test_pipeline.py:
    511-513: the pyramids see another window)."""
    if blend == "multiband":
        assert (d > 10).mean() < 0.02, (d.max(), (d > 10).mean())
    else:
        assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


@pytest.mark.parametrize("pair", [translated_pair, projective_pair],
                         ids=["translation", "projective"])
@pytest.mark.parametrize("blend,gain", CONFIGS, ids=CONFIG_IDS)
def test_blends_match_jax_fused(jax_blend_stitchers, blend, gain, pair):
    """Port stitch_pair_fast vs JAX stitch_pair_fast(_assume_tpu=True):
    same panorama shape, pixels within the bar."""
    left, right = pair()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_blend_stitchers[blend, gain].stitch_pair_fast(
            jnp.asarray(left), jnp.asarray(right), _assume_tpu=True))
    got = _port_stitcher(_configs(blend, gain)[1]).stitch_pair_fast(
        left, right)
    assert got is not None and got.dtype == torch.uint8
    _bar(_diff(got.numpy(), want), blend)


def test_gain_engages_like_jax_fused_compose(jax_blend_stitchers):
    """An exposure offset (right x 1.25) under an exact homography: the
    fused compose of both packages scales the right image by the same
    gain (the right-only columns come out darker than the input)."""
    left, right = translated_pair()
    right = np.clip(right.astype(np.int32) * 1.25, 0, 255).astype(np.uint8)
    h = np.eye(3)
    h[0, 2] = -48.0
    row = np.zeros(14, np.float32)
    row[:9] = h.ravel()
    row[9:13] = 100.0, 100.0, 1.0, 100.0
    st = jax_blend_stitchers["feather", True]
    with pltpu.force_tpu_interpret_mode():
        packed_out, canvas = st._fused_compose(0, 128, 160)(
            jnp.asarray(left), st._pack_src()(jnp.asarray(right)),
            jnp.asarray(row))
    status, want = JP.fast_path_crop(np.asarray(packed_out), canvas)
    assert status == "ok"
    port = _port_stitcher(_configs("feather", True)[1])
    geo = TP.fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
    got = port._compose(torch.from_numpy(left), torch.from_numpy(right),
                        geo.m_inv, geo.ty, geo.tx, geo.window, geo.canvas_h,
                        geo.canvas_w).numpy()
    _bar(_diff(got, np.asarray(want)), "feather")
    assert got[:, :40].mean() < right[:, :40].mean() - 5


def test_multiband_keeps_true_black_content(jax_blend_stitchers):
    """tests/test_pipeline.py:229-284's scenario: true-black content only
    in the right image, where it is the deeper feather side, blends to
    (0, 0, 0) inside covered area. The paste must keep it black (covered
    black is nudged to B=1), not show the bright left base through."""
    left, right = translated_pair()
    right = right.copy()
    right[40:80, 56:80] = 0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_blend_stitchers["multiband", False]
                          .stitch_pair_fast(jnp.asarray(left),
                                            jnp.asarray(right),
                                            _assume_tpu=True))
    got = _port_stitcher(_configs("multiband", False)[1]).stitch_pair_fast(
        left, right).numpy()
    # The two estimates differ by ulps here, and the canvas is ceil() of
    # the warped extent: it may take one more column on one side.
    assert all(abs(a - b) <= 1 for a, b in zip(got.shape, want.shape))
    hh, ww = min(got.shape[0], want.shape[0]), min(got.shape[1], want.shape[1])
    got, want = got[:hh, :ww], want[:hh, :ww]
    d = _diff(got, want)
    mask = np.zeros(want.shape[:2], bool)
    mask[42:78, 58:78] = True
    mask &= want.max(-1) <= 1
    assert mask.sum() > 200, mask.sum()  # the scenario actually happened
    assert got[mask].max() <= 10, (got[mask].max(-1) > 10).sum()
    _bar(d, "multiband")


FRINGE_DX, FRINGE_DY = 48, 8


def fringe_pair():
    """A 128x160 pair cut from one scene, the right image at (48, 8) in
    the left's frame: chip_smoke.py's layout, scaled down."""
    base = checkerboard_texture(128 + FRINGE_DY, 160 + FRINGE_DX, seed=5)
    return (base[:128, :160].copy(),
            base[FRINGE_DY:FRINGE_DY + 128, FRINGE_DX:FRINGE_DX + 160].copy())


@pytest.mark.parametrize("eps", [(-0.003, 0.0), (0.0, -0.003),
                                 (-0.003, -0.003)], ids=["x", "y", "xy"])
def test_multiband_fringe_round_trips_like_jax(jax_blend_stitchers, eps):
    """An H a few thousandths of a pixel off the planted translation, as a
    RANSAC estimate is: the right image's edge gets a sub-pixel fringe
    (under half a tap on the image, sampled to black). The JAX fused
    compose (the TPU route, 7-bit alpha) weighs it 0 and gives the left
    image back over the overlap within 1; so does the port, whose K4b
    weight is rounded to the same 7 bits (an unrounded sliver of weight
    put the black fringe into the pyramid: up to 8 off)."""
    left, right = fringe_pair()
    row = np.zeros(14, np.float32)
    row[:9] = [1, 0, FRINGE_DX + eps[0], 0, 1, FRINGE_DY + eps[1], 0, 0, 1]
    row[9:13] = 100.0, 100.0, 1.0, 100.0
    st = jax_blend_stitchers["multiband", False]
    with pltpu.force_tpu_interpret_mode():
        packed_out, canvas = st._fused_compose(0, 128, 160)(
            jnp.asarray(left), st._pack_src()(jnp.asarray(right)),
            jnp.asarray(row))
    status, want = JP.fast_path_crop(np.asarray(packed_out), canvas)
    assert status == "ok"
    want = np.asarray(want)
    geo = TP.fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
    got = _port_stitcher(_configs("multiband", False)[1])._compose(
        torch.from_numpy(left), torch.from_numpy(right), geo.m_inv, geo.ty,
        geo.tx, geo.window, geo.canvas_h, geo.canvas_w).numpy()
    overlap = np.s_[FRINGE_DY:128, FRINGE_DX:160]
    for name, pano in (("jax", want), ("port", got)):
        d = _diff(pano[overlap], left[overlap])
        assert d.max() <= 1, (name, d.max(), np.argwhere(d > 1)[:4])
    _bar(_diff(got, want), "multiband")


# --- the staged path ---------------------------------------------------------

STAGES = ("Harris Corner Detection", "Harris Corner Matching",
          "RANSAC Homography Estimation", "Image Stitching")


def test_staged_stitch_pair_prints_stage_lines(capsys):
    """print_timing=True: the four stage lines in the reference's format
    (tests/test_pipeline.py:354-360's regex), and the staged panorama
    within the bar of JAX's staged stitch_pair (same f64 geometry)."""
    left, right = translated_pair()
    jc, tc = _configs("feather", False)
    got = _port_stitcher(tc, print_timing=True).stitch_pair(left, right)
    out = capsys.readouterr().out
    for label in STAGES:
        assert re.search(rf"^{label}: \d+\.\d{{3}} ms$", out, re.M), label
    assert [line.split(":")[0] for line in out.splitlines()] == [
        STAGES[0], STAGES[0], *STAGES[1:]]
    want = np.asarray(JP.PairStitcher(jc, print_timing=False).stitch_pair(
        jnp.asarray(left), jnp.asarray(right)))
    _bar(_diff(got.numpy(), want), "feather")


def test_default_stitchers_print_the_same_stage_labels(capsys):
    """Both packages' PairStitcher with default arguments (the port on the
    CPU) print the reference's stage lines from stitch_pair, with the
    same labels in the same order."""
    left, right = translated_pair()
    JP.PairStitcher(JAX_SMALL).stitch_pair(jnp.asarray(left),
                                           jnp.asarray(right))
    want = capsys.readouterr().out
    TP.PairStitcher(PORT_SMALL, device="cpu").stitch_pair(left, right)
    got = capsys.readouterr().out

    def labels(out):
        lines = out.splitlines()
        assert all(re.fullmatch(r".+: \d+\.\d{3} ms", x) for x in lines), out
        return [x.rsplit(": ", 1)[0] for x in lines]

    assert labels(got) == labels(want) == [STAGES[0], STAGES[0],
                                           *STAGES[1:]]


def test_timing_tag_suffixes_stage_lines(capsys):
    """timing_tag suffixes each label as the reference's per-implementation
    mains do; without print_timing a stage prints nothing."""
    left, _ = translated_pair()
    img = torch.from_numpy(left)
    TP.PairStitcher(PORT_SMALL, True, "GPU", device="cpu").detect(img)
    TP.PairStitcher(PORT_SMALL, False, "GPU", device="cpu").detect(img)
    assert re.fullmatch(r"Harris Corner Detection \(GPU\): \d+\.\d{3} ms\n",
                        capsys.readouterr().out)


def test_print_stage_format(capsys):
    """The reference's line: fixed point, three decimals, rounded."""
    TT.print_stage("Saving panorama", 1.23456)
    TT.print_stage("Image Stitching", 1234.0)
    assert capsys.readouterr().out == (
        "Saving panorama: 1.235 ms\nImage Stitching: 1234.000 ms\n")
