"""The pano_tpu_torch pair stitch as a whole vs the JAX package's fused
pair stitch (its warp kernel in interpret mode), on the CPU."""

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
    code = (
        "import sys, pano_tpu_torch, pano_tpu_torch.pipeline; "
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
    cfg = PORT_SMALL.replace(
        stitch=TC.StitchOptions(blend="feather")
    )
    with pytest.raises(NotImplementedError):
        TP.PairStitcher(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        TP.PairStitcher(PORT_SMALL, print_timing=True, device="cpu")
