"""pano_tpu_torch fused warp + overlay (K4a's plain version) vs the JAX
package's exact XLA warp and its Pallas kernel in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pano_tpu.ops import pallas_warp as PW  # noqa: E402
from pano_tpu.ops import warp as JW  # noqa: E402
from pano_tpu_torch.ops import cuda_warp  # noqa: E402
from pano_tpu_torch.ops import warp as TW  # noqa: E402

TRANSLATION = np.array([[1.0, 0.0, 17.5], [0.0, 1.0, 6.25], [0.0, 0.0, 1.0]])
PROJECTIVE = np.array(  # tests/test_pallas_warp.py:55-57
    [[0.97, 0.02, 12.0], [-0.015, 1.02, 4.0], [2e-5, -1e-5, 1.0]]
)


@pytest.fixture(scope="module")
def images():
    r = np.random.default_rng(41)
    right = r.integers(0, 256, (200, 300, 3)).astype(np.uint8)
    left = r.integers(0, 256, (180, 220, 3)).astype(np.uint8)
    return left, right


def _port(left, right, m_inv, ty, tx, window, out_h, out_w):
    return cuda_warp.warp_compose_overlay(
        torch.from_numpy(right), m_inv, torch.from_numpy(left), ty, tx,
        window, out_h, out_w,
    ).numpy()


@pytest.mark.parametrize("m", [TRANSLATION, PROJECTIVE],
                         ids=["translation", "projective"])
def test_matches_xla_warp_and_blend(images, m):
    """Exact bilinear on both sides: max |d| <= 1, d != 0 on < 0.1% of
    the window's pixels (round at .5 under another contraction)."""
    left, right = images
    out_h, out_w = 260, 420
    ty, tx = 30, 190
    m_inv = np.linalg.inv(m)
    wy0, wx0, wy1, wx1 = 3, 5, 240, 400
    want = np.asarray(
        JW.warp_and_blend(
            jnp.asarray(left), jnp.asarray(right),
            jnp.asarray(m_inv, jnp.float32),
            jnp.asarray(tx, jnp.int32), jnp.asarray(ty, jnp.int32),
            out_h, out_w, "overlay",
            win_x=jnp.asarray(wx0, jnp.int32),
            win_y=jnp.asarray(wy0, jnp.int32),
            win_h=wy1 - wy0, win_w=wx1 - wx0,
        )
    )
    got = _port(left, right, m_inv, ty, tx, (wy0, wx0, wy1, wx1),
                out_h, out_w)
    assert got.shape == want.shape == (out_h, out_w, 3)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1, d.max()
    assert (d != 0).sum() < 1e-3 * (wy1 - wy0) * (wx1 - wx0), (d != 0).sum()
    # Outside the window the canvas is the placed left image, exactly.
    np.testing.assert_array_equal(got[:, :wx0], want[:, :wx0])
    np.testing.assert_array_equal(
        got[ty:ty + left.shape[0], wx1:tx + left.shape[1]],
        left[:, wx1 - tx:],
    )


@pytest.mark.parametrize(
    "m,bound", [(TRANSLATION, "translation"), (PROJECTIVE, "projective")],
    ids=["translation", "projective"],
)
def test_matches_pallas_kernel_in_interpret_mode(images, m, bound):
    """The Pallas kernel's own bounds (tests/test_pallas_warp.py:38-68):
    <= 2 on translations; > 3 on < 1% of pixels for projective maps."""
    left, right = images
    pad_h, pad_w = 256, 512
    ty, tx = 0, 256           # the kernel's (128, 256) tile grid
    m_inv = np.linalg.inv(m)
    assert PW.supports_homography(m_inv, pad_h, pad_w)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            PW.warp_compose_overlay(
                PW.pack_bgra(jnp.asarray(right)),
                PW.make_params(m_inv, 0, 0, right.shape[0], right.shape[1]),
                jnp.asarray(left), jnp.asarray(ty, jnp.int32),
                jnp.asarray(tx, jnp.int32), jnp.asarray(0, jnp.int32),
                jnp.asarray(0, jnp.int32), pad_h, pad_w, pad_h, pad_w,
            )
        )
    got = _port(left, right, m_inv, ty, tx, (0, 0, pad_h, pad_w),
                pad_h, pad_w)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    if bound == "translation":
        assert d.max() <= 2, d.max()
    else:
        assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


def test_plain_wrapper_and_warp_and_blend_agree(images):
    left, right = images
    m_inv = np.linalg.inv(PROJECTIVE)
    args = (torch.from_numpy(right), m_inv, torch.from_numpy(left), 10, 20,
            (0, 0, 150, 200), 160, 240)
    np.testing.assert_array_equal(
        cuda_warp.warp_compose_overlay(*args).numpy(),
        cuda_warp.warp_compose_overlay_plain(*args).numpy(),
    )


def test_canvas_geometry_matches_jax():
    h = np.array([[0.98, 0.01, 310.5], [-0.02, 1.01, -22.25],
                  [1e-5, 2e-5, 1.0]])
    want = JW.compute_canvas_geometry(h, (300, 400), (310, 420))
    got = TW.compute_canvas_geometry(h, (300, 400), (310, 420))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_wrapper_checks():
    img = torch.zeros((8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        cuda_warp.warp_compose_overlay(img, np.eye(3), img, 0, 0,
                                       (0, 0, 9, 8), 8, 8)
    meta = torch.empty((8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_warp.warp_compose_overlay(meta, np.eye(3), meta, 0, 0,
                                       (0, 0, 8, 8), 8, 8)
    with pytest.raises(NotImplementedError):
        TW.warp_and_blend(img, img, np.eye(3), 0, 0, 8, 8, "feather")
