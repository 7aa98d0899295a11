"""pano_tpu_torch multiband blending and its pieces (tap sums, edge ramp,
gain) vs the JAX package's XLA functions, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano_tpu.ops import blend as JB  # noqa: E402
from pano_tpu.ops import conv as JC  # noqa: E402
from pano_tpu.ops import warp as JW  # noqa: E402
from pano_tpu_torch.ops import blend as TB  # noqa: E402
from pano_tpu_torch.ops import conv as TC  # noqa: E402
from pano_tpu_torch.ops import warp as TW  # noqa: E402


# One XLA program each, not op-by-op dispatch (seconds per pyramid).
_jax_laplacian_blend = jax.jit(JB.laplacian_blend, static_argnums=3)
_jax_multiband_compose = jax.jit(JW._multiband_compose)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(h, w, seed):
    """Two f32 images in [0, 255] and uncovered (zero-weight) regions on
    each side, as multiband sees them in a warp window."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    b = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    xs = np.arange(w)[None, :].repeat(h, 0)
    w_l = np.where(xs < 0.7 * w, rng.random((h, w)), 0.0).astype(np.float32)
    w_r = np.where(xs > 0.3 * w, rng.random((h, w)), 0.0).astype(np.float32)
    w_r[: h // 8] = 0.0
    return a, b, w_l, w_r


@pytest.mark.parametrize("kernel", ["binomial", "sobel"])
def test_tap_sums_match_jax(kernel):
    """Same taps in the same order: conv2d_same and _tap_sum equal the
    JAX package's within f32 rounding of its fused sums."""
    k = TB._K2D if kernel == "binomial" else JC.sobel_x_kernel()
    x = np.random.default_rng(3).random((2, 37, 53)).astype(np.float32)
    np.testing.assert_allclose(
        TC.conv2d_same(_t(x), k).numpy(),
        np.asarray(JC.conv2d_same(jnp.asarray(x), k)), atol=1e-5)
    np.testing.assert_allclose(
        TC._tap_sum(_t(x), k).numpy(),
        np.asarray(JC._tap_sum(jnp.asarray(x), k)), atol=1e-5)


@pytest.mark.parametrize("shape,levels", [((64, 96), 5), ((48, 40), 3)])
def test_laplacian_blend_matches_jax(shape, levels):
    a, b, _, w_r = _images(*shape, seed=5)
    mask = (w_r > 0.5).astype(np.float32)
    want = np.asarray(_jax_laplacian_blend(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), levels))
    got = TB.laplacian_blend(_t(a), _t(b), _t(mask), levels).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_pyramids_match_jax():
    x = np.random.default_rng(6).random((3, 32, 48)).astype(np.float32)
    for fn in ("gaussian_pyramid", "laplacian_pyramid"):
        want = jax.jit(getattr(JB, fn), static_argnums=1)(jnp.asarray(x), 4)
        got = getattr(TB, fn)(_t(x), 4)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_laplacian_blend_rejects_odd_sizes():
    x = torch.zeros((40, 40, 3))
    with pytest.raises(ValueError, match="multiple of 16"):
        TB.laplacian_blend(x, x, torch.zeros((40, 40)), levels=5)


def test_multiband_compose_matches_jax():
    """A 16-multiple window (no padding): u8 within 1."""
    a, b, w_l, w_r = _images(80, 112, seed=8)
    want = np.asarray(_jax_multiband_compose(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(w_l), jnp.asarray(w_r)))
    got = TW._multiband_compose(_t(a), _t(b), _t(w_l), _t(w_r))
    assert got.is_contiguous()  # the compose kernel takes it as is
    got = got.numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_multiband_compose_pads_an_exact_window():
    """A window that is no 16-multiple is padded with uncovered pixels for
    the pyramid: the same as composing the zero-padded window and
    cropping, and 0 where neither side covers."""
    a, b, w_l, w_r = _images(70, 101, seed=9)
    got = TW._multiband_compose(_t(a), _t(b), _t(w_l), _t(w_r)).numpy()
    pad = ((0, 10), (0, 11))
    want = np.asarray(_jax_multiband_compose(
        jnp.asarray(np.pad(a, pad + ((0, 0),))),
        jnp.asarray(np.pad(b, pad + ((0, 0),))),
        jnp.asarray(np.pad(w_l, pad)), jnp.asarray(np.pad(w_r, pad))))
    assert got.shape == (70, 101, 3)
    assert np.abs(got.astype(int) - want[:70, :101].astype(int)).max() <= 1
    assert not got[(w_l <= 0) & (w_r <= 0)].any()


@pytest.mark.parametrize("shape", [(128, 160), (127, 93), (9, 14)])
def test_edge_ramp_matches_jax(shape):
    """Bit-identical ramp, and the u8 ramp plane saturating at 255 where
    an odd side lifts the ramp above 1, as XLA's conversion does."""
    want = np.asarray(JW._edge_ramp(*shape))
    np.testing.assert_array_equal(TW._edge_ramp(*shape).numpy(), want)
    want_u8 = np.asarray((jnp.asarray(want)[..., None] * 255.0)
                         .astype(jnp.uint8))
    np.testing.assert_array_equal(TW._ramp_u8(*shape).numpy(), want_u8)


def test_estimate_gain_matches_jax():
    rng = np.random.default_rng(10)
    left = rng.integers(0, 200, (60, 70, 3)).astype(np.float32)
    right = left * 1.25 + rng.random((60, 70, 3)).astype(np.float32)
    overlap = rng.random((60, 70)) < 0.6
    want = float(JW._estimate_gain(jnp.asarray(left), jnp.asarray(right),
                                   jnp.asarray(overlap)))
    got = float(TW._estimate_gain(_t(left), _t(right), _t(overlap)))
    assert abs(got - want) < 1e-6 and abs(got - 0.8) < 0.01
    # Too little overlap to trust: 1.0.
    small = np.zeros_like(overlap)
    small[:5, :5] = True
    assert float(TW._estimate_gain(_t(left), _t(right), _t(small))) == 1.0
