"""pano_tpu_torch.ops.conv's public correlations vs the JAX package's, on
the CPU, bit for bit (tolerance: none): the same f32 taps in the same
order, each weight rounded once to f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pano_tpu.ops import conv as JC  # noqa: E402
from pano_tpu_torch.ops import conv as TC  # noqa: E402

SHAPES = [(16, 20), (33, 41), (3, 33, 41)]   # the last as harris stacks it
KERNELS = {
    "sobel_x": TC.sobel_x_kernel(),
    "sobel_y": TC.sobel_y_kernel(),
    "gauss5": TC.gaussian_kernel(5, 1.0),
    "gauss7": TC.gaussian_kernel(7, 1.5),
    "random3": np.random.default_rng(7).normal(size=(3, 3)),
}
KERNELS_1D = {
    "gauss5": TC.gaussian_kernel_1d(5, 1.0),
    "gauss7": TC.gaussian_kernel_1d(7, 1.5),
    "random3": np.random.default_rng(8).normal(size=3),
}


def _img(shape, seed=3):
    return np.random.default_rng(seed).normal(
        scale=50.0, size=shape).astype(np.float32)


def conv_oracle(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """The reference's convolveSequential loop in numpy (as
    tests/test_conv.py writes it)."""
    k = kernel.shape[0] // 2
    out = np.zeros_like(img)
    h, w = img.shape
    for y in range(k, h - k):
        for x in range(k, w - k):
            out[y, x] = np.sum(img[y - k:y + k + 1, x - k:x + k + 1] * kernel)
    return out


@pytest.mark.parametrize("size,sigma", [(3, 0.5), (5, 1.0), (7, 1.5)])
def test_gaussian_kernel_equals_jax(size, sigma):
    got = TC.gaussian_kernel(size, sigma)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, JC.gaussian_kernel(size, sigma))
    g1 = TC.gaussian_kernel_1d(size, sigma)
    np.testing.assert_allclose(np.outer(g1, g1), got, rtol=1e-12)


@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("shape", SHAPES)
def test_conv2d_valid_zero_border_equals_jax(shape, name):
    img, kernel = _img(shape), KERNELS[name]
    got = TC.conv2d_valid_zero_border(torch.from_numpy(img), kernel)
    want = np.asarray(JC.conv2d_valid_zero_border(jnp.asarray(img), kernel))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(KERNELS_1D))
@pytest.mark.parametrize("shape", SHAPES)
def test_conv2d_separable_valid_zero_border_equals_jax(shape, name):
    img, k1d = _img(shape), KERNELS_1D[name]
    got = TC.conv2d_separable_valid_zero_border(torch.from_numpy(img), k1d)
    want = np.asarray(
        JC.conv2d_separable_valid_zero_border(jnp.asarray(img), k1d))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [3, 5, 7])
def test_zero_border_of_width_k(size):
    """Valid interior against the reference loop, the border exactly 0,
    the separable pass too."""
    img = _img((16, 20), 4)
    kernel = TC.gaussian_kernel(size, 1.0)
    k = size // 2
    for got in (TC.conv2d_valid_zero_border(torch.from_numpy(img), kernel),
                TC.conv2d_separable_valid_zero_border(
                    torch.from_numpy(img), TC.gaussian_kernel_1d(size, 1.0))):
        got = got.numpy()
        np.testing.assert_allclose(got, conv_oracle(img.astype(np.float64),
                                                    kernel),
                                   rtol=1e-4, atol=5e-3)
        assert not got[:k].any() and not got[-k:].any()
        assert not got[:, :k].any() and not got[:, -k:].any()


def test_conv_is_correlation_not_flipped():
    """An asymmetric kernel tells correlation from convolution: the port
    follows the reference's loop, not the flipped kernel."""
    img = _img((10, 10), 5)
    kernel = TC.sobel_x_kernel()
    got = TC.conv2d_valid_zero_border(torch.from_numpy(img), kernel).numpy()
    want = conv_oracle(img.astype(np.float64), kernel)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
    flipped = conv_oracle(img.astype(np.float64), kernel[::-1, ::-1])
    assert np.abs(got - flipped)[1:-1, 1:-1].max() > 1.0


def test_even_kernel_is_refused():
    img = torch.zeros(8, 8)
    with pytest.raises(AssertionError, match="odd"):
        TC.conv2d_valid_zero_border(img, np.ones((4, 4)))
    with pytest.raises(AssertionError, match="odd"):
        TC.conv2d_separable_valid_zero_border(img, np.ones(4))
