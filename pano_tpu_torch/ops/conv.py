"""Convolution constants of the Harris chain (numpy, f64).

The counterparts of ``pano_tpu/ops/conv.py``'s kernel constructors; the
tap sums that apply them live with their one user, ``ops/harris.py``.
Weights reach the f32 arithmetic rounded once, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def sobel_x_kernel() -> np.ndarray:
    """3x3 Sobel X."""
    return np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float64)


def sobel_y_kernel() -> np.ndarray:
    """3x3 Sobel Y."""
    return np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float64)


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian whose outer product is the 2-D one."""
    half = size // 2
    xs = np.arange(size) - half
    g = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return g / g.sum()
