"""2-D correlations as shift-and-add tap sums, and their constants.

Counterpart of ``pano_tpu/ops/conv.py``: the kernel constructors (numpy,
f64), ``_tap_sum`` and ``conv2d_same``. The taps are statically weighted
shifted slices summed in row-major order, as in the JAX package, and not
``F.conv2d``: cuDNN would run f32 in TF32 on the GPU and in another
summation order everywhere, and the Harris scores and the multiband
pyramids must round like the JAX package's. Weights reach the f32
arithmetic rounded once.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _tap_sum(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Valid-region correlation of `img` (..., H, W) with a constant
    (k, k) kernel -> (..., H-k+1, W-k+1); taps in row-major order,
    zero-weight taps skipped."""
    ksize = kernel.shape[0]
    h, w = img.shape[-2], img.shape[-1]
    vh, vw = h - (ksize - 1), w - (ksize - 1)
    acc = None
    for i in range(ksize):
        for j in range(ksize):
            wgt = float(kernel[i, j])
            if wgt == 0.0:
                continue
            term = img[..., i:i + vh, j:j + vw] * wgt
            acc = term if acc is None else acc + term
    return acc


def conv2d_same(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """SAME correlation with a zero border of width k//2."""
    k = kernel.shape[0] // 2
    return _tap_sum(torch.nn.functional.pad(img, (k, k, k, k)), kernel)
