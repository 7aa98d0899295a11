"""Multi-band (Laplacian-pyramid) blending.

Counterpart of ``pano_tpu/ops/blend.py`` (Burt & Adelson 1983): blend the
Laplacian bands of two aligned images under a Gaussian-smoothed seam
mask, then collapse. Low frequencies mix over wide regions (no visible
seam), high frequencies switch sharply (no ghosting).

Plain PyTorch, as the JAX package leaves it to XLA: the 5x5 binomial
blurs are the tap sums of ``ops/conv.py``, in the same tap order, so the
pyramids round like the JAX package's. This is the CPU route and the
reference of ``ops/cuda_blend.py``, whose kernels compute the same
values on the card.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from pano_tpu_torch.ops import conv as conv_ops

# 5-tap binomial (Burt-Adelson a=0.375) kernel, outer-product separable.
_K1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_K2D = np.outer(_K1D, _K1D)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur of (C, H, W) with edge-replicate padding (zero
    padding would decay both the images and the seam mask at the
    borders)."""
    return conv_ops._tap_sum(F.pad(x, (2, 2, 2, 2), mode="replicate"), _K2D)


def _decimate2(x: torch.Tensor) -> torch.Tensor:
    """x[..., ::2, ::2]."""
    return x[..., ::2, ::2]


def _interleave2(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuff: out[..., 2i, 2j] = x[..., i, j], zeros elsewhere."""
    out = x.new_zeros(x.shape[:-2] + (2 * x.shape[-2], 2 * x.shape[-1]))
    out[..., ::2, ::2] = x
    return out


def _down(x: torch.Tensor) -> torch.Tensor:
    """Blur + decimate by 2 (even rows/cols)."""
    return _decimate2(_blur(x))


def _up(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Zero-stuff + normalized blur, the transpose of _down.

    Normalizing by the blurred zero-stuffed ones-field makes the
    interpolation exact at borders (a plain x4 gain undershoots where the
    5-tap support is clipped)."""
    h, w = x.shape[-2], x.shape[-1]
    up = _interleave2(x)
    ones = _interleave2(x.new_ones((h, w)))
    num = conv_ops.conv2d_same(up, _K2D)
    den = conv_ops.conv2d_same(ones, _K2D)
    up = num / torch.clamp(den, min=1e-8)
    return up[..., :out_h, :out_w]


def gaussian_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    pyr = [x]
    for _ in range(levels - 1):
        pyr.append(_down(pyr[-1]))
    return pyr


def laplacian_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    gp = gaussian_pyramid(x, levels)
    lp = []
    for i in range(levels - 1):
        h, w = gp[i].shape[-2], gp[i].shape[-1]
        lp.append(gp[i] - _up(gp[i + 1], h, w))
    lp.append(gp[-1])
    return lp


def laplacian_blend(
    a: torch.Tensor,       # (H, W, 3) float32, left/base image (pre-filled)
    b: torch.Tensor,       # (H, W, 3) float32, right/warped image
    mask: torch.Tensor,    # (H, W) float32 in [0, 1]: 1 -> take b
    levels: int = 5,
) -> torch.Tensor:
    """Multi-band blend of two aligned images under a seam mask.

    H and W must be divisible by 2**(levels-1); ``ops/warp.py``'s
    ``_multiband_compose`` pads a window to that multiple. Channels ride
    along as a leading axis for the tap sums."""
    h, w = a.shape[:2]
    step = 1 << (levels - 1)
    if h % step or w % step:
        raise ValueError(f"laplacian_blend: {h}x{w} is not a multiple of "
                         f"{step}")
    la = laplacian_pyramid(a.permute(2, 0, 1), levels)   # (3, H, W) each
    lb = laplacian_pyramid(b.permute(2, 0, 1), levels)
    gm = gaussian_pyramid(mask[None], levels)

    out = None
    for i in reversed(range(levels)):
        m = torch.clamp(gm[i], 0.0, 1.0)
        band = la[i] * (1.0 - m) + lb[i] * m
        if out is None:
            out = band
        else:
            out = _up(out, band.shape[-2], band.shape[-1]) + band
    return out.permute(1, 2, 0)
