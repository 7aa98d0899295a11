"""Harris corner detection: score map -> 2x2 block fold -> exact top-K.

Counterpart of ``pano_tpu/ops/harris.py``. The score map comes from kernel
K1 (``ops/cuda_harris.py``) or, with ``use_pallas_scores`` off or an NMS
window other than 3, from the plain chain below. Both give the block-folded
``(ceil(h/2), ceil(w/2))`` map whose peaks carry their in-block offset in
the two mantissa LSBs, so the decode after top-K needs no gathers.

Top-K is an exact, stable sort: ties come out lowest flat index first, as
``lax.top_k`` orders them (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pano_tpu_torch.config import HarrisOptions
from pano_tpu_torch.ops import conv as conv_ops


class KeyPoints(NamedTuple):
    """Fixed-capacity keypoint set.

    xy:       (K, 2) int32, columns are (x, y) pixel coordinates.
    response: (K,) float32 Harris response.
    valid:    (K,) bool, True for real keypoints, False for padding.
    """

    xy: torch.Tensor
    response: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def bgr_to_gray_f32(img_u8: torch.Tensor) -> torch.Tensor:
    """BT.601 gray with round half to even (cv::cvtColor emulation)."""
    b = img_u8[..., 0].float()
    g = img_u8[..., 1].float()
    r = img_u8[..., 2].float()
    return torch.round(0.114 * b + 0.587 * g + 0.299 * r)


def _tap_sum(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Valid-region correlation as a constant-weighted tap sum, taps in
    row-major order, zero-weight taps skipped (``conv._tap_sum``)."""
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


def _zero_border(valid: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.pad(valid, (k, k, k, k))


def _separable_valid_zero_border(
    img: torch.Tensor, k1d: np.ndarray
) -> torch.Tensor:
    """Correlate with outer(k1d, k1d): vertical pass over full columns,
    then horizontal; the k-wide border is zero."""
    ksize = k1d.shape[0]
    k = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    acc = None
    for i in range(ksize):
        term = img[..., i:i + h - 2 * k, :] * float(k1d[i])
        acc = term if acc is None else acc + term
    out = None
    for j in range(ksize):
        term = acc[..., :, j:j + w - 2 * k] * float(k1d[j])
        out = term if out is None else out + term
    return _zero_border(out, k)


def harris_response(gray: torch.Tensor, k: float) -> torch.Tensor:
    """R = det(M) - k*trace(M)^2 with the reference's zero borders."""
    gx = _zero_border(_tap_sum(gray, conv_ops.sobel_x_kernel()), 1)
    gy = _zero_border(_tap_sum(gray, conv_ops.sobel_y_kernel()), 1)
    prods = torch.stack([gx * gx, gy * gy, gx * gy])
    sm = _separable_valid_zero_border(
        prods, conv_ops.gaussian_kernel_1d(5, 1.0)
    )
    sxx, syy, sxy = sm[0], sm[1], sm[2]
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


def _neighbor_max(resp: torch.Tensor, neighborhood: int) -> torch.Tensor:
    """Max over the window excluding the center pixel (-inf outside)."""
    half = neighborhood // 2
    h, w = resp.shape
    padded = torch.nn.functional.pad(
        resp, (half, half, half, half), value=float("-inf")
    )
    nmax = torch.full_like(resp, float("-inf"))
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            if dy == 0 and dx == 0:
                continue
            shifted = padded[half + dy:half + dy + h, half + dx:half + dx + w]
            nmax = torch.maximum(nmax, shifted)
    return nmax


def _topk_stable(flat: torch.Tensor, k: int):
    """The k largest values, ties lowest index first."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def harris_detect(img_u8: torch.Tensor, opts: HarrisOptions) -> KeyPoints:
    """Gray -> response -> NMS -> 2x2 fold -> top-K keypoints.

    Returns a fixed-capacity KeyPoints (K = opts.max_keypoints) ordered by
    descending response, padded with invalid rows."""
    # cuda_harris builds its plain version from this module's chain, so
    # it is imported here rather than at the top.
    from pano_tpu_torch.ops import cuda_harris

    if opts.use_pallas_scores and opts.nms_neighborhood == 3:
        bmax = cuda_harris.harris_scores(img_u8, opts.k, opts.nms_thresh)
    else:
        bmax = cuda_harris.harris_scores_plain(
            img_u8, opts.k, opts.nms_thresh, opts.nms_neighborhood
        )
    h2, w2 = bmax.shape

    k_cap = min(opts.max_keypoints, h2 * w2)
    top_scores, top_bidx = _topk_stable(bmax.reshape(-1), k_cap)
    valid = torch.isfinite(top_scores)

    bits = top_scores.view(torch.int32)
    off = bits & 3
    by = (top_bidx // w2).to(torch.int32)
    bx = (top_bidx % w2).to(torch.int32)
    top_y = by * 2 + (off >> 1)
    top_x = bx * 2 + (off & 1)
    xy = torch.stack([top_x, top_y], dim=-1)
    xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    response = torch.where(
        valid, (bits & ~3).view(torch.float32), torch.zeros_like(top_scores)
    )

    pad = opts.max_keypoints - k_cap
    if pad:  # tiny images: pad to the static capacity
        xy = torch.nn.functional.pad(xy, (0, 0, 0, pad))
        response = torch.nn.functional.pad(response, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return KeyPoints(xy=xy, response=response, valid=valid)
