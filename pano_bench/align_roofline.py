"""The least time of the direct alignment's passes (K11,
``csrc/align.cu``) on an H100, for ``align.roofline_pct``.

A pass needs, for every right pixel that the homography places inside
the left image (the overlap), the right pixel's bytes and the left
bytes around where it lands, once each, its residual and Jacobian in
float32 and its 46 products and sums in float64. Pixels outside the
overlap need nothing. The overlap is counted by its area: the left
image's sampling rectangle mapped into the right image by the planted
homography's inverse, clipped to the right image. The peaks are
``roofline.py``'s.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from pano_bench import roofline

# Float32 operations a pixel of the overlap, from the kernel's arithmetic:
# its normalized frame 4, w 4, xn and yn 10 (two divisions), x and y 4,
# the bounds 5, floors and fractions 4, five grays 25, the bilinear
# sample and its gradient 13, the residual 1, the gradient's scale 2,
# 1 / w 1, q 4, the scaled gradients 3, the Jacobian 6.
F32_OPS_PER_PX = 86
# Float64: 9 conversions, the 45 products and the 46 sums.
F64_OPS_PER_PX = 100
# Bytes: the right pixel and the left pixel it lands on, 3 each.
BYTES_PER_PX = 6


def _clip(poly: List[Tuple[float, float]], axis: int, bound: float,
          keep_below: bool) -> List[Tuple[float, float]]:
    """`poly` clipped to coordinate `axis` <= `bound` (or >=)."""
    def inside(p):
        return p[axis] <= bound if keep_below else p[axis] >= bound

    out = []
    for i, cur in enumerate(poly):
        prev = poly[i - 1]
        if inside(cur) != inside(prev):
            t = (bound - prev[axis]) / (cur[axis] - prev[axis])
            out.append(tuple(a + t * (b - a) for a, b in zip(prev, cur)))
        if inside(cur):
            out.append(cur)
    return out


def overlap_px(right_hw: Tuple[int, int], left_hw: Tuple[int, int],
               g: Sequence[Sequence[float]]) -> float:
    """Area (px^2) of the right image's pixels that `g` (right -> left)
    places where the left image can be sampled bilinearly."""
    (hr, wr), (hl, wl) = right_hw, left_hw
    inv = np.linalg.inv(np.asarray(g, np.float64))
    poly = []
    for x, y in ((0, 0), (wl - 1, 0), (wl - 1, hl - 1), (0, hl - 1)):
        p = inv @ np.array([x, y, 1.0])
        poly.append((p[0] / p[2], p[1] / p[2]))
    for axis, bound, below in ((0, 0.0, False), (0, wr - 1.0, True),
                               (1, 0.0, False), (1, hr - 1.0, True)):
        poly = _clip(poly, axis, bound, below)
        if not poly:
            return 0.0
    return float(abs(sum(xa * yb - xb * ya for (xa, ya), (xb, yb)
                         in zip(poly, poly[1:] + poly[:1]))) / 2)


def pair_seconds(right_hw, left_hw, g, passes: int) -> float:
    """The least seconds of `passes` passes over a pair placed by `g`."""
    n = overlap_px(right_hw, left_hw, g)
    return passes * roofline.least_seconds(
        BYTES_PER_PX * n, {"f32": F32_OPS_PER_PX * n,
                           "f64": F64_OPS_PER_PX * n})
