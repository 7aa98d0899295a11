"""The least time each step of a panorama could take on an H100, from
the shapes of the work, for ``kernels_roofline``.

The peaks and the per-pixel operation counts, counted from each
kernel's arithmetic, are the ones the port's ``chip_smoke.py`` imports
from here for its kernel table's bounds. The steps are the work a step
needs, not what today's kernel does: each image is detected and
described once, each pair the entry estimates matched once (``pairs``:
"adjacent", the n - 1 pairs of a chain or a pair, or "all", the
n(n - 1)/2 that an unordered set must match), each source read once,
each warped image's footprint on the canvas computed once, and the
canvas written once. A kernel that later replaces another for the same
step reads against the same count.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit
(the run reports the card's own limit beside the number).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12, "int8": 1979e12}

# Operations per pixel or per pair, from the kernels' arithmetic
# (chip_smoke.py). Detect: gray 5, two Sobels 22, products 3, two 5-tap
# Gaussian passes over three planes 54, R 7, NMS 9 compares.
DETECT_OPS_PER_PX = 100
# Match's f32 epilogue per (query, train) pair: the SSD from the product
# (convert, scale, two adds) 4, the row's best, index and second 5, the
# column's masked minimum and its row 4.
MATCH_EPILOGUE_OPS = 13
# Warp per window pixel: inverse map 14, floor and fractions 4, tap
# weights 8, three channels of four taps 24, round and clip 9; the ramp
# alpha of feather and multiband 52 more.
WARP_OPS_PER_PX = 59
ALPHA_OPS_PER_PX = 52
# The refine's 9x9 eigenvector: 8 sweeps of the 36 rotations a sweep
# needs, 179 f64 operations each.
EIGVEC_OPS = 8 * 36 * 179


PAIRS = {"adjacent": lambda n: n - 1, "all": lambda n: n * (n - 1) // 2}


def estimates(n_images: int, pairs: str = "adjacent") -> int:
    """The estimates a panorama of `n_images` needs: `pairs` is a
    traffic's "pairs" key."""
    if pairs not in PAIRS:
        raise ValueError(f"pairs must be one of {sorted(PAIRS)}: {pairs!r}")
    return PAIRS[pairs](n_images)


def least_seconds(nbytes: float, ops: Dict[str, float]) -> float:
    """The larger of the bytes over the memory rate and, of each type's
    operations over its peak, the largest (they run on other units)."""
    t_ops = max([n / PEAK_OPS_PER_S[k] for k, n in ops.items()] + [0.0])
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def quad_area(h: int, w: int, g) -> float:
    """Area (px^2) of an (h, w) image's rectangle mapped by the
    homography `g` (3x3, rows of numbers): the shoelace sum over its
    projected corners; h * w for a translation."""
    pts = []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        d = g[2][0] * x + g[2][1] * y + g[2][2]
        pts.append(((g[0][0] * x + g[0][1] * y + g[0][2]) / d,
                    (g[1][0] * x + g[1][1] * y + g[1][2]) / d))
    return float(abs(sum(xa * yb - xb * ya for (xa, ya), (xb, yb)
                         in zip(pts, pts[1:] + pts[:1]))) / 2)


def panorama_steps(images: Sequence[Tuple[int, int]],
                   canvas: Tuple[int, int], keypoints: int, patch: int,
                   alpha: bool, pairs: str = "adjacent",
                   globals_h: Optional[Sequence] = None, anchor: int = 0
                   ) -> Dict[str, float]:
    """Seconds of each step for one panorama of `images` ((h, w) each;
    image `anchor` is placed and not warped) on a `canvas` (h, w), with
    `keypoints` per image and `patch`-sized descriptors; `alpha` when
    the blend warps with the ramp alpha; `pairs` which pairs are
    estimated (``estimates``): each next image against the one before,
    or every pair. Each warped image counts the pixels of its footprint
    on the canvas: the area of its rectangle mapped by its homography
    into the anchor's frame (`globals_h`), h * w where none is given."""
    d = patch * patch * 3
    steps = {"detect": 0.0, "describe": 0.0, "match": 0.0,
             "warp_compose": 0.0, "eigvec": 0.0}
    for h, w in images:
        score_px = math.ceil(h / 2) * math.ceil(w / 2)
        steps["detect"] += least_seconds(
            h * w * 3 + score_px * 4, {"f32": DETECT_OPS_PER_PX * h * w})
        # patch bytes, coordinates and flags in; f32 descriptors and
        # border flags out
        steps["describe"] += least_seconds(
            keypoints * (d + 8 + 1 + d * 4 + 1), {})
    n_pairs = estimates(len(images), pairs)
    kk = keypoints * keypoints
    steps["match"] = n_pairs * least_seconds(
        2 * keypoints * (d * 4 + 1) + keypoints * 12,
        {"int8": 2.0 * kk * d, "f32": MATCH_EPILOGUE_OPS * kk})
    steps["eigvec"] = n_pairs * least_seconds(81 * 4 + 9 * 4,
                                            {"f64": EIGVEC_OPS})
    warped_px = sum(h * w if globals_h is None
                    else quad_area(h, w, globals_h[i])
                    for i, (h, w) in enumerate(images) if i != anchor)
    per_px = WARP_OPS_PER_PX + (ALPHA_OPS_PER_PX if alpha else 0)
    steps["warp_compose"] = least_seconds(
        sum(h * w * 3 for h, w in images) + canvas[0] * canvas[1] * 3,
        {"f32": per_px * warped_px})
    return steps


def roofline_pct(work: Dict[str, float],
                 kernel_us: Dict[str, float]) -> float:
    """100 x the sum of the steps' least times over the sum of their
    kernels' device time, over the steps whose kernels ran; None when
    none did."""
    steps = [s for s, us in kernel_us.items() if us > 0 and s in work]
    if not steps:
        return None
    return 100.0 * sum(work[s] for s in steps) * 1e6 \
        / sum(kernel_us[s] for s in steps)
