"""The mip level of a minifying warp.

Counterpart of the mip choice in ``pano_tpu/ops/pallas_warp.py``
(``MAX_MIP``, ``SCALE_MAX``, ``mip_m_inv``, ``pick_mip_level``). A warp
that shrinks its source by more than ``SCALE_MAX`` over a (TH, TW) output
tile samples a 2x box-filtered source (``ops/warp.py::downsample_pow2``)
instead, up to ``MAX_MIP`` levels: the prefilter anti-aliases, which
bilinear sampling at more than 2x minification does not.

``pick_mip_level`` keeps only the scale rule of the JAX package's
``supports_homography``. Its window, chunk and tilt limits bound the
TPU's two-pass warp; the port's warp (K4b) is an exact single pass with
no envelope. So a tilted map that is not minified takes level 0 here,
where the TPU's envelope may take level 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

TH, TW = 128, 256   # the output tile over which the source span is measured
SCALE_MAX = 1.32    # largest source span per output span at one level
MAX_MIP = 2         # deepest 2x prefilter level (4x in all)


def mip_m_inv(m_inv: np.ndarray, lvl: int) -> np.ndarray:
    """The inverse map re-targeted at the 2^lvl-downsampled source: the
    full-resolution source coordinate divided by the mip scale."""
    s = float(2 ** lvl)
    return np.diag([1.0 / s, 1.0 / s, 1.0]) @ np.asarray(m_inv, np.float64)


def _scale_ok(m_inv: np.ndarray, out_h: int, out_w: int, off_x: float,
              off_y: float) -> bool:
    """The local Jacobian of the map at the window's corners and centre
    spans at most SCALE_MAX tiles of source per output tile."""
    m = np.asarray(m_inv, np.float64)
    pts = np.array(
        [[0, 0], [out_w, 0], [0, out_h], [out_w, out_h],
         [out_w / 2, out_h / 2]],
        np.float64,
    ) + np.array([off_x, off_y])
    for x, y in pts:
        den = m[2, 0] * x + m[2, 1] * y + m[2, 2]
        if abs(den) < 1e-9:
            return False
        sx = (m[0, 0] * x + m[0, 1] * y + m[0, 2]) / den
        sy = (m[1, 0] * x + m[1, 1] * y + m[1, 2]) / den
        j00 = (m[0, 0] - sx * m[2, 0]) / den
        j01 = (m[0, 1] - sx * m[2, 1]) / den
        j10 = (m[1, 0] - sy * m[2, 0]) / den
        j11 = (m[1, 1] - sy * m[2, 1]) / den
        x_span = abs(j00) * TW + abs(j01) * TH
        y_span = abs(j10) * TW + abs(j11) * TH
        if x_span > SCALE_MAX * TW or y_span > SCALE_MAX * TH:
            return False
    return True


def pick_mip_level(
    m_inv: np.ndarray, out_h: int, out_w: int, off_x: float = 0.0,
    off_y: float = 0.0,
) -> Optional[int]:
    """The smallest level (0 = full resolution) whose re-targeted map
    passes the scale rule over the (out_h, out_w) window at (off_x,
    off_y), or None when no level up to MAX_MIP does (the caller then
    warps at full resolution, as the JAX package's XLA warp does)."""
    for lvl in range(MAX_MIP + 1):
        if _scale_ok(mip_m_inv(m_inv, lvl), out_h, out_w, off_x, off_y):
            return lvl
    return None
