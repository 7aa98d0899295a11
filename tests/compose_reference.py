"""A pair's panorama drawn on the fused stitch's whole-pixel frame, for
the tests of its compose.

The benchmark's reference (``pano_bench/reference.py``) draws a panorama
with the planted homographies at the union's top-left corner, which for
a perspective pair lies between pixels; the fused stitch copies the left
image on whole pixels, at ceil(-min - 1e-3) of the union's top-left. Here
the left image is copied there and the right one warped over it through
the homography the stitch placed it with, bilinearly, a black sample
letting the canvas show through (``reference._warp_over``), so that what
differs from the stitch's panorama is its compose alone, not its
estimate or its frame. Plain torch and numpy; it imports nothing of the
port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pano_bench import reference

EDGE_PX = 0.01   # room for float32 coordinates (source px) at the border


def whole_pixel_panorama(left: torch.Tensor, right: torch.Tensor, h):
    """(panorama, band) of `left` and `right` ((h, w, 3) uint8 on one
    device) with `right` placed into `left`'s frame by `h` (3x3): the
    (canvas_h, canvas_w, 3) uint8 panorama and the (canvas_h, canvas_w)
    bool band, both on the images' device: the band holds the pixels that `h` takes
    to within a source pixel outside the right image's last pixel
    centres, where the stitch's taps with a zero border (a sample in
    (-1, w) x (-1, h)) and the reference's inside test ([0, w - 1] x
    [0, h - 1]) part. On a translation that is the pixel ring that
    ``reference.edge_band`` spares; on a perspective pair it follows the
    warp's scale (at a far edge a source pixel spans 0.3 of the
    canvas's)."""
    hl, wl = left.shape[:2]
    hr, wr = right.shape[:2]
    h = np.asarray(h, np.float64)
    c = np.array([[0, 0, 1], [wr, 0, 1], [wr, hr, 1], [0, hr, 1]],
                 np.float64) @ h.T
    q = c[:, :2] / c[:, 2:]
    lo = np.minimum(q.min(0), 0.0)
    hi = np.maximum(q.max(0), [wl, hl])
    canvas_w, canvas_h = (int(v) for v in np.ceil(hi - lo))
    tx, ty = (int(math.ceil(-v - 1e-3)) for v in lo)
    pano = torch.zeros((canvas_h, canvas_w, 3), dtype=torch.uint8,
                       device=left.device)
    pano[ty:ty + hl, tx:tx + wl] = left
    shift = np.array([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(shift @ h)
    m_inv = torch.tensor(inv, dtype=torch.float32, device=left.device)
    q = q + [tx, ty]
    x0, y0 = (max(int(math.floor(v)) - 1, 0) for v in q.min(0))
    x1 = min(int(math.ceil(q[:, 0].max())) + 1, canvas_w)
    y1 = min(int(math.ceil(q[:, 1].max())) + 1, canvas_h)
    reference._warp_over(pano, right, m_inv, x0, y0, x1, y1, torch.float32)
    dev = left.device
    m = torch.tensor(inv, dtype=torch.float64, device=dev)
    xs = torch.arange(x0, x1, dtype=torch.float64, device=dev)[None, :]
    ys = torch.arange(y0, y1, dtype=torch.float64, device=dev)[:, None]
    den = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    sx = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / den
    sy = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / den
    inner = ((sx >= EDGE_PX) & (sx <= wr - 1 - EDGE_PX)
             & (sy >= EDGE_PX) & (sy <= hr - 1 - EDGE_PX))
    outer = ((sx <= -1 - EDGE_PX) | (sx >= wr + EDGE_PX)
             | (sy <= -1 - EDGE_PX) | (sy >= hr + EDGE_PX))
    band = torch.zeros((canvas_h, canvas_w), dtype=torch.bool, device=dev)
    band[y0:y1, x0:x1] = ~inner & ~outer
    return pano, band


def compose_max_d(pano, left: torch.Tensor, right: torch.Tensor, h):
    """(canvas_px, pixel_max_d) of the stitch's `pano` against
    ``whole_pixel_panorama`` of the same pair and `h`: the largest
    difference of the canvas's height or width, and the largest
    difference of a channel over their common extent outside the band."""
    ref, band = whole_pixel_panorama(left, right, h)
    return reference.compare_panorama(pano, ref, band).values()
