"""Canvas geometry and the exact inverse warp with overlay blend.

Counterpart of the parts of ``pano_tpu/ops/warp.py`` the pair stitch
needs: host-side canvas geometry, the inverse map, the bilinear u8 sample
with a zero border, and ``warp_and_blend`` with the overlay blend, which
is the plain version of kernel K4a (``ops/cuda_warp.py``). Feather,
multiband and gain are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def warp_corners(h: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """Corner positions of an (img_h, img_w) image under H -> (4, 2) f64."""
    corners = np.array(
        [[0.0, 0.0, 1.0], [img_w, 0.0, 1.0], [img_w, img_h, 1.0],
         [0.0, img_h, 1.0]],
        dtype=np.float64,
    )
    warped = (np.asarray(h, np.float64) @ corners.T).T
    return warped[:, :2] / warped[:, 2:3]


def compute_canvas_geometry(
    h_right_to_left: np.ndarray,
    left_shape: Tuple[int, int],
    right_shape: Tuple[int, int],
):
    """Warp the right image's corners by H, take the union with the left
    rect, and build the translation that shifts negative coordinates into
    view. Returns ((canvas_h, canvas_w), T (3,3) f64, (min_x, min_y))."""
    hl, wl = left_shape
    hr, wr = right_shape
    warped = warp_corners(h_right_to_left, hr, wr)
    min_x = min(0.0, warped[:, 0].min())
    min_y = min(0.0, warped[:, 1].min())
    max_x = max(float(wl), warped[:, 0].max())
    max_y = max(float(hl), warped[:, 1].max())
    t = np.array(
        [[1.0, 0.0, -min_x], [0.0, 1.0, -min_y], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )
    canvas_w = int(np.ceil(max_x - min_x))
    canvas_h = int(np.ceil(max_y - min_y))
    return (canvas_h, canvas_w), t, (min_x, min_y)


def warp_window(
    canvas_corners: np.ndarray, canvas_h: int, canvas_w: int
) -> Tuple[int, int, int, int]:
    """(wy0, wx0, wy1, wx1): the bounding box of the warped corners in
    canvas coordinates, with a 2-px bilinear margin, clipped to the
    canvas (end-exclusive)."""
    wx0 = max(0, int(np.floor(canvas_corners[:, 0].min())) - 2)
    wy0 = max(0, int(np.floor(canvas_corners[:, 1].min())) - 2)
    wx1 = min(canvas_w, int(np.ceil(canvas_corners[:, 0].max())) + 2)
    wy1 = min(canvas_h, int(np.ceil(canvas_corners[:, 1].max())) + 2)
    return wy0, wx0, max(wy0, wy1), max(wx0, wx1)


def _m_floats(h_inv) -> list:
    """The 9 entries of a 3x3 matrix as the Python floats of their f32
    values (what the kernel receives as arguments)."""
    return [float(v) for v in np.asarray(h_inv, np.float32).reshape(-1)]


def _inverse_map(
    h_inv, out_h: int, out_w: int, off_x: int, off_y: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map canvas pixels (off_x + j, off_y + i) through h_inv."""
    m = _m_floats(h_inv)
    ys = torch.arange(out_h, dtype=torch.float32, device=device)[:, None] \
        + float(off_y)
    xs = torch.arange(out_w, dtype=torch.float32, device=device)[None, :] \
        + float(off_x)
    denom = m[6] * xs + m[7] * ys + m[8]
    sx = (m[0] * xs + m[1] * ys + m[2]) / denom
    sy = (m[3] * xs + m[4] * ys + m[5]) / denom
    return sx, sy


def _bilinear_sample_u8(
    img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample with a zero border; returns (f32 (Ho, Wo, C),
    summed in-bounds weight). Taps (0,0), (0,1), (1,0), (1,1) add in that
    order. Coordinates outside (-1, dim) (and NaN) sample nothing; every
    tap would miss there anyway, this only keeps the int cast defined."""
    h, w = img.shape[:2]
    oh, ow = sx.shape
    flat = img.reshape(-1, img.shape[-1])
    inb = (sx > -1.0) & (sx < float(w)) & (sy > -1.0) & (sy < float(h))
    sx = torch.where(inb, sx, torch.zeros_like(sx))
    sy = torch.where(inb, sy, torch.zeros_like(sy))
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    out = None
    wsum = None
    for dy, dx, wgt in (
        (0, 0, (1 - fx) * (1 - fy)),
        (0, 1, fx * (1 - fy)),
        (1, 0, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xi = x0i + dx
        yi = y0i + dy
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & inb
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        tap = flat[idx.reshape(-1)].float().reshape(oh, ow, flat.shape[-1])
        wm = torch.where(ok, wgt, torch.zeros_like(wgt))
        contrib = tap * wm[..., None]
        out = contrib if out is None else out + contrib
        wsum = wm if wsum is None else wsum + wm
    return out, wsum


def _place(canvas: torch.Tensor, img: torch.Tensor, ty: int, tx: int):
    """Write img into canvas at (ty, tx), clipped to the canvas."""
    ch, cw = canvas.shape[:2]
    h, w = img.shape[:2]
    y0, x0 = max(ty, 0), max(tx, 0)
    y1, x1 = min(ty + h, ch), min(tx + w, cw)
    if y1 > y0 and x1 > x0:
        canvas[y0:y1, x0:x1] = img[y0 - ty:y1 - ty, x0 - tx:x1 - tx]


def warp_and_blend(
    left: torch.Tensor,        # (Hl, Wl, 3) uint8
    right: torch.Tensor,       # (Hr, Wr, 3) uint8
    h_inv,                     # (3, 3) inverse of T @ H (any array-like)
    tx: int,                   # left placement offset x
    ty: int,
    out_h: int,
    out_w: int,
    blend: str = "overlay",
    win_x: int = 0,            # warp window origin and size
    win_y: int = 0,
    win_h: "int | None" = None,
    win_w: "int | None" = None,
) -> torch.Tensor:
    """Inverse warp of `right` + overlay onto the translated `left` over
    an (out_h, out_w, 3) u8 canvas. Inside the window, non-black warped
    pixels win (src/serial/main.cpp:380-386); elsewhere the canvas is the
    translated left image, or 0."""
    if blend != "overlay":
        raise NotImplementedError(
            f"blend={blend!r} is not ported yet (ROADMAP A7)"
        )
    if win_h is None or win_w is None:
        win_x, win_y, win_h, win_w = 0, 0, out_h, out_w
    if win_x < 0 or win_y < 0 or win_x + win_w > out_w \
            or win_y + win_h > out_h:
        raise ValueError("warp window must lie inside the canvas")
    canvas = torch.zeros((out_h, out_w, 3), dtype=torch.uint8,
                         device=left.device)
    _place(canvas, left, ty, tx)
    if win_h == 0 or win_w == 0:
        return canvas
    sx, sy = _inverse_map(h_inv, win_h, win_w, win_x, win_y, left.device)
    right_f, _ = _bilinear_sample_u8(right, sx, sy)
    warped = torch.clamp(torch.round(right_f), 0, 255).to(torch.uint8)
    nonblack = (warped != 0).any(dim=-1, keepdim=True)
    win = canvas[win_y:win_y + win_h, win_x:win_x + win_w]
    canvas[win_y:win_y + win_h, win_x:win_x + win_w] = torch.where(
        nonblack, warped, win
    )
    return canvas
