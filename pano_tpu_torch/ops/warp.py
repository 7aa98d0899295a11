"""Canvas geometry, the exact inverse warp, and every blend.

Counterpart of ``pano_tpu/ops/warp.py``: host-side canvas and window
geometry, the inverse map and the bilinear u8 sample with a zero border,
the mip source (``downsample_pow2``), the feather weights
(``_edge_ramp``), the exposure gain, the multiband window composite,
``blend_window_outputs`` (the epilogue over a warped window, in pair mode
the plain version of kernel K5, ``ops/cuda_compose.py``, and in chain
mode, against the accumulated weight canvas, that of kernel K6) and
``warp_and_blend`` with the overlay, feather and multiband blends and
gain, the exact counterpart of the JAX function of that name (with the
overlay blend, the plain version of kernel K4a, ``ops/cuda_warp.py``).

The JAX module's ``warp_weight_window`` is not ported: it records the
coverage of a step that took the JAX global composite's XLA warp, which
returns no weight, and every step of the port's global composite has
K4b's own weight.
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


BLENDS = ("overlay", "feather", "multiband")
_MB_LEVELS = 5  # pyramid levels of the multiband blend


def _check_blend(blend: str) -> None:
    if blend not in BLENDS:
        raise ValueError(f"unknown blend mode: {blend}")


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to u8."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def warp_perspective_u8(
    img: torch.Tensor, h_inv, out_h: int, out_w: int
) -> torch.Tensor:
    """cv::warpPerspective(img, M, size) equivalent, given M^-1: the
    (out_h, out_w, C) u8 bilinear warp with a zero border."""
    sx, sy = _inverse_map(h_inv, out_h, out_w, 0, 0, img.device)
    rgb, _ = _bilinear_sample_u8(img, sx, sy)
    return _to_u8(rgb)


def downsample_pow2(img_u8: torch.Tensor, lvl: int) -> torch.Tensor:
    """(H, W, 3) u8 -> (H >> lvl, W >> lvl, 3) u8 by repeated 2x2 box
    means rounded half up ((sum + 2) >> 2), odd trailing rows and columns
    cropped: the mip source of a minifying warp (``ops/mip.py``)."""
    out = img_u8
    for _ in range(lvl):
        h2, w2 = out.shape[0] // 2, out.shape[1] // 2
        p = out[:h2 * 2, :w2 * 2].to(torch.int32)
        s = (p.reshape(h2, 2, w2, 2, 3).sum(dim=(1, 3)) + 2) >> 2
        out = s.to(torch.uint8)
    return out


def _multiband_compose(
    left_f: torch.Tensor,    # (H, W, 3) f32
    right_f: torch.Tensor,   # (H, W, 3) f32
    w_left: torch.Tensor,    # (H, W) f32 >= 0
    w_right: torch.Tensor,   # (H, W) f32 >= 0
) -> torch.Tensor:
    """Laplacian-pyramid composite of the overlap window -> u8.

    Invalid regions of each image are pre-filled with the other so the
    pyramid blurs don't bleed black across the seam; the seam mask prefers
    whichever image is deeper (larger feather weight) at each pixel. A
    window whose sides are not multiples of 2**(levels-1) is padded with
    uncovered (zero) pixels for the pyramid and cropped after. The
    pyramid is ``ops/cuda_blend.py``'s: its kernels on the card, the plain
    ``ops/blend.py`` on the CPU."""
    from pano_tpu_torch.ops import cuda_blend

    has_l = w_left > 0.0
    has_r = w_right > 0.0
    a = torch.where(has_l[..., None], left_f, right_f)
    b = torch.where(has_r[..., None], right_f, left_f)
    mask = (has_r & (~has_l | (w_right > w_left))).float()
    h, w = mask.shape
    step = 1 << (_MB_LEVELS - 1)
    ph, pw = -h % step, -w % step
    if ph or pw:
        a = torch.nn.functional.pad(a, (0, 0, 0, pw, 0, ph))
        b = torch.nn.functional.pad(b, (0, 0, 0, pw, 0, ph))
        mask = torch.nn.functional.pad(mask, (0, pw, 0, ph))
    out = cuda_blend.laplacian_blend(a, b, mask, levels=_MB_LEVELS)[:h, :w]
    out = torch.where((has_l | has_r)[..., None], out, 0.0)
    # The pyramid runs channels-first; hand back a contiguous HWC window.
    return _to_u8(out).contiguous()


def _edge_ramp(h: int, w: int, device=None) -> torch.Tensor:
    """Feather weight map: distance to the nearest image edge, divided
    (not multiplied by a reciprocal) by min(h, w) / 2."""
    return _ramp_at(
        torch.arange(h, dtype=torch.float32, device=device)[:, None],
        torch.arange(w, dtype=torch.float32, device=device)[None, :],
        h, w,
    )


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one f32 division on every device: PyTorch turns a
    division of a CUDA tensor by a host scalar into a multiply by the
    reciprocal, one ulp off at times, so `c` goes to the device first."""
    return x / x.new_full((), c)


def _ramp_at(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    """_edge_ramp(h, w) evaluated at the (broadcast) coordinates ys, xs."""
    d = torch.minimum(
        torch.minimum(xs + 1.0, w - xs), torch.minimum(ys + 1.0, h - ys)
    )
    return true_div(d, min(h, w) / 2.0)


def _ramp_u8(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 1) u8 of ramp * 255, truncated, saturating at 255 as XLA's
    float -> u8 conversion does (the ramp exceeds 1 by 1/min(h, w) at the
    centre of an odd side)."""
    return torch.clamp(_edge_ramp(h, w, device) * 255.0, 0, 255) \
        .to(torch.uint8)[..., None]


def left_window(
    left: torch.Tensor, ty: int, tx: int, window
) -> torch.Tensor:
    """The left image placed at (ty, tx), seen through the canvas window
    (wy0, wx0, wy1, wx1): (wy1-wy0, wx1-wx0, 3) u8, 0 off the image."""
    wy0, wx0, wy1, wx1 = window
    out = left.new_zeros((wy1 - wy0, wx1 - wx0, 3))
    _place(out, left, ty - wy0, tx - wx0)
    return out


def left_weight_window(
    left_win: torch.Tensor, hl: int, wl: int, ty: int, tx: int, window
) -> torch.Tensor:
    """The left feather weight over the window: the analytic edge ramp at
    left-image coordinates, 0 off the left image and on black left pixels
    (a composed left canvas has black holes the ramp cannot see)."""
    wy0, wx0, wy1, wx1 = window
    dev = left_win.device
    ly = torch.arange(wy1 - wy0, dtype=torch.float32, device=dev)[:, None] \
        + float(wy0 - ty)
    lx = torch.arange(wx1 - wx0, dtype=torch.float32, device=dev)[None, :] \
        + float(wx0 - tx)
    in_left = (ly >= 0) & (ly < hl) & (lx >= 0) & (lx < wl)
    nonblack = left_win.ne(0).any(-1)
    return torch.where(in_left & nonblack, _ramp_at(ly, lx, hl, wl), 0.0)


def _estimate_gain(
    left_win_f: torch.Tensor,   # (h, w, 3) f32 canvas pixels
    right_f: torch.Tensor,      # (h, w, 3) f32 warped incoming pixels
    overlap: torch.Tensor,      # (h, w) bool, both sides covered
) -> torch.Tensor:
    """Scalar exposure gain (a 0-d tensor, left on the device) mapping the
    incoming image onto the canvas's brightness over their overlap, the
    single-pair analog of cv::detail::GainCompensator. 1.0 when the
    overlap is too small to trust; clipped to [0.6, 1.6]."""
    m = overlap.float()
    num = (left_win_f.sum(-1) * m).sum()
    den = (right_f.sum(-1) * m).sum()
    cnt = m.sum()
    ok = (cnt > 256.0) & (den > 1e3)
    g = torch.where(ok, num / torch.clamp(den, min=1e-6), 1.0)
    return torch.clamp(g, 0.6, 1.6)


def _feather(
    left_f: torch.Tensor, right_f: torch.Tensor, w_left: torch.Tensor,
    w_right: torch.Tensor, right_covered: torch.Tensor,
) -> torch.Tensor:
    """Weighted average over the overlap; a pixel covered by one image
    only takes that image exactly. -> u8."""
    total = torch.clamp(w_left + w_right, min=1e-6)
    blended = (
        left_f * w_left[..., None] + right_f * w_right[..., None]
    ) / total[..., None]
    only_left = w_right <= 0.0
    only_right = (w_left <= 0.0) & right_covered
    win_f = torch.where(only_left[..., None], left_f, blended)
    win_f = torch.where(only_right[..., None], right_f, win_f)
    return _to_u8(win_f)


def _check_window(win_x, win_y, win_h, win_w, out_h, out_w) -> None:
    if win_x < 0 or win_y < 0 or win_x + win_w > out_w \
            or win_y + win_h > out_h:
        raise ValueError("warp window must lie inside the canvas")


def blend_window_outputs(
    left: torch.Tensor,         # (Hl, Wl, 3) u8, or the canvas (chain)
    rgb_win: torch.Tensor,      # (win_h, win_w, 3) u8 warped right
    w_win: "torch.Tensor | None",  # (win_h, win_w) f32 warped weight
    tx: int,
    ty: int,
    win_x: int,
    win_y: int,
    out_h: int,
    out_w: int,
    blend: str = "overlay",
    w_left_win: "torch.Tensor | None" = None,  # (win_h, win_w) f32
    gain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite the warped window at (win_x, win_y) over the canvas.
    Returns (the (out_h, out_w, 3) u8 canvas, the window's merged weight
    max(w_left_win, w_win)).

    Pair mode (`w_left_win` None): the canvas is new, `left` placed at
    (tx, ty), and the left weight is its edge ramp masked by non-black
    coverage. Chain mode (`w_left_win` given, the accumulated weight
    canvas over the window): `left` is the accumulated (out_h, out_w, 3)
    canvas itself and is updated in place; tx and ty are unused.

    `gain` scales the warped pixels by the exposure gain measured where
    both weights exceed 0.05, rounded after scaling; overlay keys on the
    pixels before it. `w_win` may be None for the overlay blend without
    gain, which never reads it."""
    _check_blend(blend)
    win_h, win_w = rgb_win.shape[:2]
    _check_window(win_x, win_y, win_h, win_w, out_h, out_w)
    window = (win_y, win_x, win_y + win_h, win_x + win_w)
    if w_left_win is None:
        canvas = left.new_zeros((out_h, out_w, 3))
        _place(canvas, left, ty, tx)
    else:
        if tuple(left.shape) != (out_h, out_w, 3):
            raise ValueError("chain mode: left must be the (out_h, out_w, 3) "
                             "canvas")
        canvas = left
    left_win = canvas[win_y:win_y + win_h, win_x:win_x + win_w]
    if w_left_win is None:
        w_left_win = left_weight_window(left_win, left.shape[0],
                                        left.shape[1], ty, tx, window)

    warped = rgb_win
    if gain:
        overlap = (w_left_win > 0.05) & (w_win > 0.05)
        g = _estimate_gain(left_win.float(), rgb_win.float(), overlap)
        warped = _to_u8(rgb_win.float() * g)

    if blend == "overlay":
        right_nonblack = rgb_win.ne(0).any(-1, keepdim=True)
        win_out = torch.where(right_nonblack, warped, left_win)
    elif blend == "feather":
        win_out = _feather(left_win.float(), warped.float(), w_left_win,
                           w_win, w_win > 0.0)
    else:
        win_out = _multiband_compose(left_win.float(), warped.float(),
                                     w_left_win, w_win)
    new_w = w_left_win if w_win is None else torch.maximum(w_left_win, w_win)
    canvas[win_y:win_y + win_h, win_x:win_x + win_w] = win_out
    return canvas, new_w


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
    gain: bool = False,        # exposure compensation (_estimate_gain)
) -> torch.Tensor:
    """Inverse warp of `right` + composite with the translated `left` over
    an (out_h, out_w, 3) u8 canvas. Outside the window the canvas is the
    translated left image, or 0. Inside it:

    - overlay: non-black warped pixels win (src/serial/main.cpp:380-386);
    - feather: the distance-ramp weighted average, the right weight being
      the sampled u8 ramp times the in-bounds bilinear weight;
    - multiband: the Laplacian-pyramid composite under the same weights.

    The warped right stays unrounded f32 into every blend, and gain
    scales it before the blend, measured where the left is non-black and
    the in-bounds weight exceeds 0.05."""
    _check_blend(blend)
    if win_h is None or win_w is None:
        win_x, win_y, win_h, win_w = 0, 0, out_h, out_w
    _check_window(win_x, win_y, win_h, win_w, out_h, out_w)
    canvas = torch.zeros((out_h, out_w, 3), dtype=torch.uint8,
                         device=left.device)
    _place(canvas, left, ty, tx)
    if win_h == 0 or win_w == 0:
        return canvas
    sx, sy = _inverse_map(h_inv, win_h, win_w, win_x, win_y, left.device)
    right_f, right_w = _bilinear_sample_u8(right, sx, sy)
    left_win = canvas[win_y:win_y + win_h, win_x:win_x + win_w]

    if gain:
        overlap = left_win.ne(0).any(-1) & (right_w > 0.05)
        right_f = right_f * _estimate_gain(left_win.float(), right_f, overlap)

    if blend == "overlay":
        warped = _to_u8(right_f)
        nonblack = warped.ne(0).any(-1, keepdim=True)
        win_out = torch.where(nonblack, warped, left_win)
    else:
        hr, wr = right.shape[:2]
        wr_map, _ = _bilinear_sample_u8(_ramp_u8(hr, wr, left.device), sx, sy)
        w_right = true_div(wr_map[..., 0], 255.0) * right_w
        hl, wl = left.shape[:2]
        w_left = left_weight_window(
            left_win, hl, wl, ty, tx,
            (win_y, win_x, win_y + win_h, win_x + win_w),
        )
        if blend == "feather":
            win_out = _feather(left_win.float(), right_f, w_left, w_right,
                               right_w > 0.0)
        else:
            win_out = _multiband_compose(left_win.float(), right_f, w_left,
                                         w_right)
    canvas[win_y:win_y + win_h, win_x:win_x + win_w] = win_out
    return canvas
