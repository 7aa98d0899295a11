"""The plain reference, and the comparison that decides ``correct``.

The reference imports nothing of the program and takes nothing it made:
from a scene's images and their planted homographies it draws the
panorama that the stitch's semantics demand, in the frame of the image
the entry framed it in, the anchor (image 0 unless the answer names
another; ``in_frame``). The canvas is the ceiling of the union of the
warped image rectangles (``canvas_frame``, which the harness's sample
storage and work counts take too); each image is warped onto it through
the inverse of its homography with bilinear sampling, the anchor first
and the others in order over it, a black sample letting the canvas show
through (the reference's overlay). Every image shows one scene, so any
blend of the pixels that overlap is that scene's pixel: the same drawing
is the reference of overlay, feather and multiband alike, and where they
depart from it near a seam is what the pixel limit allows.

``dtype`` is the precision of the geometry and the sampling: float32,
the configuration's, for the reference; bfloat16, the next below, for
the control that must come out not correct.

Numbers compared, each against its limit from ``limits/<config>.json``:

* ``h_err_px``: over every panorama of the window, the largest distance
  (px) by which a corner of a placed image lands away from its planted
  place in image 0's frame, through the homography that the panorama
  was placed with;
* ``canvas_px``: over the sampled panoramas, the largest difference of
  the canvas's height or width from the reference's;
* ``pixel_max_d``: over the sampled panoramas, the largest difference of
  a channel from the reference's, over their common extent, outside a
  band of 2 px across each edge of each placed image but the anchor
  (``edge_band``: an estimate a thousandth of a pixel off samples a
  sliver of the black outside there; the anchor is copied, not
  sampled);
* ``missing``: panoramas that came back empty (None).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from pano_bench.scenes import planted_globals

BAND = 1   # the excluded band: this many pixels on each side of an edge
UNPLACED_PX = 1e9   # the error of an image with no finite placement


def corner_error(h_placed: np.ndarray, h_true: np.ndarray, img_h: int,
                 img_w: int) -> float:
    """Largest distance (px) between an (img_h, img_w) image's corners
    mapped by `h_placed` and by `h_true`; UNPLACED_PX where `h_placed`
    is missing (an image left out) or maps a corner to no finite point
    (a finite number, so that the result line stays JSON)."""
    c = np.array([[0, 0, 1], [img_w, 0, 1], [img_w, img_h, 1],
                  [0, img_h, 1]], np.float64)

    def project(h):
        p = c @ np.asarray(h, np.float64).T
        return p[:, :2] / p[:, 2:3]

    if h_placed is None:
        return UNPLACED_PX
    with np.errstate(all="ignore"):
        d = project(h_placed) - project(h_true)
        e = float(np.sqrt((d ** 2).sum(1)).max())
    return min(e, UNPLACED_PX) if math.isfinite(e) else UNPLACED_PX


def _to_dtype(m: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, np.float64)).to(device=device,
                                                        dtype=dtype)


def shapes(images) -> List[Tuple[int, int]]:
    """(h, w) of each image (tensors or numpy)."""
    return [_hw(img) for img in images]


def in_frame(globals_h: Sequence[np.ndarray], anchor: int
             ) -> List[np.ndarray]:
    """Homographies into image 0's frame as homographies into image
    `anchor`'s: ``inv(g_anchor) @ g_i`` (those given where `anchor` is
    0)."""
    if anchor == 0:
        return list(globals_h)
    back = np.linalg.inv(np.asarray(globals_h[anchor], np.float64))
    return [back @ np.asarray(g, np.float64) for g in globals_h]


def canvas_frame(image_shapes: Sequence[Tuple[int, int]],
                 globals_h: Sequence[np.ndarray], dtype=torch.float32,
                 device="cpu"):
    """(corners, lo, (canvas_h, canvas_w)) of the panorama of images of
    `image_shapes` placed by `globals_h`, computed in `dtype` on
    `device`: each image's corners (0, 0), (w, 0), (w, h), (0, h) mapped
    by its homography ((4, 2) tensors), the union's top-left corner `lo`
    (never right of or below the frame's origin), and the canvas, the
    ceiling of the union's extent."""
    corners = []
    for (h, w), g in zip(image_shapes, globals_h):
        c = _to_dtype([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], dtype,
                      device)
        p = c @ _to_dtype(g, dtype, device).T
        corners.append(p[:, :2] / p[:, 2:3])
    allc = torch.cat(corners)
    lo = torch.minimum(allc.min(0).values, torch.zeros((), dtype=dtype,
                                                       device=device))
    size = torch.ceil(allc.max(0).values - lo)
    return corners, lo, (int(size[1].float()), int(size[0].float()))


def canvas(image_shapes: Sequence[Tuple[int, int]],
           globals_h: Sequence[np.ndarray]) -> Tuple[int, int]:
    """(canvas_h, canvas_w) of the panorama of images of `image_shapes`
    placed by `globals_h`, as the reference draws it in float32."""
    return canvas_frame(image_shapes, globals_h)[2]


def panorama(images: Sequence[torch.Tensor], globals_h: Sequence[np.ndarray],
             dtype=torch.float32, anchor: int = 0) -> torch.Tensor:
    """The (canvas_h, canvas_w, 3) uint8 reference panorama of `images`
    (tensors on one device) placed by `globals_h` into image 0's frame,
    drawn in image `anchor`'s frame with its geometry and sampling
    computed in `dtype`: image `anchor` first, the others in order over
    it."""
    dev = images[0].device
    globals_h = in_frame(globals_h, anchor)
    corners, lo, (canvas_h, canvas_w) = canvas_frame(
        shapes(images), globals_h, dtype, dev)
    canvas_img = torch.zeros((canvas_h, canvas_w, 3), dtype=torch.uint8,
                             device=dev)
    shift = np.array([[1.0, 0.0, -float(lo[0].float())],
                      [0.0, 1.0, -float(lo[1].float())], [0.0, 0.0, 1.0]])
    order = [anchor] + [i for i in range(len(images)) if i != anchor]
    for i in order:
        img, g, cw = images[i], globals_h[i], corners[i]
        m_inv = _to_dtype(np.linalg.inv(shift @ np.asarray(g, np.float64)),
                          dtype, dev)
        cw = cw - lo
        x0 = max(int(math.floor(float(cw[:, 0].min().float()))), 0)
        y0 = max(int(math.floor(float(cw[:, 1].min().float()))), 0)
        x1 = min(int(math.ceil(float(cw[:, 0].max().float()))), canvas_w)
        y1 = min(int(math.ceil(float(cw[:, 1].max().float()))), canvas_h)
        if x1 <= x0 or y1 <= y0:
            continue
        _warp_over(canvas_img, img, m_inv, x0, y0, x1, y1, dtype)
    return canvas_img


def _warp_over(canvas, img, m_inv, x0, y0, x1, y1, dtype) -> None:
    """Bilinear inverse warp of `img` onto canvas[y0:y1, x0:x1], written
    where the sample lies inside the image and is not black."""
    dev = canvas.device
    h, w = img.shape[:2]
    ys = torch.arange(y0, y1, device=dev).to(dtype)[:, None]
    xs = torch.arange(x0, x1, device=dev).to(dtype)[None, :]
    den = m_inv[2, 0] * xs + m_inv[2, 1] * ys + m_inv[2, 2]
    sx = (m_inv[0, 0] * xs + m_inv[0, 1] * ys + m_inv[0, 2]) / den
    sy = (m_inv[1, 0] * xs + m_inv[1, 1] * ys + m_inv[1, 2]) / den
    inside = (sx >= 0) & (sy >= 0) & (sx <= w - 1) & (sy <= h - 1)
    fx0 = torch.floor(sx)
    fy0 = torch.floor(sy)
    ax = (sx - fx0)[..., None]
    ay = (sy - fy0)[..., None]
    ix0 = fx0.float().clamp(0, w - 1).long()
    iy0 = fy0.float().clamp(0, h - 1).long()
    ix1 = (ix0 + 1).clamp(max=w - 1)
    iy1 = (iy0 + 1).clamp(max=h - 1)
    src = img.to(dtype)
    one = torch.ones((), dtype=dtype, device=dev)
    val = ((one - ay) * ((one - ax) * src[iy0, ix0] + ax * src[iy0, ix1])
           + ay * ((one - ax) * src[iy1, ix0] + ax * src[iy1, ix1]))
    val = torch.round(val.float()).clamp(0, 255).to(torch.uint8)
    write = inside & val.ne(0).any(-1)
    region = canvas[y0:y1, x0:x1]
    region[write] = val[write]


def edge_band(shape, images, globals_h, anchor: int = 0) -> torch.Tensor:
    """(canvas_h, canvas_w) bool: the pixels whose centre lies within BAND
    px of an edge of an image but image `anchor`, the images placed by
    `globals_h` (into image 0's frame) in the anchor's frame, in a canvas
    whose origin is the union's top-left corner (``canvas_frame``). An
    edge is the segment between two of an image's projected corners, in
    the corners' coordinates (pixel (x, y)'s centre at (x + 0.5, y +
    0.5)): for a translation, the BAND rows or columns of pixels on each
    side of the line."""
    band = torch.zeros(shape, dtype=torch.bool)
    corners, lo, _ = canvas_frame(shapes(images), in_frame(globals_h, anchor),
                                  torch.float64)
    for i, c in enumerate(corners):
        if i == anchor:
            continue
        q = (c - lo).tolist()
        for a, b in zip(q, q[1:] + q[:1]):
            _band_segment(band, a, b)
    return band


BAND_ROWS = 64   # rows of a segment's band whose distances are taken at once


def _band_segment(band: torch.Tensor, a, b) -> None:
    """Set the pixels of `band` whose centre lies within BAND of the
    segment from `a` to `b` ((x, y) each), BAND_ROWS rows at a time, each
    over the columns where the segment passes those rows."""
    (ax, ay), (bx, by) = a, b
    ch, cw = band.shape
    dx, dy = bx - ax, by - ay
    length2 = dx * dx + dy * dy
    y0 = max(int(math.floor(min(ay, by) - BAND)), 0)
    y1 = min(int(math.ceil(max(ay, by) + BAND)), ch)
    for r0 in range(y0, y1, BAND_ROWS):
        r1 = min(r0 + BAND_ROWS, y1)
        # the part of the segment within BAND of these rows' centres
        lo_y, hi_y = r0 + 0.5 - BAND, r1 - 0.5 + BAND
        if dy == 0:
            t_lo, t_hi = 0.0, 1.0
        else:
            t_lo, t_hi = sorted(((lo_y - ay) / dy, (hi_y - ay) / dy))
            t_lo, t_hi = max(t_lo, 0.0), min(t_hi, 1.0)
        if t_lo > t_hi:
            continue
        xs = (ax + t_lo * dx, ax + t_hi * dx)
        x0 = max(int(math.floor(min(xs) - BAND)), 0)
        x1 = min(int(math.ceil(max(xs) + BAND)), cw)
        if x1 <= x0:
            continue
        px = torch.arange(x0, x1, dtype=torch.float64)[None, :] + 0.5
        py = torch.arange(r0, r1, dtype=torch.float64)[:, None] + 0.5
        t = ((px - ax) * dx + (py - ay) * dy) / length2 if length2 > 0 \
            else torch.zeros(())
        t = t.clamp(0.0, 1.0)
        ex, ey = px - (ax + t * dx), py - (ay + t * dy)
        band[r0:r1, x0:x1] |= ex * ex + ey * ey < BAND * BAND


def compare_panorama(pano, ref: torch.Tensor, band: torch.Tensor) -> Dict:
    """canvas_px and pixel_max_d of one panorama (a tensor or host
    numpy) against the reference `ref` and its `band`."""
    got = torch.as_tensor(pano).to(ref.device)
    canvas_px = max(abs(int(got.shape[0]) - int(ref.shape[0])),
                    abs(int(got.shape[1]) - int(ref.shape[1])))
    h = min(int(got.shape[0]), int(ref.shape[0]))
    w = min(int(got.shape[1]), int(ref.shape[1]))
    d = (got[:h, :w].int() - ref[:h, :w].int()).abs().amax(-1)
    keep = ~band[:h, :w].to(ref.device)
    pixel = int(d[keep].max()) if bool(keep.any()) else 0
    return {"canvas_px": canvas_px, "pixel_max_d": pixel}


def judge(answers: List[dict], pool, limits: dict,
          dtype=torch.float32) -> dict:
    """The numbers compared, each with its limit, over `answers`.

    Each answer is {"scene": pool index, "placed": [H of each image into
    image 0's frame, None for an image left out] or None when the
    panorama came back empty, "pano": the panorama (host numpy or a
    tensor) for the sampled ones, else None, and optionally "anchor":
    the image the entry framed the panorama in, 0 when absent}. An entry
    that frames it in another image's frame has its placements converted
    into image 0's by its loop (``inv(g_0) @ g_i``; all None when image 0
    was left out). The reference of each sampled scene is drawn once per
    anchor, in `dtype`, on the device of the scene's images (the first
    CUDA device for host-resident pools, where there is one).
    "failed_at" lists the indices of the answers that failed."""
    h_err, missing, canvas_px, pixel = 0.0, 0, 0, 0
    refs: Dict[tuple, tuple] = {}
    bad: List[int] = []
    for i, a in enumerate(answers):
        scene = pool[a["scene"]]
        if a["placed"] is None:
            missing += 1
            bad.append(i)
            continue
        truth = planted_globals(scene)
        e = max(corner_error(hp, ht, *_hw(img)) for hp, ht, img
                in zip(_padded(a["placed"], len(truth)), truth,
                       scene.images))
        h_err = max(h_err, e)
        worst = e > limits["h_err_px"]
        if a.get("pano") is not None:
            key = (a["scene"], a.get("anchor", 0))
            if key not in refs:
                imgs = [_device_image(img) for img in scene.images]
                ref = panorama(imgs, truth, dtype, key[1])
                refs[key] = (ref, edge_band(ref.shape[:2], imgs, truth,
                                            key[1]))
            ref, band = refs[key]
            got = compare_panorama(a["pano"], ref, band)
            canvas_px = max(canvas_px, got["canvas_px"])
            pixel = max(pixel, got["pixel_max_d"])
            worst = worst or got["canvas_px"] > limits["canvas_px"] \
                or got["pixel_max_d"] > limits["pixel_max_d"]
        if worst:
            bad.append(i)
    return {
        "failed": len(bad),
        "failed_at": bad,
        "compared": {
            "h_err_px": {"value": h_err, "limit": limits["h_err_px"]},
            "canvas_px": {"value": canvas_px, "limit": limits["canvas_px"]},
            "pixel_max_d": {"value": pixel, "limit": limits["pixel_max_d"]},
            "missing": {"value": missing, "limit": 0},
        },
    }


def _padded(placed: list, n: int) -> list:
    return list(placed[:n]) + [None] * (n - len(placed))


def _hw(img):
    return int(img.shape[0]), int(img.shape[1])


def _device_image(img) -> torch.Tensor:
    if isinstance(img, np.ndarray):
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        return torch.from_numpy(img).to(dev)
    return img


def within(compared: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in compared.values())
