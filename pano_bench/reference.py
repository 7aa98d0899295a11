"""The plain reference, and the comparison that decides ``correct``.

The reference imports nothing of the program and takes nothing it made:
from a scene's images and their planted homographies it draws the
panorama that the stitch's semantics demand. The canvas is the ceiling
of the union of the warped image rectangles in image 0's frame (the
union, and so the canvas, is the same in any image's frame); each image
is warped onto it through the inverse of its homography with bilinear
sampling, the anchor (image 0 unless the answer names another) first
and the others in order over it, a black sample letting the canvas show
through (the reference's overlay). Every image is a crop of one scene,
so any blend of the pixels that overlap is that scene's pixel: the same
drawing is the reference of overlay, feather and multiband alike, and
where they depart from it near a seam is what the pixel limit allows.

``dtype`` is the precision of the geometry and the sampling: float32,
the configuration's, for the reference; bfloat16, the next below, for
the control that must come out not correct.

Numbers compared, each against its limit from ``limits/<config>.json``:

* ``h_err_px``: over every panorama of the window, the largest distance
  (px) by which a corner of a placed image lands away from its planted
  place, through the homography that the panorama was placed with;
* ``canvas_px``: over the sampled panoramas, the largest difference of
  the canvas's height or width from the reference's;
* ``pixel_max_d``: over the sampled panoramas, the largest difference of
  a channel from the reference's, over their common extent, outside a
  band of 2 px across the edge of each placed image but the anchor (an
  estimate a thousandth of a pixel off samples a sliver of the black
  outside there; the anchor is copied, not sampled);
* ``missing``: panoramas that came back empty (None).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

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


def panorama(images: Sequence[torch.Tensor], globals_h: Sequence[np.ndarray],
             dtype=torch.float32, anchor: int = 0) -> torch.Tensor:
    """The (canvas_h, canvas_w, 3) uint8 reference panorama of `images`
    (tensors on one device) placed by `globals_h` into image 0's frame,
    its geometry and sampling computed in `dtype`: image `anchor` drawn
    first, the others in order over it."""
    dev = images[0].device
    corners = []
    for img, g in zip(images, globals_h):
        h, w = img.shape[:2]
        c = _to_dtype([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], dtype,
                      dev)
        p = c @ _to_dtype(g, dtype, dev).T
        corners.append(p[:, :2] / p[:, 2:3])
    allc = torch.cat(corners)
    lo = torch.minimum(allc.min(0).values, torch.zeros((), dtype=dtype,
                                                       device=dev))
    hi = allc.max(0).values
    size = torch.ceil(hi - lo)
    canvas_w, canvas_h = int(size[0].float()), int(size[1].float())
    canvas = torch.zeros((canvas_h, canvas_w, 3), dtype=torch.uint8,
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
        _warp_over(canvas, img, m_inv, x0, y0, x1, y1, dtype)
    return canvas


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
    """(canvas_h, canvas_w) bool: BAND px on each side of the edges of
    each image but image `anchor`, placed by the translations `globals_h`
    (planted ones) in a canvas whose origin is the union's top-left
    corner."""
    ch, cw = shape
    band = torch.zeros((ch, cw), dtype=torch.bool)
    lo_x = min(0.0, min(float(g[0, 2]) for g in globals_h))
    lo_y = min(0.0, min(float(g[1, 2]) for g in globals_h))
    for i, (img, g) in enumerate(zip(images, globals_h)):
        if i == anchor:
            continue
        h, w = img.shape[:2]
        x0 = int(round(float(g[0, 2]) - lo_x))
        y0 = int(round(float(g[1, 2]) - lo_y))
        xa, xb = max(x0 - BAND, 0), min(x0 + w + BAND, cw)
        ya, yb = max(y0 - BAND, 0), min(y0 + h + BAND, ch)
        for r in (y0, y0 + h):
            band[max(r - BAND, 0):max(r + BAND, 0), xa:xb] = True
        for c in (x0, x0 + w):
            band[ya:yb, max(c - BAND, 0):max(c + BAND, 0)] = True
    return band


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
    CUDA device for host-resident pools, where there is one)."""
    h_err, missing, canvas_px, pixel = 0.0, 0, 0, 0
    refs: Dict[tuple, tuple] = {}
    bad = 0
    for a in answers:
        scene = pool[a["scene"]]
        if a["placed"] is None:
            missing += 1
            bad += 1
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
        bad += int(worst)
    return {
        "failed": bad,
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
