"""rotating: each scene is what a camera rotating about its centre sees of
one seeded scene on the sphere around it, so that image j is placed in
image i's frame by H_ij = K R_i R_j^T K^-1 (Brown and Lowe, IJCV 74(1),
2007, section 2).

The camera (``intrinsics``): a pinhole with square pixels and no lens
distortion (assumed), the principal point at ((w - 1) / 2, (h - 1) / 2)
with pixel centres at integer coordinates, and f = (w / 2) / tan(hfov /
2). Image i's orientation (``rotation``, world to camera; x right, y
down, z forward) is R_i = R_z(roll) R_x(pitch) R_y(yaw): a positive yaw
turns the camera right, a positive pitch down.

The scene: an equirectangular texture (``scenes.texture``, from the
seed's generator) over the longitudes and latitudes that the images'
border pixels see, MARGIN texels more each way, one texel per 1/f rad.
Image i (``render``): each pixel p's ray R_i^T K^-1 p in float64, its
longitude atan2(x, z) and latitude atan2(y, hypot(x, z)), the texture
sampled there bilinearly and rounded to uint8, every pixel of the image
at once on the pool's device. Planted: G_i = K R_0 R_i^T K^-1 (G_0 the
identity), exact for a camera rotating about its centre whatever the
depth of what it sees.

Traffic: "hfov_deg", and "scenes", each a list of the images'
[yaw_deg, pitch_deg, roll_deg] in hand-over order. Configuration:
"image_h", "image_w". Every image's corners must lie less than 90
degrees off image 0's axis (else no homography places it in image 0's
frame), and a scene may span less than 180 degrees of longitude.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pano_bench import scenes

MARGIN = 4   # texels of texture beyond the rays of the images' borders


def intrinsics(h: int, w: int, hfov_deg: float) -> np.ndarray:
    """K of an (h, w) image with a horizontal field of view of
    `hfov_deg` degrees."""
    f = (w / 2.0) / math.tan(math.radians(hfov_deg) / 2.0)
    return np.array([[f, 0.0, (w - 1) / 2.0], [0.0, f, (h - 1) / 2.0],
                     [0.0, 0.0, 1.0]])


def rotation(yaw_deg: float, pitch_deg: float, roll_deg: float
             ) -> np.ndarray:
    """R_z(roll) R_x(pitch) R_y(yaw), world to camera, angles in
    degrees."""
    y, p, r = (math.radians(float(a)) for a in (yaw_deg, pitch_deg,
                                                 roll_deg))
    r_y = np.array([[math.cos(y), 0.0, -math.sin(y)], [0.0, 1.0, 0.0],
                    [math.sin(y), 0.0, math.cos(y)]])
    r_x = np.array([[1.0, 0.0, 0.0], [0.0, math.cos(p), -math.sin(p)],
                    [0.0, math.sin(p), math.cos(p)]])
    r_z = np.array([[math.cos(r), -math.sin(r), 0.0],
                    [math.sin(r), math.cos(r), 0.0], [0.0, 0.0, 1.0]])
    return r_z @ r_x @ r_y


def planted_homographies(k: np.ndarray, rots: Sequence[np.ndarray]
                         ) -> List[np.ndarray]:
    """G_i = K R_0 R_i^T K^-1, each image's homography into image 0's
    frame; G_0 the identity."""
    k_inv = np.linalg.inv(k)
    return [np.eye(3)] + [k @ rots[0] @ r.T @ k_inv for r in rots[1:]]


def lon_lat(k: np.ndarray, rot: np.ndarray, u: torch.Tensor,
            v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Longitude and latitude (rad) of the rays R^T K^-1 (u, v, 1) of the
    camera (k, rot), for float64 pixel coordinates `u`, `v`."""
    m = rot.T @ np.linalg.inv(k)
    x = m[0, 0] * u + m[0, 1] * v + m[0, 2]
    y = m[1, 0] * u + m[1, 1] * v + m[1, 2]
    z = m[2, 0] * u + m[2, 1] * v + m[2, 2]
    return torch.atan2(x, z), torch.atan2(y, torch.hypot(x, z))


def _border(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) of an (h, w) image's border pixels, float64."""
    us = torch.arange(w, dtype=torch.float64, device=device)
    vs = torch.arange(h, dtype=torch.float64, device=device)
    u = torch.cat([us, us, torch.zeros_like(vs), torch.full_like(vs, w - 1)])
    v = torch.cat([torch.zeros_like(us), torch.full_like(us, h - 1), vs, vs])
    return u, v


def _check(planted: Sequence[np.ndarray], h: int, w: int,
           lon_span: float) -> None:
    c = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64)
    if any((c @ g.T)[:, 2].min() <= 0 for g in planted) \
            or lon_span >= math.pi:
        raise ValueError("rotating: an image's corner lies 90 degrees or "
                         "more off image 0's axis, or the scene spans 180 "
                         "degrees of longitude or more")


def render(k: np.ndarray, rots: Sequence[np.ndarray], h: int, w: int,
           gen: torch.Generator, device) -> List[torch.Tensor]:
    """The (h, w, 3) uint8 images that the cameras (k, rots) see of one
    texture drawn with `gen`, on `device`."""
    f = float(k[0, 0])
    lons, lats = zip(*(lon_lat(k, r, *_border(h, w, device)) for r in rots))
    lon_lo = min(float(a.min()) for a in lons)
    lon_hi = max(float(a.max()) for a in lons)
    lat_lo = min(float(a.min()) for a in lats)
    lat_hi = max(float(a.max()) for a in lats)
    _check(planted_homographies(k, rots), h, w, lon_hi - lon_lo)
    lon0, lat0 = lon_lo - MARGIN / f, lat_lo - MARGIN / f
    tw = int(math.ceil((lon_hi - lon_lo) * f)) + 2 * MARGIN + 2
    th = int(math.ceil((lat_hi - lat_lo) * f)) + 2 * MARGIN + 2
    tex = scenes.texture(th, tw, gen, device)
    u = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    v = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    out = []
    for r in rots:
        lon, lat = lon_lat(k, r, u, v)
        tx, ty = (lon - lon0) * f, (lat - lat0) * f
        fx0, fy0 = torch.floor(tx), torch.floor(ty)
        ax, ay = (tx - fx0)[..., None], (ty - fy0)[..., None]
        x0 = fx0.long().clamp(0, tw - 2)
        y0 = fy0.long().clamp(0, th - 2)
        t00, t01 = tex[y0, x0].double(), tex[y0, x0 + 1].double()
        t10, t11 = tex[y0 + 1, x0].double(), tex[y0 + 1, x0 + 1].double()
        val = (1 - ay) * ((1 - ax) * t00 + ax * t01) \
            + ay * ((1 - ax) * t10 + ax * t11)
        out.append(torch.round(val).clamp(0, 255).to(torch.uint8))
    return out


def make_pool(traffic: dict, cfg: dict, seed: int, device, resident: str
              ) -> List[scenes.Scene]:
    """The traffic's scenes of poses in an order drawn from `seed`, each
    rendered from its own texture, with their planted homographies."""
    h, w = int(cfg["image_h"]), int(cfg["image_w"])
    k = intrinsics(h, w, float(traffic["hfov_deg"]))
    gen = scenes.generator(seed, device)
    pool = []
    for s in scenes.pool_order(len(traffic["scenes"]), seed):
        rots = [rotation(*pose) for pose in traffic["scenes"][s]]
        imgs = render(k, rots, h, w, gen, device)
        pool.append(scenes.Scene(scenes.resident_images(imgs, resident),
                                 None,
                                 tuple(planted_homographies(k, rots))))
    return pool
