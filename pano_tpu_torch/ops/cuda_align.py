"""K11: the Gauss-Newton passes of the direct alignment
(``csrc/align.cu``) and their plain version.

Replaces no ``pallas_call``: the JAX package has no direct alignment. The
port added it (``ops/align.py``) for a camera that rotates about its
centre, where the refine's homography, fitted to Harris corners found at
whole pixels, lands tenths of a pixel off over the overlap and several
pixels off at the far corners of the right image.

One pass over the right image, for the parameters p (the homography in
the normalized frames of ``frame``, its last entry 1): each right pixel
(u, v) that p maps inside the left image gives the residual r = L(x, y)
- R(u, v) of the gray images (BT.601 weights, unrounded), L sampled
bilinearly, and its Jacobian J (1 x 8) by the bilinear sample's
gradient; the pass sums J^T J (the 36 entries of its upper triangle),
J^T r, r^2 and the pixel count in float64, solves J^T J d = -J^T r (8x8,
Gauss-Jordan with partial pivoting, ``cuda_ransac._solve8``'s order) and
adds d to p. A solve with a non-finite entry leaves p as it is and sets
the state's singular flag for good.

The state (16 float64, ``STATE``): p (8), then the mean squared residual
and the pixel count at the first pass's p and at the last pass's
(``E_START``, ``N_START``, ``E_END``, ``N_END``), then the singular flag
(``SINGULAR``). ``gauss_newton`` runs `iterations` passes that update and
one more that only measures, a fixed amount of work with no early stop.

``gauss_newton`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (one C call, `iterations` + 1 launches); any
other device raises. The per-pixel arithmetic is float32 in one order,
which the kernel repeats under ``-fmad=false``; the sums are float64 in
the kernel's own fixed order (a thread's pixels in turn, a warp's lanes
by a shuffle tree, the warps, then the blocks), not the plain version's,
so the two agree to the rounding of float64 sums, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops.cuda_ransac import _solve8

# Kernel launches since the last reset (a pass is a launch): tests and
# chip_smoke.py read it. A replay of RANSAC's CUDA graph adds the
# launches the graph holds (ops/ransac.py).
launches = 0

STATE = 16
E_START, E_END, N_START, N_END, SINGULAR = 8, 9, 10, 11, 12
# The kernel's fixed grid (csrc/align.cu) and the float64 sums a block
# hands over: the upper triangle of J^T J (36), J^T r (8), r^2 and the
# count.
BLOCKS = 396
SUMS = 46


class Frame(NamedTuple):
    """The normalized frames: image pixel (x, y) is ((x - cx) / s, (y -
    cy) / s), with the centre (cx, cy) of each image and one scale s for
    both, so that the 8x8 system is well conditioned. Every number is a
    float32 value (the kernel takes them as floats)."""
    s: float
    inv_s: float
    cxl: float
    cyl: float
    cxr: float
    cyr: float


def frame(left_hw: Tuple[int, int], right_hw: Tuple[int, int]) -> Frame:
    (hl, wl), (hr, wr) = left_hw, right_hw
    s = max(hl, wl, hr, wr) / 2.0
    inv_s = float(np.float32(1.0) / np.float32(s))
    return Frame(s, inv_s, (wl - 1) / 2.0, (hl - 1) / 2.0, (wr - 1) / 2.0,
                 (hr - 1) / 2.0)


def gray(img_u8: torch.Tensor) -> torch.Tensor:
    """(h, w) float32 gray of an (h, w, 3) uint8 BGR image: (0.114 b +
    0.587 g) + 0.299 r, unrounded."""
    f = img_u8.float()
    return (0.114 * f[..., 0] + 0.587 * f[..., 1]) + 0.299 * f[..., 2]


def pass_terms(p: torch.Tensor, gl: torch.Tensor, gr: torch.Tensor,
               fr: Frame):
    """The float32 per-pixel terms of one pass at the parameters `p` (8,)
    float64 over the grays `gl` (left) and `gr` (right): (J (hr, wr, 8),
    r (hr, wr), ok (hr, wr) bool, the right pixels that `p` maps inside
    the left image), in the kernel's order of operations."""
    hl, wl = gl.shape
    hr, wr = gr.shape
    pa, pb, pc, pd, pe, pf, pg, ph = p.float().unbind()
    u = torch.arange(wr, dtype=torch.float32, device=gr.device)[None, :]
    v = torch.arange(hr, dtype=torch.float32, device=gr.device)[:, None]
    un = (u - fr.cxr) * fr.inv_s
    vn = (v - fr.cyr) * fr.inv_s
    w = (pg * un + ph * vn) + 1.0
    xn = ((pa * un + pb * vn) + pc) / w
    yn = ((pd * un + pe * vn) + pf) / w
    x = xn * fr.s + fr.cxl
    y = yn * fr.s + fr.cyl
    ok = (w > 0) & (x >= 0) & (y >= 0) & (x < wl - 1) & (y < hl - 1)
    fx, fy = torch.floor(x), torch.floor(y)
    ax, ay = x - fx, y - fy
    ix = fx.clamp(0, wl - 2).long()
    iy = fy.clamp(0, hl - 2).long()
    t00, t01 = gl[iy, ix], gl[iy, ix + 1]
    t10, t11 = gl[iy + 1, ix], gl[iy + 1, ix + 1]
    d0, d1 = t01 - t00, t11 - t10
    top = t00 + ax * d0
    bottom = t10 + ax * d1
    r = (top + ay * (bottom - top)) - gr
    lx = (d0 + ay * (d1 - d0)) * fr.s
    ly = (bottom - top) * fr.s
    iw = torch.ones_like(w) / w          # a true division, as the kernel's
    q = -(lx * xn + ly * yn)
    a0, a1, a2 = lx * iw, ly * iw, q * iw
    j = torch.stack([a0 * un, a0 * vn, a0, a1 * un, a1 * vn, a1, a2 * un,
                     a2 * vn], -1)
    return j, r, ok


def gauss_newton_plain(p0: torch.Tensor, left: torch.Tensor,
                       right: torch.Tensor, iterations: int,
                       fr: Frame) -> torch.Tensor:
    """The passes in plain torch, with no host read: the (16,) float64
    state (see the module's docstring)."""
    gl, gr = gray(left), gray(right)
    p = p0.to(torch.float64)
    singular = torch.zeros((), dtype=torch.bool, device=p.device)
    e_start = n_start = None
    for k in range(iterations + 1):
        j, r, ok = pass_terms(p, gl, gr, fr)
        # Pixels outside the overlap add nothing (their terms may be inf).
        jd = torch.where(ok[..., None], j, 0.0).reshape(-1, 8).double()
        rd = torch.where(ok, r, 0.0).reshape(-1).double()
        n = ok.sum().double()
        mse = (rd * rd).sum() / n
        if k == 0:
            e_start, n_start = mse, n
        if k == iterations:
            break
        d = _solve8((jd.T @ jd)[None], -(jd.T @ rd)[None])[0]
        singular = singular | ~torch.isfinite(d).all()
        p = torch.where(singular, p, p + d)
    return torch.cat([p, torch.stack([e_start, mse, n_start, n,
                                      singular.to(torch.float64)]),
                      torch.zeros(STATE - 13, dtype=torch.float64,
                                  device=p.device)])


def gauss_newton(p0: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                 iterations: int, fr: Frame) -> torch.Tensor:
    """`iterations` Gauss-Newton passes from `p0` (8,) float64 and one
    that measures, over `left` and `right` (h, w, 3) uint8: the (16,)
    float64 state. On the GPU one C call, `iterations` + 1 launches, with
    no host sync."""
    for name, img in (("left", left), ("right", right)):
        if (img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3
                or img.shape[0] < 2 or img.shape[1] < 2):
            raise ValueError(f"align: want an (h >= 2, w >= 2, 3) uint8 "
                             f"{name} image, got {tuple(img.shape)} "
                             f"{img.dtype}")
    if left.shape[0] * left.shape[1] >= 2 ** 31 \
            or right.shape[0] * right.shape[1] >= 2 ** 31:
        raise ValueError("align: the kernel indexes pixels in 32 bits")
    if p0.shape != (8,) or iterations < 1:
        raise ValueError(f"align: want (8,) parameters and iterations >= 1, "
                         f"got {tuple(p0.shape)}, {iterations}")
    if left.device.type == "cpu":
        return gauss_newton_plain(p0, left, right, iterations, fr)
    if left.device.type != "cuda":
        raise ValueError(f"align: unsupported device {left.device}")
    dev = left.device
    left, right = left.contiguous(), right.contiguous()
    state = torch.cat([p0.to(device=dev, dtype=torch.float64),
                       torch.zeros(STATE - 8, dtype=torch.float64,
                                   device=dev)])
    # The blocks' partial sums and the last block's ticket (zeroed by the
    # C entry before the first pass, reset by each pass's last block).
    scratch = torch.empty(BLOCKS * SUMS + 1, dtype=torch.float64, device=dev)
    global launches
    _build.launch("pano_align_gauss_newton", dev, left.data_ptr(),
                  right.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                  left.shape[0], left.shape[1], right.shape[0],
                  right.shape[1], fr.s, fr.inv_s, fr.cxl, fr.cyl, fr.cxr,
                  fr.cyr, iterations + 1)
    launches += iterations + 1
    return state
