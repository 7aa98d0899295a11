"""A plain float64 reference of the direct alignment, for the CPU tests.

Gauss-Newton on the 8 parameters of a homography H (right -> left, h33 =
1) in centred, scaled image frames, over the photometric residual
L(H p) - R(p) of the two images' grays (BT.601 weights, unrounded) at
every right pixel p that H places inside the left image, L sampled
bilinearly and differentiated as the bilinear sample; a fixed number of
iterations, each solving the normal equations with
``torch.linalg.solve``, then one more measure of the mean squared
residual. The result is kept only if no solve failed, it is finite and
its mean squared residual does not exceed the start's; else H comes back
as given.

Everything is float64 and written from the method's statement, in plain
torch: it imports neither JAX nor any kernel or module of the port, and
turns TF32 off for its products.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gray(img_u8: torch.Tensor) -> torch.Tensor:
    f = img_u8.to(torch.float64)
    return 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]


def _frames(left_hw, right_hw):
    """(Tl, Tr): pixel -> normalized frame of each image, one scale."""
    (hl, wl), (hr, wr) = left_hw, right_hw
    s = max(hl, wl, hr, wr) / 2.0

    def t(h, w):
        return np.array([[1 / s, 0, -(w - 1) / 2 / s],
                         [0, 1 / s, -(h - 1) / 2 / s], [0, 0, 1.0]])
    return t(hl, wl), t(hr, wr)


def _terms(p, gl, gr, tl, tr):
    """Residuals, Jacobian rows and the overlap mask at parameters p."""
    hl, wl = gl.shape
    hr, wr = gr.shape
    v, u = torch.meshgrid(torch.arange(hr, dtype=torch.float64),
                          torch.arange(wr, dtype=torch.float64),
                          indexing="ij")
    un = tr[0, 0] * u + tr[0, 2]
    vn = tr[1, 1] * v + tr[1, 2]
    a, b, c, d, e, f, g, h = (float(x) for x in p)
    w = g * un + h * vn + 1.0
    xn = (a * un + b * vn + c) / w
    yn = (d * un + e * vn + f) / w
    x = (xn - tl[0, 2]) / tl[0, 0]
    y = (yn - tl[1, 2]) / tl[1, 1]
    ok = (w > 0) & (x >= 0) & (y >= 0) & (x < wl - 1) & (y < hl - 1)
    x0 = torch.floor(x).clamp(0, wl - 2).long()
    y0 = torch.floor(y).clamp(0, hl - 2).long()
    ax, ay = x - x0, y - y0
    t00, t01 = gl[y0, x0], gl[y0, x0 + 1]
    t10, t11 = gl[y0 + 1, x0], gl[y0 + 1, x0 + 1]
    val = (1 - ay) * ((1 - ax) * t00 + ax * t01) \
        + ay * ((1 - ax) * t10 + ax * t11)
    # d val / d xn, d val / d yn: the bilinear sample's gradient, in the
    # normalized frame
    gx = ((1 - ay) * (t01 - t00) + ay * (t11 - t10)) / tl[0, 0]
    gy = ((1 - ax) * (t10 - t00) + ax * (t11 - t01)) / tl[1, 1]
    q = -(gx * xn + gy * yn)
    jac = torch.stack([gx * un, gx * vn, gx, gy * un, gy * vn, gy,
                       q * un, q * vn], -1) / w[..., None]
    return (val - gr)[ok], jac[ok], int(ok.sum())


def align_reference(h: np.ndarray, left: torch.Tensor, right: torch.Tensor,
                    iterations: int) -> np.ndarray:
    """H (3, 3) float64 right -> left aligned on the (h, w, 3) uint8
    images by `iterations` Gauss-Newton iterations, or `h` itself where
    the guard refuses the result."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        gl, gr = gray(left.cpu()), gray(right.cpu())
        tl, tr = _frames(gl.shape, gr.shape)
        hn = tl @ np.asarray(h, np.float64) @ np.linalg.inv(tr)
        p = torch.from_numpy((hn / hn[2, 2]).reshape(-1)[:8].copy())
        singular = False
        for k in range(iterations + 1):
            r, jac, n = _terms(p, gl, gr, tl, tr)
            mse = float((r * r).sum()) / n if n else math.nan
            if k == 0:
                start = mse
            if k == iterations:
                break
            try:
                d = torch.linalg.solve(jac.T @ jac, -(jac.T @ r))
            except RuntimeError:        # singular
                singular = True
                break
            if not bool(torch.isfinite(d).all()):
                singular = True
                break
            p = p + d
        hn = np.append(p.numpy(), 1.0).reshape(3, 3)
        out = np.linalg.inv(tl) @ hn @ tr
        out = out / out[2, 2]
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    if singular or not np.isfinite(out).all() or not mse <= start:
        return np.asarray(h, np.float64)
    return out
