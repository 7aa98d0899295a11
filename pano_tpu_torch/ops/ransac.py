"""RANSAC homography estimation, all hypotheses at once.

Counterpart of ``pano_tpu/ops/ransac.py``: every hypothesis of the JAX
package's ``vmap`` is a row of a leading batch dimension here. Hartley-
normalized 4-point DLT by unrolled Gauss-Jordan, one broadcast scoring
pass over (N, M), argmax, then the degeneracy guard and the masked
least-squares refine through a 9x9 eigendecomposition. Everything is
float32; the package turns TF32 off, so the small matrix products are
true fp32.

Sampling: ``jax.random`` cannot be reproduced by ``torch.Generator``.
``ransac_best_hypothesis`` takes an optional ``sampler(n_valid) -> (N, 4)
int64`` table of indices into the compacted valid range; the default
draws with ``torch.randint`` from a generator seeded with
``RansacOptions.seed`` on the points' device (no host sync: the draw is
reduced modulo ``n_valid`` on the device).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from pano_tpu_torch.config import RansacOptions

Sampler = Callable[[torch.Tensor], torch.Tensor]


class RansacResult(NamedTuple):
    H: torch.Tensor             # (3, 3) float32, normalized so H[2,2] = 1
    inlier_count: torch.Tensor  # () int32
    num_matches: torch.Tensor   # () int32, valid matches scored
    inlier_mask: torch.Tensor   # (M,) bool, inliers of the final H
    ok: torch.Tensor            # () bool, inlier_count >= min_inliers


def _normalization_transform(
    pts: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Hartley similarity for masked points, batched over leading dims:
    pts (..., M, 2), mask (..., M) -> (..., 3, 3)."""
    m = mask.to(pts.dtype)
    cnt = torch.clamp(m.sum(-1), min=1.0)
    mean = (pts * m[..., None]).sum(-2) / cnt[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
    mean_d = (d * m).sum(-1) / cnt
    s = torch.sqrt(torch.tensor(2.0, dtype=pts.dtype, device=pts.device)) \
        / torch.clamp(mean_d, min=1e-8)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    rows = [
        torch.stack([s, zero, -s * mean[..., 0]], -1),
        torch.stack([zero, s, -s * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ]
    return torch.stack(rows, -2)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / determinant), batched."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], -1),
            torch.stack([co10, co11, co12], -1),
            torch.stack([co20, co21, co22], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def _solve8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 8x8 solve, a (..., 8, 8), b (..., 8), by unrolled
    Gauss-Jordan with partial pivoting. Singular systems give inf/nan."""
    m = torch.cat([a, b[..., None]], dim=-1)               # (..., 8, 9)
    rows = torch.arange(8, device=a.device)
    neg_inf = torch.tensor(float("-inf"), dtype=a.dtype, device=a.device)
    for col in range(8):
        mag = torch.where(rows >= col, m[..., :, col].abs(), neg_inf)
        piv = torch.argmax(mag, dim=-1)                    # (...,)
        is_piv = (rows == piv[..., None])[..., None]       # (..., 8, 1)
        row_c = m[..., col, :]
        row_p = torch.where(is_piv, m, torch.zeros_like(m)).sum(-2)
        m = torch.where(
            (rows == col)[:, None],
            row_p[..., None, :],
            torch.where(is_piv, row_c[..., None, :], m),
        )
        factor = m[..., :, col] / m[..., col, col][..., None]
        factor = torch.where(rows == col, torch.zeros_like(factor), factor)
        m = m - factor[..., None] * m[..., col, :][..., None, :]
    return m[..., :, 8] / torch.diagonal(m[..., :, :8], dim1=-2, dim2=-1)


def _apply_similarity(t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts @ t[:2, :2].T + t[:2, 2], batched."""
    return pts @ t[..., :2, :2].transpose(-1, -2) + t[..., None, :2, 2]


def homography_from_4pts(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homographies from 4 correspondences, src/dst (..., 4, 2)."""
    ones4 = torch.ones(src.shape[:-1], dtype=torch.bool, device=src.device)
    t_src = _normalization_transform(src, ones4)
    t_dst = _normalization_transform(dst, ones4)
    sn = _apply_similarity(t_src, src)
    dn = _apply_similarity(t_dst, dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_u = torch.stack(
        [x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1
    )
    rows_v = torch.stack(
        [zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1
    )
    a = torch.cat([rows_u, rows_v], dim=-2)                # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)                          # (..., 8)
    h8 = _solve8(a, b)
    h = torch.cat([h8, torch.ones_like(h8[..., :1])], -1)
    h = h.reshape(h8.shape[:-1] + (3, 3))
    h_full = inv3x3(t_dst) @ h @ t_src
    return h_full / h_full[..., 2:3, 2:3]


def project_points(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a homography to (M, 2) points."""
    w = h[2, 0] * pts[:, 0] + h[2, 1] * pts[:, 1] + h[2, 2]
    px = (h[0, 0] * pts[:, 0] + h[0, 1] * pts[:, 1] + h[0, 2]) / w
    py = (h[1, 0] * pts[:, 0] + h[1, 1] * pts[:, 1] + h[1, 2]) / w
    return torch.stack([px, py], -1)


def _score_hypotheses(hs, src, dst, valid, thresh: float) -> torch.Tensor:
    """Inlier count per hypothesis in one broadcast pass -> (N,) int32."""
    x, y = src[:, 0], src[:, 1]
    w = hs[:, 2, 0, None] * x + hs[:, 2, 1, None] * y + hs[:, 2, 2, None]
    px = (hs[:, 0, 0, None] * x + hs[:, 0, 1, None] * y
          + hs[:, 0, 2, None]) / w
    py = (hs[:, 1, 0, None] * x + hs[:, 1, 1, None] * y
          + hs[:, 1, 2, None]) / w
    d2 = (px - dst[None, :, 0]) ** 2 + (py - dst[None, :, 1]) ** 2
    is_in = (d2 < thresh * thresh) & valid[None, :]  # NaN compares False
    return is_in.sum(dim=1, dtype=torch.int32)


def _inlier_mask(h, src, dst, valid, thresh: float) -> torch.Tensor:
    d2 = ((project_points(h, src) - dst) ** 2).sum(-1)
    return (d2 < thresh * thresh) & valid


def refine_homography(src, dst, mask) -> torch.Tensor:
    """Least-squares DLT over all masked correspondences: the eigenvector
    of A^T A (9x9) with the smallest eigenvalue."""
    t_src = _normalization_transform(src, mask)
    t_dst = _normalization_transform(dst, mask)
    sn = _apply_similarity(t_src, src)
    dn = _apply_similarity(t_dst, dst)
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    m = mask.to(src.dtype)[:, None]
    r1 = torch.stack(
        [-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], -1
    ) * m
    r2 = torch.stack(
        [zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], -1
    ) * m
    a = torch.cat([r1, r2], 0)                              # (2M, 9)
    _, vecs = torch.linalg.eigh(a.T @ a)
    h = vecs[:, 0].reshape(3, 3)
    h_full = inv3x3(t_dst) @ h @ t_src
    return h_full / h_full[2, 2]


def default_sampler(
    num_iterations: int, num_samples: int, seed: int, device
) -> Sampler:
    """torch.randint from a generator seeded with `seed`, reduced modulo
    n_valid on the device. A fresh generator per sampler keeps every
    stitch of the same pair identical."""

    def sample(n_valid: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        raw = torch.randint(
            0, 2**62, (num_iterations, num_samples), generator=gen,
            device=device,
        )
        return raw % torch.clamp(n_valid.to(torch.int64), min=1)

    return sample


def ransac_best_hypothesis(
    pts_src: torch.Tensor,
    pts_dst: torch.Tensor,
    valid: torch.Tensor,
    num_iterations: int,
    num_samples: int,
    distance_threshold: float,
    sampler: Sampler,
):
    """Score `num_iterations` hypotheses; return (best_H (3,3), count ())."""
    n_valid = valid.sum(dtype=torch.int32)
    idx = sampler(n_valid).to(device=pts_src.device, dtype=torch.int64)
    if idx.shape != (num_iterations, num_samples):
        raise ValueError(
            f"sampler returned {tuple(idx.shape)}, want "
            f"{(num_iterations, num_samples)}"
        )
    hs = homography_from_4pts(pts_src[idx], pts_dst[idx])  # (N, 3, 3)
    counts = _score_hypotheses(hs, pts_src, pts_dst, valid, distance_threshold)
    best = torch.argmax(counts)
    return hs[best], counts[best]


def ransac_homography(
    pts_src: torch.Tensor,     # (M, 2) f32, valid rows first
    pts_dst: torch.Tensor,     # (M, 2) f32
    valid: torch.Tensor,       # (M,) bool
    opts: RansacOptions,
    sampler: Optional[Sampler] = None,
) -> RansacResult:
    """Estimate H mapping src -> dst: RANSAC, then optional refine."""
    if sampler is None:
        sampler = default_sampler(
            opts.num_iterations, opts.num_samples, opts.seed, pts_src.device
        )
    best_h, best_count = ransac_best_hypothesis(
        pts_src, pts_dst, valid, opts.num_iterations, opts.num_samples,
        opts.distance_threshold, sampler,
    )
    return finalize_ransac(best_h, best_count, pts_src, pts_dst, valid, opts)


def finalize_ransac(
    best_h: torch.Tensor,
    best_count: torch.Tensor,
    pts_src: torch.Tensor,
    pts_dst: torch.Tensor,
    valid: torch.Tensor,
    opts: RansacOptions,
) -> RansacResult:
    """Degeneracy guard + inlier mask + optional least-squares refine."""
    n_valid = valid.sum(dtype=torch.int32)
    enough = n_valid >= opts.num_samples
    eye = torch.eye(3, dtype=pts_src.dtype, device=pts_src.device)
    best_h = torch.where(torch.isfinite(best_h).all() & enough, best_h, eye)
    best_count = best_count.to(torch.int32)
    mask0 = _inlier_mask(
        best_h, pts_src, pts_dst, valid, opts.distance_threshold
    )
    if opts.refine:
        refined = refine_homography(pts_src, pts_dst, mask0)
        mask_r = _inlier_mask(
            refined, pts_src, pts_dst, valid, opts.distance_threshold
        )
        count_r = mask_r.sum(dtype=torch.int32)
        use_refined = torch.isfinite(refined).all() & (count_r >= best_count)
        best_h = torch.where(use_refined, refined, best_h)
        mask0 = torch.where(use_refined, mask_r, mask0)
        best_count = torch.where(use_refined, count_r, best_count)
    ok = (best_count >= opts.min_inliers) & enough
    return RansacResult(
        H=best_h, inlier_count=best_count, num_matches=n_valid,
        inlier_mask=mask0, ok=ok,
    )
