"""Global frame refinement: joint re-optimization of per-image homographies.

A copy of ``pano_tpu/ops/bundle.py`` (host numpy in both packages; the
port keeps its own copy because importing ``pano_tpu`` pulls in JAX).

The reference's quality ceiling (cv::Stitcher, the reference's
src/opencv/main.cpp:59-67) runs bundle adjustment + wave correction
inside OpenCV; its native pipelines compose pairwise homographies with no
global re-solve, so chain-composition error grows with graph distance
from the anchor. Given every VALIDATED pairwise estimate H_ij (not just
the spanning-tree edges), this module refines all per-image global maps
G_i jointly so that G_i ∘ H_ij ≈ G_j holds in a weighted least-squares
sense over the whole match graph.

Design notes:
  * Constraints are synthesized from the pairwise homographies themselves:
    for each validated edge (i, j) a fixed grid of points in image j is
    mapped through H_ij into image i, giving virtual correspondences
    x_j <-> x_i whose global-frame disagreement ||π(G_i x_i) − π(G_j x_j)||
    is the residual, weighted by the edge's inlier count. This keeps the
    refinement independent of the device match buffers (no fetch of the
    RANSAC inlier sets per edge) while constraining exactly the quantity
    compositing uses.
  * The solver is host-side double-precision Levenberg-Marquardt over the
    8 dof of each placed non-anchor image (G[2,2] pinned to 1; the anchor
    is the gauge, G_anchor = I): an 8(n-1)-parameter dense solve (n ≤ tens
    of images) that finishes in milliseconds on the host.
  * Monotonic safety: the refined solution is returned only if it does not
    increase the total weighted error; otherwise the input globals come
    back unchanged. The tree solution is always a feasible starting point,
    so refinement can only help (it is exact on tree-only graphs, where
    the MST globals already satisfy every constraint).

On tree graphs (chain mode's adjacent pairs) the initial globals already
zero every residual, so refinement is the identity; the win appears when
the auto mode's all-pairs graph has cycles — redundant edges the spanning
tree had to drop become constraints that pull drifted frames back.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Grid resolution of the virtual correspondences per edge. 5x5 = 25 points
# over-determines the 8-dof relative constraint 6x; denser grids change the
# solution negligibly (the constraint is exact in the noise-free per-edge
# sense) and cost linearly.
GRID = 7

# Graphs already consistent below this weighted-RMS (anchor-frame pixels)
# are returned untouched. Ghosting only becomes visible around ~1 px of
# misalignment; below that, refinement trades measured quality for an
# imperceptible consistency gain (snow scene A/B: rms 0.157 -> 0.108 px
# cost 1.1 dB PSNR / doubled the seam metric against the bundled
# reference), and even noise-level drift can move a canvas bbox across a
# bucket boundary (observed: a 1-px canvas-width flip on a 0.0004-px-rms
# graph). Refinement is for graphs that are actually drifting.
MIN_RMS_PX = 0.5

# An edge constrains the solve only where its homography has match
# support: grid points in image j whose H_ij image lands inside image i
# (the overlap). Fewer than MIN_PTS surviving points (or a degenerate H
# throwing everything out of frame — observed on the view scene, where a
# 'validated' edge produced 1e25-px residuals) drops the edge entirely.
# Full-image grids measurably BACKFIRE: on the snow scene they extrapolate
# a slightly-off long-range H to the far corners, and the refinement drags
# well-aligned frames toward that extrapolation (PSNR 36.2 -> 29.8 in the
# A/B that motivated this clamp).
MIN_PTS = 6
OVERLAP_MARGIN = 0.02  # fractional bound slack for the inside-i test


def _grid_points(h: int, w: int) -> np.ndarray:
    """(GRID*GRID, 2) image-plane sample points, inset 5% from the border
    (the homographies were estimated from interior matches; corners
    extrapolate hardest)."""
    xs = np.linspace(0.05 * w, 0.95 * w, GRID)
    ys = np.linspace(0.05 * h, 0.95 * h, GRID)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _project(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 3x3 homography to (N, 2) points -> (N, 2)."""
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ m.T
    return ph[:, :2] / np.clip(ph[:, 2:3], 1e-12, None)


def _pack(gs: Dict[int, np.ndarray]) -> np.ndarray:
    return np.concatenate(
        [(gs[i] / gs[i][2, 2]).ravel()[:8] for i in sorted(gs)]
    )


def _unpack(vec: np.ndarray, ids: List[int]) -> Dict[int, np.ndarray]:
    out = {}
    for k, i in enumerate(ids):
        g = np.append(vec[8 * k : 8 * k + 8], 1.0).reshape(3, 3)
        out[i] = g
    return out


def refine_globals(
    globals_h: List[Optional[np.ndarray]],
    edges: Dict[Tuple[int, int], Tuple[np.ndarray, float]],
    anchor: int,
    shapes: List[Tuple[int, int]],
    iters: int = 30,
) -> Tuple[List[Optional[np.ndarray]], Dict[str, float]]:
    """Jointly refine global maps so every validated pairwise homography is
    honored in a weighted least-squares sense.

    globals_h: per-image 3x3 (image -> anchor frame), None = unplaced.
    edges: (i, j) -> (H_ij mapping image-j coords into image-i coords,
        weight — the edge's inlier count). Only edges whose BOTH endpoints
        are placed constrain the solve.
    anchor: gauge frame (its global stays exactly identity).
    shapes: per-image (h, w) for the virtual grids.

    Returns (refined globals, stats) where stats carries the before/after
    RMS residual in anchor-frame pixels ('rms_before'/'rms_after') and the
    constraint count ('n_residuals'). The refined list is the INPUT list
    (same objects) whenever refinement could not improve on it.
    """
    placed = [
        i
        for i in range(len(globals_h))
        if globals_h[i] is not None and i != anchor
    ]
    stats = {
        "rms_before": 0.0, "rms_after": 0.0, "n_residuals": 0.0,
        "n_edges": 0.0,
    }
    if not placed:
        return globals_h, stats

    # Per-edge constraint points: the grid in image j restricted to where
    # H_ij lands inside image i — the overlap, the only region the pairwise
    # estimate has match support in (see MIN_PTS note above). pts_i is
    # PRECOMPUTED: the edge constrains the relation between the frames, so
    # the correspondence set is fixed data, not a function of the solve.
    use: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, float]] = {}
    for (i, j), (h, w) in edges.items():
        if not ((i == anchor or i in placed) and (j == anchor or j in placed)):
            continue
        h_ij = np.asarray(h, np.float64)
        pj = _grid_points(*shapes[j])
        ph = np.concatenate([pj, np.ones((len(pj), 1))], axis=1) @ h_ij.T
        wcomp = ph[:, 2]
        hi, wi = shapes[i]
        mx, my = OVERLAP_MARGIN * wi, OVERLAP_MARGIN * hi
        with np.errstate(divide="ignore", invalid="ignore"):
            pi = ph[:, :2] / ph[:, 2:3]
        inside = (
            (wcomp > 1e-9)  # in front of the 'camera': degenerate H guard
            & (pi[:, 0] >= -mx) & (pi[:, 0] <= wi + mx)
            & (pi[:, 1] >= -my) & (pi[:, 1] <= hi + my)
            & np.isfinite(pi).all(axis=1)
        )
        if inside.sum() < MIN_PTS:
            continue
        use[(i, j)] = (pj[inside], pi[inside], float(max(w, 1.0)))
    if not use:
        return globals_h, stats
    stats["n_edges"] = float(len(use))

    def residuals(gs: Dict[int, np.ndarray]) -> np.ndarray:
        g_all = dict(gs)
        g_all[anchor] = np.eye(3)
        rs = []
        for (i, j), (pj, pi, w) in use.items():
            r = _project(g_all[i], pi) - _project(g_all[j], pj)
            rs.append((np.sqrt(w / len(pj)) * r).ravel())
        return np.concatenate(rs)

    gs0 = {i: np.asarray(globals_h[i], np.float64) for i in placed}
    ids = sorted(gs0)
    x = _pack(gs0)
    r = residuals(_unpack(x, ids))
    stats["n_residuals"] = float(len(r))
    w_total = sum(w for _, _, w in use.values())
    rms = lambda v: float(np.sqrt(np.sum(v * v) / max(w_total, 1e-12)))
    stats["rms_before"] = rms(r)
    stats["rms_after"] = stats["rms_before"]
    if stats["rms_before"] < MIN_RMS_PX:
        # Already consistent below perceptibility (tree graphs, RANSAC
        # estimates that agree to hundredths of a pixel): refinement could
        # only chase noise, and even noise-level drift can move a canvas
        # bbox across a rounding boundary — return the input untouched.
        return globals_h, stats
    err = float(r @ r)

    # Levenberg-Marquardt with a forward-difference Jacobian. Parameter
    # magnitudes span ~1e-5 (perspective) to ~1e3 (translation); the
    # Marquardt diagonal scaling handles the conditioning and the FD step
    # is relative per parameter.
    lam = 1e-3
    for _ in range(iters):
        jac = np.empty((len(r), len(x)))
        for p in range(len(x)):
            eps = 1e-7 * max(1.0, abs(x[p]))
            xp = x.copy()
            xp[p] += eps
            jac[:, p] = (residuals(_unpack(xp, ids)) - r) / eps
        jtj = jac.T @ jac
        jtr = jac.T @ r
        improved = False
        for _ in range(8):  # damping search
            try:
                step = np.linalg.solve(
                    jtj + lam * np.diag(np.clip(np.diag(jtj), 1e-12, None)),
                    -jtr,
                )
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            x_new = x + step
            r_new = residuals(_unpack(x_new, ids))
            err_new = float(r_new @ r_new)
            if err_new < err:
                x, r, err = x_new, r_new, err_new
                lam = max(lam / 3.0, 1e-12)
                improved = True
                break
            lam *= 10.0
        if not improved or float(np.abs(step).max()) < 1e-12:
            break

    stats["rms_after"] = rms(r)
    if stats["rms_after"] >= stats["rms_before"]:
        return globals_h, stats  # monotonic safety: never degrade

    refined = list(globals_h)
    for i, g in _unpack(x, ids).items():
        refined[i] = g
    return refined, stats


def graph_has_cycle(
    edges, n: int, anchor: int, globals_h: List[Optional[np.ndarray]]
) -> bool:
    """True when the validated pair graph over the PLACED images carries
    more edges than a spanning tree — i.e. refinement has redundant
    constraints to exploit. Tree graphs (chain mode) are already exact."""
    nodes = {
        i
        for i in range(n)
        if i == anchor or globals_h[i] is not None
    }
    m = sum(1 for (i, j) in edges if i in nodes and j in nodes)
    return m > max(len(nodes) - 1, 0)
