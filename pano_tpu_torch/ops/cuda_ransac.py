"""K10: RANSAC's hypothesis search (``csrc/ransac.cu``) and its plain
version.

Replaces no ``pallas_call``: the JAX package leaves the search to XLA
(``pano_tpu/ops/ransac.py``: ``homography_from_4pts`` under ``vmap``,
``_score_hypotheses``, ``argmax``). The port ran it as plain torch inside
the estimate's CUDA graph, ~290 launches on (N, 8, 9) tensors and (N, M)
planes, ~1.07 ms of the card an estimate at N 1000, M 8192.

On an H100 the search is bound by the scores' arithmetic: ~20 f32
operations and two IEEE divisions a (hypothesis, valid match), ~12 us of
issue at N 1000 and 8192 valid matches; its data are L2-resident and
the DLTs small, but each DLT is a chain of dependent divisions. So the
kernel is one launch: a block builds a tile of 8 hypotheses' DLTs in
registers, nine lanes a hypothesis (a column of the 8x9 system each, the
divisions spread over the lanes), scores them against every valid match
(each thread a strided share of the matches, one count a hypothesis),
and the first maximum comes out of a 64-bit ``atomicMax`` over (count,
N - 1 - index) read by the last block to finish, which copies the winner
out. Its slot and ticket are scratch the wrapper allocates and the C
entry zeroes with a memset before the launch, so a captured graph resets
them on every replay.

``search`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; any other device raises. The plain version
fixes the order of every rounded operation (a batched ``@`` and a
``sum`` on the card have none that torch promises): the 4-term sums left
to right, each 3x3 product entry (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j, the
inlier test's (a x + b y) + c and x * x. The kernel repeats it operation
for operation, so the two are equal bit for bit on the card (with
``-fmad=false``; a NaN hypothesis is NaN in both and scores 0).
"""

from __future__ import annotations

import torch

from pano_tpu_torch import _build

# Kernel launches since the last reset: tests and chip_smoke.py read it to
# prove that the kernel path ran. A replay of RANSAC's CUDA graph adds the
# launches the graph holds (ops/ransac.py). It is not tracing; the
# profiler's spans (timer.span) are.
launches = 0


def _sum4(v: torch.Tensor) -> torch.Tensor:
    """((v0 + v1) + v2) + v3 over the last axis of size 4."""
    return ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]


def _similarity4(pts: torch.Tensor) -> torch.Tensor:
    """Hartley similarity of 4 points, batched: pts (..., 4, 2) ->
    (..., 3, 3) [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]], with (mx, my)
    the points' mean and s = sqrt(2) / max(their mean distance from it,
    1e-8). The numerator is a tensor: `float / tensor` multiplies by a
    reciprocal, which rounds differently."""
    x, y = pts[..., 0], pts[..., 1]
    mx, my = _sum4(x) / 4.0, _sum4(y) / 4.0
    ex, ey = x - mx[..., None], y - my[..., None]
    md = _sum4(torch.sqrt(ex * ex + ey * ey)) / 4.0
    s = torch.full_like(md, 2.0).sqrt() / torch.clamp(md, min=1e-8)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    rows = [s, zero, -s * mx, zero, s, -s * my, zero, zero, one]
    return torch.stack(rows, -1).reshape(s.shape + (3, 3))


def _apply_similarity4(t: torch.Tensor, pts: torch.Tensor):
    """t (..., 3, 3) applied to pts (..., 4, 2): the columns ((x t00 + y
    t01) + t02, (x t10 + y t11) + t12)."""
    x, y = pts[..., 0], pts[..., 1]
    col = [t[..., i, j, None] for i in range(2) for j in range(3)]
    return ((x * col[0] + y * col[1]) + col[2],
            (x * col[3] + y * col[4]) + col[5])


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 3, 3), each entry (a_i0 b_0j + a_i1 b_1j) +
    a_i2 b_2j."""
    return ((a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :])
            + a[..., :, 2:3] * b[..., 2:3, :])


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
    for col in range(8):
        mag = torch.where(rows >= col, m[..., :, col].abs(), float("-inf"))
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


def homography_from_4pts(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homographies from 4 correspondences, src/dst (..., 4, 2):
    Hartley-normalized DLT, H[2, 2] = 1."""
    t_src, t_dst = _similarity4(src), _similarity4(dst)
    x, y = _apply_similarity4(t_src, src)
    u, v = _apply_similarity4(t_dst, dst)
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
    h_full = _matmul3(_matmul3(inv3x3(t_dst), h), t_src)
    return h_full / h_full[..., 2:3, 2:3]


def score_hypotheses(hs, src, dst, valid, thresh: float) -> torch.Tensor:
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


def search_plain(pts_src, pts_dst, valid, idx, thresh: float):
    """The search in plain torch: (hs (N, 3, 3) f32, counts (N,) int32,
    best_h (3, 3), best_count ()), the best the first maximum of counts."""
    flat = idx.reshape(-1)
    hs = homography_from_4pts(
        pts_src.index_select(0, flat).reshape(idx.shape + (2,)),
        pts_dst.index_select(0, flat).reshape(idx.shape + (2,)),
    )
    counts = score_hypotheses(hs, pts_src, pts_dst, valid, thresh)
    best = torch.argmax(counts).reshape(1)
    return (hs, counts, hs.index_select(0, best)[0],
            counts.index_select(0, best)[0])


def search(pts_src: torch.Tensor, pts_dst: torch.Tensor,
           valid: torch.Tensor, idx: torch.Tensor, thresh: float):
    """Score the hypotheses `idx` (N, 4) int64, indices into the (M, 2)
    f32 points, against the matches: (hs (N, 3, 3) f32, counts (N,)
    int32, best_h (3, 3), best_count () int32); see ``search_plain``. On
    the GPU one launch, with no host sync."""
    m = pts_src.shape[0]
    if (pts_src.dtype != torch.float32 or pts_dst.dtype != torch.float32
            or pts_src.shape != (m, 2) or pts_dst.shape != (m, 2)
            or valid.dtype != torch.bool or valid.shape != (m,)
            or idx.dtype != torch.int64 or idx.dim() != 2
            or idx.shape[1] != 4 or idx.shape[0] < 1):
        raise ValueError(
            f"ransac search: want (M, 2) float32 points, (M,) bool valid "
            f"and (N >= 1, 4) int64 indices, got {tuple(pts_src.shape)} "
            f"{pts_src.dtype}, {tuple(pts_dst.shape)} {pts_dst.dtype}, "
            f"{tuple(valid.shape)} {valid.dtype}, {tuple(idx.shape)} "
            f"{idx.dtype}")
    if pts_src.device.type == "cpu":
        return search_plain(pts_src, pts_dst, valid, idx, thresh)
    if pts_src.device.type != "cuda":
        raise ValueError(f"ransac search: unsupported device {pts_src.device}")
    dev = pts_src.device
    pts_src, pts_dst, valid, idx = (
        t.contiguous() for t in (pts_src, pts_dst, valid, idx))
    if pts_src.data_ptr() % 8 or pts_dst.data_ptr() % 8:
        raise ValueError("ransac search: the kernel reads a point as one "
                         "8-byte word; the points are not 8-byte aligned")
    n = idx.shape[0]
    hs = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    best_h = torch.empty((3, 3), dtype=torch.float32, device=dev)
    best_count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(2, dtype=torch.int64, device=dev)
    global launches
    _build.launch("pano_ransac_search", dev, pts_src.data_ptr(),
                  pts_dst.data_ptr(), valid.data_ptr(), idx.data_ptr(),
                  hs.data_ptr(), counts.data_ptr(), best_h.data_ptr(),
                  best_count.data_ptr(), scratch.data_ptr(), m, n,
                  thresh * thresh)
    launches += 1
    return hs, counts, best_h, best_count
