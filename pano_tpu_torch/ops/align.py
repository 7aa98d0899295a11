"""Direct alignment of a pair's homography: Gauss-Newton on the
photometric error of the two images over their overlap.

RANSAC's refine fits H to the matched Harris corners, which lie on whole
pixels. For a camera that rotates about its centre the matches carry
about a quarter of a pixel of noise, so H lands tenths of a pixel off
over the overlap and, magnified by the perspective, several pixels off
at the right image's far corners. Every pixel of the overlap constrains
the alignment, so minimising the photometric error brings the far
corners under a pixel.

``align_homography`` takes H (right -> left, H[2, 2] = 1) to the
normalized frames of ``cuda_align.frame``, runs a fixed number of
Gauss-Newton iterations on its 8 parameters (h33 = 1) over the residual
between the left image's gray, sampled bilinearly where H places each
right pixel, and the right image's gray, at full resolution (K11,
``ops/cuda_align.py``: one pass an iteration and one that measures),
and takes the result back. A guard on the device keeps the given H where
a solve was singular, the last pass's mean squared residual exceeds the
first's, or the result is not finite. Nothing here reads a device value
on the host, so the step runs inside the estimate's CUDA graph
(``ops/ransac.py``).
"""

from __future__ import annotations

import torch

from pano_tpu_torch.ops import cuda_align
from pano_tpu_torch.timer import span


def to_normalized(h: torch.Tensor, fr: cuda_align.Frame) -> torch.Tensor:
    """The 8 parameters of Tl H Tr^-1, scaled to a last entry of 1, for
    H (3, 3) right -> left, with T the frames' normalizations: (8,)
    float64."""
    h = h.to(torch.float64)
    c0, c1 = h[:, 0] * fr.s, h[:, 1] * fr.s
    c2 = (h[:, 0] * fr.cxr + h[:, 1] * fr.cyr) + h[:, 2]
    m = torch.stack([c0, c1, c2], -1)            # H Tr^-1
    n = torch.stack([(m[0] - m[2] * fr.cxl) / fr.s,
                     (m[1] - m[2] * fr.cyl) / fr.s, m[2]])
    return (n / n[2, 2]).reshape(-1)[:8]


def from_normalized(p: torch.Tensor, fr: cuda_align.Frame) -> torch.Tensor:
    """H (3, 3) float64 right -> left, H[2, 2] = 1, of the parameters `p`
    (``to_normalized``'s inverse)."""
    n = torch.cat([p, torch.ones_like(p[:1])]).reshape(3, 3)
    c2 = n[:, 2] - (n[:, 0] * fr.cxr + n[:, 1] * fr.cyr) / fr.s
    m = torch.stack([n[:, 0] / fr.s, n[:, 1] / fr.s, c2], -1)   # Hn Tr
    h = torch.stack([m[0] * fr.s + m[2] * fr.cxl,
                     m[1] * fr.s + m[2] * fr.cyl, m[2]])
    return h / h[2, 2]


def align_homography(h: torch.Tensor, left: torch.Tensor,
                     right: torch.Tensor, iterations: int) -> torch.Tensor:
    """H (3, 3) float32 right -> left aligned on the images `left` and
    `right` ((h, w, 3) uint8 on H's device) by `iterations` Gauss-Newton
    iterations, or `h` itself where the guard refuses the result. No host
    sync."""
    with span("align"):
        fr = cuda_align.frame(left.shape[:2], right.shape[:2])
        state = cuda_align.gauss_newton(to_normalized(h, fr), left, right,
                                        iterations, fr)
        aligned = from_normalized(state[:8], fr).to(h.dtype)
        keep = ((state[cuda_align.SINGULAR] == 0)
                & (state[cuda_align.E_END] <= state[cuda_align.E_START])
                & torch.isfinite(aligned).all())
        return torch.where(keep, aligned, h)
