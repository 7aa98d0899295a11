"""K1: fused Harris scores (``csrc/harris.cu``) and its plain version.

Replaces ``pano_tpu/ops/pallas_harris.py::harris_scores`` (body
``_make_kernel``, launched by ``_scores_batched``). The kernel is bound
by its ~100 f32 operations a pixel, not by its bytes (one read of the
u8 image, one write of the quarter-size folded map). It is a streaming
stencil: each warp walks down a 128-column strip, holds the vertical
taps in registers, takes the horizontal ones by warp shuffles, and so
computes every product once with a halo of 8 columns and 8 rows a
strip; ``csrc/harris.cu`` has the details. It is bit-identical to the
plain version: the same f32 operations in the same order.

Every odd NMS window n >= 3 runs on the card: n = 3, 5, 7 and 9 in one
launch of the stencil instantiated for that half-width, wider windows in
two (the stencil writes the R plane, and a second kernel takes the n x n
maximum test and the fold over it). ``harris_scores_batched`` scores a
(B, H, W, 3) stack of same-shape images in one launch (the TPU kernel's
``_scores_batched`` grid; a grid.z slice per image). The wrappers take
the plain version for a tensor on the CPU and launch the kernel for a
CUDA tensor; any other device raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import conv as conv_ops
from pano_tpu_torch.ops import harris as harris_ops

# Kernel launches since the last reset: tests and chip_smoke.py read them
# to prove that the kernel path ran. They are not tracing; the profiler's
# spans (timer.span) are.
launches = 0          # harris_scores, one image
batched_launches = 0  # harris_scores_batched, a stack of images

# The widest NMS window of the one-launch stencil (csrc/harris.cu MAX_NR).
WIDEST_STENCIL_NMS = 9


@functools.cache
def _gauss_taps():
    """The Gaussian's 1-D taps g0, g1, g2 (g3 = g1, g4 = g0) in f32."""
    g = conv_ops.gaussian_kernel_1d(5, 1.0).astype(np.float32)
    return float(g[0]), float(g[1]), float(g[2])


def harris_scores_plain(
    img_u8: torch.Tensor, k: float, nms_thresh: float,
    neighborhood: int = 3,
) -> torch.Tensor:
    """The plain PyTorch chain: (ceil(h/2), ceil(w/2)) f32 block maxima of
    the NMS'd, offset-packed scores, -inf where a block has no peak."""
    h, w = img_u8.shape[:2]
    dev = img_u8.device
    gray = harris_ops.bgr_to_gray_f32(img_u8)
    resp = harris_ops.harris_response(gray, k)
    half = neighborhood // 2
    nmax = harris_ops._neighbor_max(resp, neighborhood)
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    border_ok = (ys >= half) & (ys < h - half) & (xs >= half) & (xs < w - half)
    is_peak = (resp > nms_thresh) & (resp > nmax) & border_ok
    off_bits = ((ys & 1) << 1) | (xs & 1)
    packed = ((resp.view(torch.int32) & ~3) | off_bits).view(torch.float32)
    scores = torch.where(
        is_peak, packed, torch.full_like(packed, float("-inf"))
    )
    scores = torch.nn.functional.pad(
        scores, (0, w % 2, 0, h % 2), value=float("-inf")
    )
    h2, w2 = scores.shape[0] // 2, scores.shape[1] // 2
    return scores.view(h2, 2, w2, 2).amax(dim=(1, 3))


def harris_scores_batched_plain(
    imgs_u8: torch.Tensor, k: float, nms_thresh: float,
    neighborhood: int = 3,
) -> torch.Tensor:
    """The plain version of the batched launch: harris_scores_plain of
    each image, stacked."""
    b, h, w = imgs_u8.shape[:3]
    if b == 0:
        return torch.empty((0, (h + 1) // 2, (w + 1) // 2),
                           dtype=torch.float32, device=imgs_u8.device)
    return torch.stack([harris_scores_plain(im, k, nms_thresh, neighborhood)
                        for im in imgs_u8])


def _check(fn: str, imgs: torch.Tensor, rank: int) -> None:
    if imgs.dtype != torch.uint8 or imgs.dim() != rank or imgs.shape[-1] != 3:
        want = "(H, W, 3)" if rank == 3 else "(B, H, W, 3)"
        raise ValueError(f"{fn}: want {want} uint8, got "
                         f"{tuple(imgs.shape)} {imgs.dtype}")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {imgs.device}")


def _launch(fn: str, imgs: torch.Tensor, k: float, nms_thresh: float,
            neighborhood: int) -> torch.Tensor:
    """One launch over a (B, H, W, 3) CUDA stack -> (B, h2, w2)."""
    if neighborhood < 3 or neighborhood % 2 != 1:
        raise ValueError(
            f"{fn}: the NMS window must be odd and >= 3, got {neighborhood}"
        )
    if not imgs.is_contiguous():
        raise ValueError(f"{fn}: image must be contiguous")
    b, h, w = imgs.shape[:3]
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                      device=imgs.device)
    if b == 0 or h == 0 or w == 0:
        return out
    # Windows wider than 9 go through an R plane (see csrc/harris.cu).
    resp = (torch.empty((b, h, w), dtype=torch.float32, device=imgs.device)
            if neighborhood > WIDEST_STENCIL_NMS else None)
    _build.launch(
        "pano_harris_scores", imgs.device,
        imgs.data_ptr(), out.data_ptr(),
        0 if resp is None else resp.data_ptr(), b, h, w, int(neighborhood),
        float(k), float(nms_thresh), *_gauss_taps(),
    )
    return out


def harris_scores(
    img_u8: torch.Tensor, k: float, nms_thresh: float, neighborhood: int = 3,
) -> torch.Tensor:
    """Block-folded Harris scores of an (H, W, 3) u8 BGR image, NMS over a
    `neighborhood` x `neighborhood` window."""
    _check("harris_scores", img_u8, 3)
    if img_u8.device.type == "cpu":
        return harris_scores_plain(img_u8, k, nms_thresh, neighborhood)
    out = _launch("harris_scores", img_u8[None], k, nms_thresh, neighborhood)
    global launches
    launches += 1
    return out[0]


def harris_scores_batched(
    imgs_u8: torch.Tensor, k: float, nms_thresh: float,
    neighborhood: int = 3,
) -> torch.Tensor:
    """harris_scores of each image of a (B, H, W, 3) u8 stack, in one
    launch: (B, ceil(H/2), ceil(W/2)) f32."""
    _check("harris_scores_batched", imgs_u8, 4)
    if imgs_u8.device.type == "cpu":
        return harris_scores_batched_plain(imgs_u8, k, nms_thresh,
                                           neighborhood)
    out = _launch("harris_scores_batched", imgs_u8, k, nms_thresh,
                  neighborhood)
    global batched_launches
    batched_launches += 1
    return out
