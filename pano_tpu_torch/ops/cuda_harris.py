"""K1: fused Harris scores (``csrc/harris.cu``) and its plain version.

Replaces ``pano_tpu/ops/pallas_harris.py::harris_scores`` (body
``_make_kernel``, launched by ``_scores_batched``). What bounds the kernel
on an H100 and what its design does about it is noted at the top of
``csrc/harris.cu``: a shared-memory stencil that reads the u8 image once
and writes only the quarter-size folded score map.

``harris_scores`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor (3x3 NMS only: another window
raises there); any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import conv as conv_ops
from pano_tpu_torch.ops import harris as harris_ops

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


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


def harris_scores(
    img_u8: torch.Tensor, k: float, nms_thresh: float, neighborhood: int = 3,
) -> torch.Tensor:
    """Block-folded Harris scores of an (H, W, 3) u8 BGR image, NMS over a
    `neighborhood` x `neighborhood` window."""
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 3 \
            or img_u8.shape[2] != 3:
        raise ValueError(
            f"harris_scores: want (H, W, 3) uint8, got "
            f"{tuple(img_u8.shape)} {img_u8.dtype}"
        )
    if img_u8.device.type == "cpu":
        return harris_scores_plain(img_u8, k, nms_thresh, neighborhood)
    if img_u8.device.type != "cuda":
        raise ValueError(f"harris_scores: unsupported device {img_u8.device}")
    if neighborhood != 3:
        raise NotImplementedError(
            f"harris_scores: the kernel implements 3x3 NMS, not "
            f"{neighborhood}x{neighborhood}"
        )
    if not img_u8.is_contiguous():
        raise ValueError("harris_scores: image must be contiguous")
    h, w = img_u8.shape[:2]
    out = torch.empty(
        ((h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
        device=img_u8.device,
    )
    if h == 0 or w == 0:
        return out
    global launches
    _build.launch(
        "pano_harris_scores", img_u8.device,
        img_u8.data_ptr(), out.data_ptr(), h, w, float(k),
        float(nms_thresh), *_gauss_taps(),
    )
    launches += 1
    return out
