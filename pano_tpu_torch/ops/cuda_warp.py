"""K4a: fused warp + overlay composite (``csrc/warp.cu``) and its plain
version.

Replaces ``pano_tpu/ops/pallas_warp.py::warp_compose_overlay``. One pass
over the whole canvas: the left image placed at (ty, tx) as the base, and
inside the window the right image inverse-mapped through ``m_inv``,
sampled bilinearly (exact single pass, no envelope) and overlaid where
non-black. The plain version is ``ops/warp.py::warp_and_blend`` with the
overlay blend. What bounds the kernel on an H100 is noted at the top of
``csrc/warp.cu``.

``warp_compose_overlay`` takes the plain version for tensors on the CPU
and launches the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import warp as warp_ops

launches = 0  # kernel launches since the last reset (chip_smoke reads it)

Window = Tuple[int, int, int, int]  # (wy0, wx0, wy1, wx1), end-exclusive


def _check_window(window: Window, out_h: int, out_w: int) -> None:
    wy0, wx0, wy1, wx1 = window
    if not (0 <= wy0 <= wy1 <= out_h and 0 <= wx0 <= wx1 <= out_w):
        raise ValueError(
            f"warp window {window} outside the {out_h}x{out_w} canvas"
        )


def warp_compose_overlay_plain(
    right: torch.Tensor, m_inv, left: torch.Tensor, ty: int, tx: int,
    window: Window, out_h: int, out_w: int,
) -> torch.Tensor:
    """The plain version: warp_and_blend(blend='overlay') over the same
    canvas and window."""
    _check_window(window, out_h, out_w)
    wy0, wx0, wy1, wx1 = window
    return warp_ops.warp_and_blend(
        left, right, m_inv, tx, ty, out_h, out_w, "overlay",
        win_x=wx0, win_y=wy0, win_h=wy1 - wy0, win_w=wx1 - wx0,
    )


def warp_compose_overlay(
    right: torch.Tensor, m_inv, left: torch.Tensor, ty: int, tx: int,
    window: Window, out_h: int, out_w: int,
) -> torch.Tensor:
    """(out_h, out_w, 3) u8 canvas: left at (ty, tx), right warped by the
    canvas-to-source map ``m_inv`` (3x3, any array-like) inside
    ``window`` and overlaid where non-black."""
    for name, img in (("right", right), ("left", left)):
        if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
            raise ValueError(f"warp_compose_overlay: {name} must be "
                             f"(H, W, 3) uint8")
    if right.device != left.device:
        raise ValueError("warp_compose_overlay: images on different devices")
    _check_window(window, out_h, out_w)
    if left.device.type == "cpu":
        return warp_compose_overlay_plain(
            right, m_inv, left, ty, tx, window, out_h, out_w
        )
    if left.device.type != "cuda":
        raise ValueError(
            f"warp_compose_overlay: unsupported device {left.device}"
        )
    if not (right.is_contiguous() and left.is_contiguous()):
        raise ValueError("warp_compose_overlay: images must be contiguous")
    out = torch.empty((out_h, out_w, 3), dtype=torch.uint8, device=left.device)
    if out_h == 0 or out_w == 0:
        return out
    hr, wr = right.shape[:2]
    hl, wl = left.shape[:2]
    global launches
    _build.launch(
        "pano_warp_compose_overlay", left.device,
        right.data_ptr(), left.data_ptr(), out.data_ptr(),
        hr, wr, hl, wl, out_h, out_w, int(ty), int(tx), *map(int, window),
        *warp_ops._m_floats(m_inv),
    )
    launches += 1
    return out
