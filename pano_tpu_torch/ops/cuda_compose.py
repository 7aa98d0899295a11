"""K5: one-pass canvas composite (``csrc/compose.cu``) and its plain
version.

Replaces ``pano_tpu/ops/pallas_compose.py::compose_canvas``. The left
image placed at (ty, tx) is the base; inside the window the warped pixels
(``ops/cuda_warp.py::warp_packed``, or the pipeline's gain and multiband
output) are blended in by overlay (a non-black pixel wins) or feather
(the analytic left edge ramp against the window's weight). Placements and
windows are exact and unaligned. The plain version is
``ops/warp.py::blend_window_outputs``. What bounds the kernel on an H100
is noted at the top of ``csrc/compose.cu``.

``compose_canvas`` takes the plain version for tensors on the CPU and
launches the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import warp as warp_ops
from pano_tpu_torch.ops.cuda_warp import (
    Window, _check_device, _check_image, _check_window,
)

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def _check_args(left, win_rgb, w_win, window, out_h, out_w, blend):
    fn = "compose_canvas"
    _check_image(fn, "left", left)
    _check_image(fn, "win_rgb", win_rgb)
    if blend not in ("overlay", "feather"):
        raise ValueError(f"{fn}: unsupported blend {blend!r}")
    _check_window(window, out_h, out_w)
    wy0, wx0, wy1, wx1 = window
    if tuple(win_rgb.shape[:2]) != (wy1 - wy0, wx1 - wx0):
        raise ValueError(f"{fn}: window {window} does not match win_rgb "
                         f"{tuple(win_rgb.shape)}")
    if blend == "feather":
        if w_win is None or w_win.dtype != torch.float32 \
                or tuple(w_win.shape) != tuple(win_rgb.shape[:2]):
            raise ValueError(f"{fn}: feather needs an f32 weight of the "
                             f"window's shape")
    if win_rgb.device != left.device or (
            w_win is not None and w_win.device != left.device):
        raise ValueError(f"{fn}: tensors on different devices")
    _check_device(fn, left.device)


def compose_canvas_plain(
    left: torch.Tensor, win_rgb: torch.Tensor, w_win: Optional[torch.Tensor],
    ty: int, tx: int, window: Window, out_h: int, out_w: int,
    blend: str = "overlay",
) -> torch.Tensor:
    """The plain version: blend_window_outputs over the same canvas."""
    _check_args(left, win_rgb, w_win, window, out_h, out_w, blend)
    wy0, wx0 = window[:2]
    return warp_ops.blend_window_outputs(
        left, win_rgb, w_win if blend == "feather" else None, tx, ty, wx0,
        wy0, out_h, out_w, blend,
    )


def compose_canvas(
    left: torch.Tensor, win_rgb: torch.Tensor, w_win: Optional[torch.Tensor],
    ty: int, tx: int, window: Window, out_h: int, out_w: int,
    blend: str = "overlay",
) -> torch.Tensor:
    """(out_h, out_w, 3) u8 canvas: `left` placed at (ty, tx), and the
    (h, w, 3) u8 window `win_rgb` at `window` = (wy0, wx0, wy1, wx1)
    blended in by `blend` ("overlay", or "feather" against the f32 weight
    `w_win`, which overlay ignores)."""
    window = tuple(map(int, window))
    _check_args(left, win_rgb, w_win, window, out_h, out_w, blend)
    if left.device.type == "cpu":
        return compose_canvas_plain(left, win_rgb, w_win, ty, tx, window,
                                    out_h, out_w, blend)
    feather = blend == "feather"
    if not (left.is_contiguous() and win_rgb.is_contiguous()
            and (not feather or w_win.is_contiguous())):
        raise ValueError("compose_canvas: tensors must be contiguous")
    out = torch.empty((out_h, out_w, 3), dtype=torch.uint8, device=left.device)
    if out_h == 0 or out_w == 0:
        return out
    hl, wl = left.shape[:2]
    global launches
    _build.launch(
        "pano_compose_canvas", left.device,
        left.data_ptr(), win_rgb.data_ptr(),
        w_win.data_ptr() if feather else 0, out.data_ptr(),
        hl, wl, out_h, out_w, int(ty), int(tx), *window, int(feather),
    )
    launches += 1
    return out
