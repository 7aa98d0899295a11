"""K5, the one-pass pair composite, and K6, the chain composite step
(``csrc/compose.cu``), with their plain versions.

K5 replaces ``pano_tpu/ops/pallas_compose.py::compose_canvas``. The left
image placed at (ty, tx) is the base; inside the window the warped pixels
(``ops/cuda_warp.py::warp_packed``, or the pipeline's gain and multiband
output) are blended in by overlay (a non-black pixel wins) or feather
(the analytic left edge ramp against the window's weight). Placements and
windows are exact and unaligned. The kernel reads the ramp's values from
``ramp_table``, built once per left shape and device. The plain version
is ``ops/warp.py::blend_window_outputs`` in pair mode.

K6 replaces ``pano_tpu/ops/pallas_compose.py::compose_chain_canvas``: the
global composite's step, one warped window blended into the accumulated
canvas by overlay or by feather against the accumulated weight canvas,
whose window then takes max(its weight, the window's). It updates both
canvases in place over the exact window only. The plain version is
``blend_window_outputs`` in chain mode and a slice assignment.

What bounds each kernel on an H100 is noted in ``csrc/compose.cu``. Each
wrapper takes its plain version for tensors on the CPU and launches its
kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import warp as warp_ops
from pano_tpu_torch.ops.cuda_warp import (
    Window, _check_device, _check_image, _check_window,
)

# Kernel launches since the last reset: tests and chip_smoke.py read them
# to prove that the kernel path ran. They are not tracing; the profiler's
# spans (timer.span) are.
launches = 0        # K5, compose_canvas
chain_launches = 0  # K6, compose_chain_canvas


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
    )[0]


def ramp_table(h: int, w: int, device=None) -> torch.Tensor:
    """((min(h, w) + 1) // 2 + 1,) f32: the left edge ramp d / (min(h, w)
    / 2) of the plain feather at every distance d it takes, 0 .. (min(h,
    w) + 1) // 2, in its operations (one f32 division each). K5 reads its
    left weight from it."""
    d = torch.arange((min(h, w) + 1) // 2 + 1, dtype=torch.float32,
                     device=device)
    return warp_ops.true_div(d, min(h, w) / 2.0)


@functools.lru_cache(maxsize=16)
def _ramp_table(h: int, w: int, device: torch.device) -> torch.Tensor:
    return ramp_table(h, w, device)


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
    ramp = _ramp_table(hl, wl, left.device) if feather else None
    global launches
    _build.launch(
        "pano_compose_canvas", left.device,
        left.data_ptr(), win_rgb.data_ptr(),
        w_win.data_ptr() if feather else 0,
        ramp.data_ptr() if feather else 0, out.data_ptr(),
        hl, wl, out_h, out_w, int(ty), int(tx), *window, int(feather),
    )
    launches += 1
    return out


def _check_chain_args(canvas, weight_canvas, win_rgb, w_win, window, blend):
    fn = "compose_chain_canvas"
    _check_image(fn, "canvas", canvas)
    _check_image(fn, "win_rgb", win_rgb)
    if blend not in ("overlay", "feather"):
        raise ValueError(f"{fn}: unsupported blend {blend!r}")
    out_h, out_w = canvas.shape[:2]
    if weight_canvas.dtype != torch.float32 \
            or tuple(weight_canvas.shape) != (out_h, out_w):
        raise ValueError(f"{fn}: weight_canvas must be f32 of the canvas's "
                         f"shape")
    _check_window(window, out_h, out_w)
    wy0, wx0, wy1, wx1 = window
    if tuple(win_rgb.shape[:2]) != (wy1 - wy0, wx1 - wx0):
        raise ValueError(f"{fn}: window {window} does not match win_rgb "
                         f"{tuple(win_rgb.shape)}")
    if w_win is None or w_win.dtype != torch.float32 \
            or tuple(w_win.shape) != tuple(win_rgb.shape[:2]):
        raise ValueError(f"{fn}: w_win must be an f32 weight of the "
                         f"window's shape")
    if any(t.device != canvas.device for t in (weight_canvas, win_rgb, w_win)):
        raise ValueError(f"{fn}: tensors on different devices")
    _check_device(fn, canvas.device)


def compose_chain_canvas_plain(
    canvas: torch.Tensor, weight_canvas: torch.Tensor, win_rgb: torch.Tensor,
    w_win: torch.Tensor, window: Window, blend: str = "overlay",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: blend_window_outputs in chain mode against the
    weight canvas's window, its merged weight written back. Updates both
    canvases in place."""
    window = tuple(map(int, window))
    _check_chain_args(canvas, weight_canvas, win_rgb, w_win, window, blend)
    wy0, wx0, wy1, wx1 = window
    out_h, out_w = canvas.shape[:2]
    _, new_w = warp_ops.blend_window_outputs(
        canvas, win_rgb, w_win, 0, 0, wx0, wy0, out_h, out_w, blend,
        w_left_win=weight_canvas[wy0:wy1, wx0:wx1],
    )
    weight_canvas[wy0:wy1, wx0:wx1] = new_w
    return canvas, weight_canvas


def compose_chain_canvas(
    canvas: torch.Tensor, weight_canvas: torch.Tensor, win_rgb: torch.Tensor,
    w_win: torch.Tensor, window: Window, blend: str = "overlay",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend the (h, w, 3) u8 window `win_rgb` with its f32 weight `w_win`
    into the accumulated (H, W, 3) u8 `canvas` at `window` = (wy0, wx0,
    wy1, wx1) by `blend` ("overlay", or "feather" against the accumulated
    (H, W) f32 `weight_canvas`), and set the weight canvas's window to
    max(its weight, w_win). Both canvases are updated in place and
    returned."""
    window = tuple(map(int, window))
    _check_chain_args(canvas, weight_canvas, win_rgb, w_win, window, blend)
    if canvas.device.type == "cpu":
        return compose_chain_canvas_plain(canvas, weight_canvas, win_rgb,
                                          w_win, window, blend)
    if not all(t.is_contiguous()
               for t in (canvas, weight_canvas, win_rgb, w_win)):
        raise ValueError("compose_chain_canvas: tensors must be contiguous")
    wy0, wx0, wy1, wx1 = window
    if wy1 == wy0 or wx1 == wx0:
        return canvas, weight_canvas
    global chain_launches
    _build.launch(
        "pano_compose_chain_canvas", canvas.device,
        canvas.data_ptr(), weight_canvas.data_ptr(), win_rgb.data_ptr(),
        w_win.data_ptr(), canvas.shape[1], wy0, wx0, wy1 - wy0, wx1 - wx0,
        int(blend == "feather"),
    )
    chain_launches += 1
    return canvas, weight_canvas
