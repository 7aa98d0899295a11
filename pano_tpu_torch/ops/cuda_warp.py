"""K4a, fused warp + overlay composite, and K4b, the windowed warp
(``csrc/warp.cu``), with their plain versions.

K4a replaces ``pano_tpu/ops/pallas_warp.py::warp_compose_overlay``. One
pass over the whole canvas: the left image placed at (ty, tx) as the base,
and inside the window the right image inverse-mapped through ``m_inv``,
sampled bilinearly (exact single pass, no envelope) and overlaid where
non-black. Its plain version is ``ops/warp.py::warp_and_blend`` with the
overlay blend.

K4b replaces ``pano_tpu/ops/pallas_warp.py::warp_packed``: the same
sample written to a window of its own, (h, w, 3) u8, plus an f32 weight,
which the feather, multiband and gain blends read (``ops/cuda_compose.py``
then composes the canvas). With ``has_alpha`` the weight is the bilinear
sample of the 7-bit alpha plane clip(round(_edge_ramp * 127), 1, 127) that
the JAX package packs beside the pixels, rounded back to 7 bits and
divided by 127, as the TPU kernel's alpha byte is (a sub-pixel fringe with
less than half a tap on the image weighs 0); without it, the summed
in-bounds bilinear weight. Its plain version is ``_inverse_map`` +
``_bilinear_sample_u8`` on the image and on that alpha plane.

What bounds the kernels on an H100 is noted at the top of
``csrc/warp.cu``. Each wrapper takes its plain version for tensors on the
CPU and launches its kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import warp as warp_ops

# Kernel launches since the last reset (chip_smoke.py reads them).
launches = 0         # K4a, warp_compose_overlay
packed_launches = 0  # K4b, warp_packed

Window = Tuple[int, int, int, int]  # (wy0, wx0, wy1, wx1), end-exclusive


def _check_image(fn: str, name: str, img: torch.Tensor) -> None:
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"{fn}: {name} must be (H, W, 3) uint8")


def _check_device(fn: str, dev: torch.device) -> None:
    """Raise unless `dev` is the CPU (plain version) or a CUDA device."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")


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
    fn = "warp_compose_overlay"
    _check_image(fn, "right", right)
    _check_image(fn, "left", left)
    if right.device != left.device:
        raise ValueError(f"{fn}: images on different devices")
    _check_window(window, out_h, out_w)
    _check_device(fn, left.device)
    if left.device.type == "cpu":
        return warp_compose_overlay_plain(
            right, m_inv, left, ty, tx, window, out_h, out_w
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


def warp_packed_plain(
    right: torch.Tensor, m_inv, window: Window, has_alpha: bool = True,
    emit_weight: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of K4b: `_inverse_map` and `_bilinear_sample_u8`
    on the image and, with `has_alpha`, on the 7-bit ramp alpha plane, the
    sample rounded to 7 bits."""
    wy0, wx0, wy1, wx1 = window
    sx, sy = warp_ops._inverse_map(m_inv, wy1 - wy0, wx1 - wx0, wx0, wy0,
                                   right.device)
    rgb_f, wsum = warp_ops._bilinear_sample_u8(right, sx, sy)
    rgb = warp_ops._to_u8(rgb_f)
    if not emit_weight:
        return rgb, None
    if not has_alpha:
        return rgb, wsum
    hr, wr = right.shape[:2]
    ramp = warp_ops._edge_ramp(hr, wr, right.device)
    alpha = torch.clamp(torch.round(ramp * 127.0), 1.0, 127.0)
    a_f, _ = warp_ops._bilinear_sample_u8(
        alpha.to(torch.uint8)[..., None], sx, sy
    )
    return rgb, warp_ops.true_div(torch.round(a_f[..., 0]), 127.0)


def warp_packed(
    right: torch.Tensor, m_inv, window: Window, has_alpha: bool = True,
    emit_weight: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Warp `right` through the canvas-to-source map ``m_inv`` onto the
    canvas window (wy0, wx0, wy1, wx1): returns ((h, w, 3) u8 RGB, (h, w)
    f32 weight, or None when not `emit_weight`)."""
    fn = "warp_packed"
    _check_image(fn, "right", right)
    wy0, wx0, wy1, wx1 = window = tuple(map(int, window))
    if not (0 <= wy0 <= wy1 and 0 <= wx0 <= wx1):
        raise ValueError(f"{fn}: bad window {window}")
    _check_device(fn, right.device)
    if right.device.type == "cpu":
        return warp_packed_plain(right, m_inv, window, has_alpha,
                                 emit_weight)
    if not right.is_contiguous():
        raise ValueError(f"{fn}: right must be contiguous")
    win_h, win_w = wy1 - wy0, wx1 - wx0
    rgb = torch.empty((win_h, win_w, 3), dtype=torch.uint8,
                      device=right.device)
    w = (torch.empty((win_h, win_w), dtype=torch.float32,
                     device=right.device) if emit_weight else None)
    if win_h == 0 or win_w == 0:
        return rgb, w
    hr, wr = right.shape[:2]
    global packed_launches
    _build.launch(
        "pano_warp_packed", right.device,
        right.data_ptr(), rgb.data_ptr(), 0 if w is None else w.data_ptr(),
        hr, wr, wy0, wx0, win_h, win_w, int(has_alpha), int(emit_weight),
        *warp_ops._m_floats(m_inv),
    )
    packed_launches += 1
    return rgb, w
