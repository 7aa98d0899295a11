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
``_bilinear_sample_u8`` on the image and on that alpha plane; the kernel
reads the plane's values from ``ramp_alpha_table``, built once per source
shape and device.

``warp_packed_batched`` is K4b's batched entry (the TPU kernel's
``_warp_batched_call``): a group of images that share one source shape,
each warped into its own window, in one launch for each 16 windows;
``warp_packed`` is the same launch with one window, so every output is
bit for bit the single window's. Its plain version is a loop of
``warp_packed_plain``.

What bounds the kernels on an H100 is noted at the top of
``csrc/warp.cu``. Each wrapper takes its plain version for tensors on the
CPU and launches its kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import warp as warp_ops

# Kernel launches since the last reset: tests and chip_smoke.py read them
# to prove that the kernel path ran. They are not tracing; the profiler's
# spans (timer.span) are.
launches = 0                 # K4a, warp_compose_overlay
packed_launches = 0          # K4b, warp_packed
batched_packed_launches = 0  # K4b, warp_packed_batched

# One element of a K4b launch (csrc/warp.cu WarpElem): source pointer,
# offsets into the flat RGB (bytes) and weight (floats) buffers, the 9 map
# floats, the window's origin and size, and its first block (set by the C
# entry).
_ELEM = struct.Struct("<Qqq9f4iI")
assert _ELEM.size == 80

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


def ramp_alpha_table(h: int, w: int, device=None) -> torch.Tensor:
    """(ceil(max(h, w) / 2) + 1,) f32: g(d) = clip(round(d / (min(h, w) /
    2) * 127), 1, 127), the 7-bit ramp alpha of `warp_packed_plain` as a
    function of the distance d to the nearest edge, in its operations.
    Since g does not decrease, the alpha plane at (yi, xi) is min(g(dx),
    g(dy)) with dx = min(xi + 1, w - xi) and dy = min(yi + 1, h - yi): K4b
    reads it so."""
    d = torch.arange((max(h, w) + 1) // 2 + 1, dtype=torch.float32,
                     device=device)
    ramp = warp_ops.true_div(d, min(h, w) / 2.0)
    return torch.clamp(torch.round(ramp * 127.0), 1.0, 127.0)


@functools.lru_cache(maxsize=16)
def _alpha_table(h: int, w: int, device: torch.device) -> torch.Tensor:
    return ramp_alpha_table(h, w, device)


def _check_packed_window(fn: str, window) -> Window:
    wy0, wx0, wy1, wx1 = window = tuple(map(int, window))
    if not (0 <= wy0 <= wy1 and 0 <= wx0 <= wx1):
        raise ValueError(f"{fn}: bad window {window}")
    return window


def _launch_packed(fn, srcs, m_invs, windows, has_alpha, emit_weight):
    """K4b over same-shape contiguous CUDA sources, each into its own
    window: one launch for each 16 windows. Returns ((rgb, weight) per
    window, views into one flat RGB and one flat weight buffer, and the
    number of launches)."""
    if not all(s.is_contiguous() for s in srcs):
        raise ValueError(f"{fn}: sources must be contiguous")
    dev = srcs[0].device
    hr, wr = srcs[0].shape[:2]
    dims = [(wy1 - wy0, wx1 - wx0) for wy0, wx0, wy1, wx1 in windows]
    starts = [0]
    for h, w in dims:
        starts.append(starts[-1] + h * w)
    elems = b"".join(
        _ELEM.pack(s.data_ptr(), a * 3, a, *warp_ops._m_floats(m), wy0, wx0,
                   h, w, 0)
        for s, m, (wy0, wx0, _, _), (h, w), a in zip(srcs, m_invs, windows,
                                                     dims, starts))
    rgb = torch.empty(starts[-1] * 3, dtype=torch.uint8, device=dev)
    wt = (torch.empty(starts[-1], dtype=torch.float32, device=dev)
          if emit_weight else None)
    table = (_alpha_table(hr, wr, dev) if has_alpha and emit_weight
             else None)
    n = ctypes.c_int(0)
    _build.launch(
        "pano_warp_packed", dev, elems, len(srcs), rgb.data_ptr(),
        0 if wt is None else wt.data_ptr(),
        0 if table is None else table.data_ptr(), hr, wr, int(has_alpha),
        int(emit_weight), ctypes.byref(n),
    )
    out = [(rgb[a * 3:b * 3].view(h, w, 3),
            None if wt is None else wt[a:b].view(h, w))
           for a, b, (h, w) in zip(starts, starts[1:], dims)]
    return out, n.value


def warp_packed(
    right: torch.Tensor, m_inv, window: Window, has_alpha: bool = True,
    emit_weight: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Warp `right` through the canvas-to-source map ``m_inv`` onto the
    canvas window (wy0, wx0, wy1, wx1): returns ((h, w, 3) u8 RGB, (h, w)
    f32 weight, or None when not `emit_weight`). On the card, K4b's
    launch with one window."""
    fn = "warp_packed"
    _check_image(fn, "right", right)
    window = _check_packed_window(fn, window)
    _check_device(fn, right.device)
    if right.device.type == "cpu":
        return warp_packed_plain(right, m_inv, window, has_alpha,
                                 emit_weight)
    out, n = _launch_packed(fn, [right], [m_inv], [window], has_alpha,
                            emit_weight)
    global packed_launches
    packed_launches += n
    return out[0]


def warp_packed_batched_plain(
    srcs: Sequence[torch.Tensor], m_invs, windows: Sequence[Window],
    has_alpha: bool = True, emit_weight: bool = True,
) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The plain version of the batched launch: warp_packed_plain of each
    (source, map, window)."""
    return [warp_packed_plain(s, m, w, has_alpha, emit_weight)
            for s, m, w in zip(srcs, m_invs, windows)]


def warp_packed_batched(
    srcs: Sequence[torch.Tensor], m_invs, windows: Sequence[Window],
    has_alpha: bool = True, emit_weight: bool = True,
) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """warp_packed of each (source, map, window), one K4b launch for each
    16 of them: the sources share one shape (hr, wr, 3) and one device;
    each window has its own origin and size. Returns warp_packed's (rgb,
    weight) per element, views into one flat RGB and one flat weight
    buffer."""
    fn = "warp_packed_batched"
    srcs = list(srcs)
    windows = [_check_packed_window(fn, w) for w in windows]
    if not (len(srcs) == len(windows) == len(m_invs)) or not srcs:
        raise ValueError(f"{fn}: want as many sources, maps and windows, "
                         f"at least one")
    for s in srcs:
        _check_image(fn, "source", s)
    dev = srcs[0].device
    if any(s.device != dev or s.shape != srcs[0].shape for s in srcs):
        raise ValueError(f"{fn}: sources of different shapes or devices")
    _check_device(fn, dev)
    if dev.type == "cpu":
        return warp_packed_batched_plain(srcs, m_invs, windows, has_alpha,
                                         emit_weight)
    out, n = _launch_packed(fn, srcs, m_invs, windows, has_alpha,
                            emit_weight)
    global batched_packed_launches
    batched_packed_launches += n
    return out
