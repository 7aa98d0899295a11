"""Multiband's Laplacian pyramid on the card (``csrc/pyramid.cu``): REDUCE
and the collapse step, their plain versions, and ``laplacian_blend``.

Neither kernel replaces a TPU kernel: the JAX package leaves the pyramid
to XLA (``pano_tpu/ops/blend.py``). On the card the plain route
(``ops/blend.py``) runs every tap of every blur as its own elementwise
launch, ~1,000 a blend; this route runs a 5-level blend in 9 launches
(4 REDUCE, 5 collapse steps). What bounds the kernels (bytes) and what
their design does about it is noted in the source.

- REDUCE: ``ops/blend.py::_down`` of several planes at once (the blur's
  even samples only, the replicate border as clamped indices).
- The collapse step: one level of ``laplacian_blend``'s collapse with
  the expands it needs, ``out_i = up(out_{i+1}) + band_i``, band_i =
  ``la_i * (1 - m_i) + lb_i * m_i`` from the Gaussian levels i and i + 1
  of both images and level i of the mask; at the top level, the band of
  the Gaussians alone.

Planes go to the kernels as (pointer, row stride, column stride), so a
level may be any 2-D f32 view, e.g. a channel of an (H, W, 3) image. The
plain versions are ``ops/blend.py``'s own steps (``_down``, and ``_up``
with the band and the collapse); ``tests/test_torch_cuda.py`` holds the
kernels to them bit for bit on the card, and ``tests/test_torch_blend.py``
holds the kernels' route, on the plain versions, to ``laplacian_blend``.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors; any other device raises. ``laplacian_blend``
takes ``ops/blend.py::laplacian_blend`` itself on the CPU, so the CPU
route is unchanged.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import torch

from pano_tpu_torch import _build
from pano_tpu_torch.ops import blend as blend_ops

# Kernel launches since the last reset: tests and chip_smoke.py read them
# to prove that the kernel path ran. They are not tracing; the profiler's
# spans (timer.span) are.
reduce_launches = 0    # pyramid_reduce_kernel
collapse_launches = 0  # pyramid_collapse_kernel

# One plane of a launch (csrc/pyramid.cu Plane): pointer, row stride and
# column stride in elements.
_PLANE = struct.Struct("<Qii")
REDUCE_CHANNELS = 7  # most planes a REDUCE takes: a, b and the mask


def _check_planes(fn: str, planes: Sequence[torch.Tensor], n=None) -> None:
    if n is not None and len(planes) != n:
        raise ValueError(f"{fn}: takes {n} planes, got {len(planes)}")
    p0 = planes[0]
    for p in planes:
        if p.dtype != torch.float32 or p.dim() != 2:
            raise ValueError(f"{fn}: planes must be 2-D float32")
        if p.shape != p0.shape or p.device != p0.device:
            raise ValueError(f"{fn}: planes differ in shape or device")
    if p0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {p0.device}")
    if 0 in p0.shape:
        raise ValueError(f"{fn}: empty planes")


def _table(planes: Sequence[torch.Tensor]) -> bytes:
    return b"".join(_PLANE.pack(p.data_ptr(), p.stride(0), p.stride(1))
                    for p in planes)


def reduce_plain(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version of ``reduce``: ``ops/blend.py::_down``."""
    _check_planes("reduce", planes)
    return blend_ops._down(torch.stack(list(planes)))


def reduce(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """(C, (h + 1) // 2, (w + 1) // 2) f32: ``ops/blend.py::_down`` of the
    C (h, w) f32 `planes` (1 <= C <= 7, any strides), stacked."""
    fn = "reduce"
    _check_planes(fn, planes)
    if len(planes) > REDUCE_CHANNELS:
        raise ValueError(f"{fn}: at most {REDUCE_CHANNELS} planes")
    dev = planes[0].device
    if dev.type == "cpu":
        return reduce_plain(planes)
    h, w = planes[0].shape
    out = torch.empty((len(planes), (h + 1) // 2, (w + 1) // 2),
                      dtype=torch.float32, device=dev)
    global reduce_launches
    _build.launch("pano_pyramid_reduce", dev, _table(planes), len(planes),
                  h, w, out.data_ptr())
    reduce_launches += 1
    return out


def collapse_step_plain(
    fine: Sequence[torch.Tensor], coarse: Optional[Sequence[torch.Tensor]],
) -> torch.Tensor:
    """The plain version of ``collapse_step``: ``ops/blend.py``'s band
    and collapse, ``_up(out') + (la * (1 - m) + lb * m)`` with the bands
    ``la = ga - _up(ga')`` and ``lb = gb - _up(gb')``."""
    g = torch.stack(list(fine))
    m = torch.clamp(g[6], 0.0, 1.0)
    if coarse is None:
        return g[0:3] * (1.0 - m) + g[3:6] * m
    up = blend_ops._up(torch.stack(list(coarse)), *g.shape[-2:])
    la = g[0:3] - up[0:3]
    lb = g[3:6] - up[3:6]
    return up[6:9] + (la * (1.0 - m) + lb * m)


def _check_collapse(fine, coarse) -> None:
    fn = "collapse_step"
    _check_planes(fn, fine, 7)
    if coarse is not None:
        _check_planes(fn, coarse, 9)
        (h, w), (hc, wc) = fine[0].shape, coarse[0].shape
        if coarse[0].device != fine[0].device \
                or not (h <= 2 * hc and w <= 2 * wc):
            raise ValueError(f"{fn}: coarse planes {(hc, wc)} do not "
                             f"expand to {(h, w)} on its device")


def collapse_step(
    fine: Sequence[torch.Tensor], coarse: Optional[Sequence[torch.Tensor]],
) -> torch.Tensor:
    """One level of the collapse: `fine` the (H, W) f32 planes ga (3), gb
    (3) and gm (1) of this level; `coarse` the (h, w) planes ga (3), gb
    (3) and the collapsed result (3) of the next, or None at the top
    level. Returns this level's result, (3, H, W)."""
    _check_collapse(fine, coarse)
    dev = fine[0].device
    if dev.type == "cpu":
        return collapse_step_plain(fine, coarse)
    H, W = fine[0].shape
    h, w = coarse[0].shape if coarse is not None else (0, 0)
    out = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    global collapse_launches
    _build.launch("pano_pyramid_collapse", dev, _table(fine),
                  None if coarse is None else _table(coarse),
                  _table(out), H, W, h, w)
    collapse_launches += 1
    return out


def laplacian_blend(
    a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, levels: int = 5,
) -> torch.Tensor:
    """``ops/blend.py::laplacian_blend`` (its contract: (H, W, 3) f32 `a`
    and `b`, (H, W) f32 `mask`, sides multiples of 2**(levels - 1)):
    that function itself on the CPU; on the card, levels - 1 REDUCEs of
    the 7 planes and `levels` collapse steps; the result, channels first
    on the card, is returned as an (H, W, 3) view."""
    if a.device.type == "cpu":
        return blend_ops.laplacian_blend(a, b, mask, levels)
    return kernel_route(a, b, mask, levels)


def kernel_route(
    a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, levels: int,
) -> torch.Tensor:
    """``laplacian_blend`` as the card runs it, through ``reduce`` and
    ``collapse_step`` (so through their plain versions on the CPU)."""
    h, w = a.shape[:2]
    step = 1 << (levels - 1)
    if h % step or w % step:
        raise ValueError(f"laplacian_blend: {h}x{w} is not a multiple of "
                         f"{step}")
    gs: List[List[torch.Tensor]] = [[*a.unbind(-1), *b.unbind(-1), mask]]
    for _ in range(levels - 1):
        gs.append(list(reduce(gs[-1]).unbind(0)))
    out = collapse_step(gs[-1], None)
    for i in reversed(range(levels - 1)):
        out = collapse_step(gs[i], gs[i + 1][:6] + list(out))
    return out.permute(1, 2, 0)
