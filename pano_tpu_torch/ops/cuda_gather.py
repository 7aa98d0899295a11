"""K2: the descriptor step (``csrc/gather.cu``) and its plain version.

Replaces ``pano_tpu/ops/pallas_gather.py::gather_patches`` (body
``_make_kernel``, launched by ``_gather_kernel_call``) together with the
border test, unpack, mask and pad that the JAX package's
``extract_patch_descriptors`` runs around it. The kernel reads the u8 BGR
image directly and writes the border flags and the final zero-padded f32
descriptor rows; what bounds it on an H100 is noted at the top of
``csrc/gather.cu``.

``gather_patches`` takes the plain version for tensors on the CPU and
launches the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pano_tpu_torch import _build

# Kernel launches since the last reset: tests and chip_smoke.py read it to
# prove that the kernel path ran. It is not tracing; the profiler's spans
# (timer.span) are.
launches = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def descriptor_width(patch_size: int) -> int:
    """p*p*3 rounded up to 128 (the JAX package's lane padding)."""
    return _round_up(patch_size * patch_size * 3, 128)


def gather_patches_plain(
    img_u8: torch.Tensor, xy: torch.Tensor, kp_valid: torch.Tensor,
    patch_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(desc (K, d_pad) f32, border_valid (K,) bool).

    border_valid is the reference's clip test on valid keypoints (the JAX
    rule ``x + b < w``, written ``x < w - b`` so that no coordinate wraps);
    desc holds the per-tap clamped p x p x 3 patches, zero rows where
    border_valid is False and zero padding columns."""
    h, w = img_u8.shape[:2]
    k_cap = xy.shape[0]
    half = patch_size // 2
    x, y = xy[:, 0], xy[:, 1]
    border_valid = ((x >= half) & (y >= half) & (x < w - half)
                    & (y < h - half) & kp_valid)
    offs = torch.arange(-half, half + 1, device=xy.device, dtype=torch.int64)
    ys = torch.clamp(y[:, None].long() + offs[None, :], 0, h - 1)  # (K, P)
    xs = torch.clamp(x[:, None].long() + offs[None, :], 0, w - 1)  # (K, P)
    idx = (ys[:, :, None] * w + xs[:, None, :]).reshape(-1)
    d = patch_size * patch_size * 3
    patches = img_u8.reshape(-1, 3)[idx].reshape(k_cap, d).float()
    desc = torch.where(
        border_valid[:, None], patches, torch.zeros_like(patches)
    )
    desc = torch.nn.functional.pad(desc, (0, descriptor_width(patch_size) - d))
    return desc, border_valid


def gather_patches(
    img_u8: torch.Tensor, xy: torch.Tensor, kp_valid: torch.Tensor,
    patch_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descriptors and border flags of keypoints ``xy`` ((K, 2) int32 as
    (x, y)) whose ``kp_valid`` is True; see ``gather_patches_plain``."""
    k_cap = xy.shape[0]
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 3 \
            or img_u8.shape[2] != 3:
        raise ValueError("gather_patches: want an (H, W, 3) uint8 image")
    if xy.dtype != torch.int32 or xy.shape != (k_cap, 2):
        raise ValueError("gather_patches: want (K, 2) int32 keypoints")
    if kp_valid.dtype != torch.bool or kp_valid.shape != (k_cap,):
        raise ValueError("gather_patches: want (K,) bool validity")
    if patch_size < 1 or patch_size % 2 != 1:
        raise ValueError("gather_patches: patch_size must be odd")
    devs = {img_u8.device, xy.device, kp_valid.device}
    if len(devs) != 1:
        raise ValueError(f"gather_patches: tensors on several devices {devs}")
    if img_u8.device.type == "cpu":
        return gather_patches_plain(img_u8, xy, kp_valid, patch_size)
    if img_u8.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {img_u8.device}")
    if not (img_u8.is_contiguous() and xy.is_contiguous()
            and kp_valid.is_contiguous()):
        raise ValueError("gather_patches: inputs must be contiguous")
    h, w = img_u8.shape[:2]
    d_pad = descriptor_width(patch_size)
    desc = torch.empty((k_cap, d_pad), dtype=torch.float32,
                       device=img_u8.device)
    border_valid = torch.empty((k_cap,), dtype=torch.bool,
                               device=img_u8.device)
    if k_cap == 0:
        return desc, border_valid
    global launches
    _build.launch(
        "pano_gather_patches", img_u8.device,
        img_u8.data_ptr(), xy.data_ptr(), kp_valid.data_ptr(),
        desc.data_ptr(), border_valid.data_ptr(), h, w, k_cap, patch_size,
        d_pad,
    )
    launches += 1
    return desc, border_valid
