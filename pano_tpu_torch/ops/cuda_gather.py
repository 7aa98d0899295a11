"""K2: patch-descriptor gather (``csrc/gather.cu``) and its plain version.

Replaces ``pano_tpu/ops/pallas_gather.py::gather_patches`` (body
``_make_kernel``, launched by ``_gather_kernel_call``). The kernel reads
the u8 BGR image directly and writes the final zero-padded f32 descriptor
rows; what bounds it on an H100 is noted at the top of ``csrc/gather.cu``.

``gather_patches`` takes the plain version for tensors on the CPU and
launches the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import torch

from pano_tpu_torch import _build

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def descriptor_width(patch_size: int) -> int:
    """p*p*3 rounded up to 128 (the JAX package's lane padding)."""
    return _round_up(patch_size * patch_size * 3, 128)


def gather_patches_plain(
    img_u8: torch.Tensor, xy: torch.Tensor, border_valid: torch.Tensor,
    patch_size: int,
) -> torch.Tensor:
    """(K, d_pad) f32 descriptors: per-tap clamped p x p x 3 patches,
    zero rows where ``border_valid`` is False, zero padding columns."""
    h, w = img_u8.shape[:2]
    k_cap = xy.shape[0]
    half = patch_size // 2
    offs = torch.arange(-half, half + 1, device=xy.device, dtype=torch.int64)
    ys = torch.clamp(xy[:, 1:2].long() + offs[None, :], 0, h - 1)  # (K, P)
    xs = torch.clamp(xy[:, 0:1].long() + offs[None, :], 0, w - 1)  # (K, P)
    idx = (ys[:, :, None] * w + xs[:, None, :]).reshape(-1)
    patches = img_u8.reshape(-1, 3)[idx].reshape(k_cap, -1).float()
    desc = torch.where(
        border_valid[:, None], patches, torch.zeros_like(patches)
    )
    d = desc.shape[1]
    return torch.nn.functional.pad(desc, (0, descriptor_width(patch_size) - d))


def gather_patches(
    img_u8: torch.Tensor, xy: torch.Tensor, border_valid: torch.Tensor,
    patch_size: int,
) -> torch.Tensor:
    """Patch descriptors of keypoints ``xy`` ((K, 2) int32 as (x, y))."""
    k_cap = xy.shape[0]
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 3 \
            or img_u8.shape[2] != 3:
        raise ValueError("gather_patches: want an (H, W, 3) uint8 image")
    if xy.dtype != torch.int32 or xy.shape != (k_cap, 2):
        raise ValueError("gather_patches: want (K, 2) int32 keypoints")
    if border_valid.dtype != torch.bool or border_valid.shape != (k_cap,):
        raise ValueError("gather_patches: want (K,) bool validity")
    if patch_size % 2 != 1:
        raise ValueError("gather_patches: patch_size must be odd")
    devs = {img_u8.device, xy.device, border_valid.device}
    if len(devs) != 1:
        raise ValueError(f"gather_patches: tensors on several devices {devs}")
    if img_u8.device.type == "cpu":
        return gather_patches_plain(img_u8, xy, border_valid, patch_size)
    if img_u8.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {img_u8.device}")
    if not (img_u8.is_contiguous() and xy.is_contiguous()
            and border_valid.is_contiguous()):
        raise ValueError("gather_patches: inputs must be contiguous")
    h, w = img_u8.shape[:2]
    d_pad = descriptor_width(patch_size)
    desc = torch.empty((k_cap, d_pad), dtype=torch.float32,
                       device=img_u8.device)
    if k_cap == 0:
        return desc
    global launches
    _build.launch(
        "pano_gather_patches", img_u8.device,
        img_u8.data_ptr(), xy.data_ptr(), border_valid.data_ptr(),
        desc.data_ptr(), h, w, k_cap, patch_size, d_pad,
    )
    launches += 1
    return desc
