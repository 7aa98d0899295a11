"""pano_tpu_torch: pano_tpu in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

Harris corners -> SSD patch matching -> RANSAC homography -> perspective
warp and blend (overlay, feather, multiband, optional exposure gain), for
a pair or for many images (fold, chain and auto modes), held against the
JAX package ``pano_tpu``, which stays the reference. This package imports
no JAX.

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher, stitch_all_images
    pano = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                        device="cuda").stitch_pair_fast(left_bgr_u8,
                                                        right_bgr_u8)
    pano = stitch_all_images(images, DEFAULT_CONFIG, mode="chain",
                             device="cuda")   # host uint8 BGR
"""

import torch

# The geometry (3x3 chains, 8x8 solves, 9x9 normal matrices) needs true
# float32, the counterpart of the JAX package's "highest" matmul precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from pano_tpu_torch.config import (  # noqa: E402
    DEFAULT_CONFIG,
    HarrisOptions,
    PanoConfig,
    RansacOptions,
    StitchOptions,
    config_from_reference,
)
from pano_tpu_torch.pipeline import (  # noqa: E402
    PairStitcher,
    stitch_all_images,
)

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "HarrisOptions",
    "PanoConfig",
    "RansacOptions",
    "StitchOptions",
    "PairStitcher",
    "config_from_reference",
    "stitch_all_images",
]
