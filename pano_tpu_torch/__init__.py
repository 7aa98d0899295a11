"""pano_tpu_torch: the pair stitch of pano_tpu in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

Harris corners -> SSD patch matching -> RANSAC homography -> perspective
warp with overlay blend, held against the JAX package ``pano_tpu``, which
stays the reference. This package imports no JAX.

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    pano = PairStitcher(DEFAULT_CONFIG, device="cuda").stitch_pair_fast(
        left_bgr_u8, right_bgr_u8)
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
from pano_tpu_torch.pipeline import PairStitcher  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "HarrisOptions",
    "PanoConfig",
    "RansacOptions",
    "StitchOptions",
    "PairStitcher",
    "config_from_reference",
]
