"""Pipeline configuration for the PyTorch + CUDA port.

A field-for-field copy of ``pano_tpu/config.py``: the same frozen
dataclasses, field names and defaults, so a configuration written for the
JAX package means the same thing here. It is a copy and not an import
because importing ``pano_tpu`` pulls in JAX.

The JAX package's ``use_pallas_*`` switches have no counterpart here
(``config_from_reference`` drops them): every stage launches its
hand-written Hopper kernel (``pano_tpu_torch/csrc``) on CUDA tensors and
runs its plain PyTorch version only on CPU tensors.

The system carries no weights; the only state that crosses from the JAX
package is its configuration, which ``config_from_reference`` converts.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HarrisOptions:
    """Harris corner detection + SSD patch matching options."""

    k: float = 0.04                 # Harris detector parameter
    nms_thresh: float = 1e6         # Harris response threshold
    nms_neighborhood: int = 3       # NMS window size, must be odd
    patch_size: int = 5             # matching patch size
    max_ssd_thresh: float = 1e8     # SSD matching threshold
    max_keypoints: int = 8192       # static K for top-K keypoint selection
    ratio_thresh: float = 0.85      # Lowe ratio: best < r^2 * second-best
    #                                 (0 disables)
    cross_check: bool = True        # mutual-nearest-neighbor check
    topk_method: str = "approx"     # kept for config parity: the JAX
    #                                 package's approximate selection is
    #                                 exact off the TPU, so both values
    #                                 select exactly here
    topk_recall: float = 0.92       # kept for config parity (see above)
    match_block: int = 0            # kept for config parity: the matcher
    #                                 always streams (kernel) or runs dense
    #                                 (plain version)

    def __post_init__(self):
        if self.nms_neighborhood % 2 != 1:
            raise ValueError("nms_neighborhood must be odd")
        if self.nms_neighborhood < 3:
            # The 2x2 block reduction before top-K is lossless only when
            # NMS guarantees pairwise non-adjacent peaks.
            raise ValueError("nms_neighborhood must be >= 3")
        if self.patch_size % 2 != 1:
            raise ValueError("patch_size must be odd")
        if not (0.0 < self.topk_recall <= 1.0):
            raise ValueError("topk_recall must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """RANSAC homography estimation options."""

    num_iterations: int = 1000      # hypothesis count
    num_samples: int = 4            # minimal sample size
    distance_threshold: float = 3.0  # inlier reprojection distance in px
    seed: int = 0                   # torch.Generator seed (the JAX package
    #                                 seeds jax.random with it; the two
    #                                 draw different samples)
    refine: bool = True             # least-squares re-fit on the inliers
    min_inliers: int = 10           # quality gate before trusting the model


@dataclasses.dataclass(frozen=True)
class StitchOptions:
    """Whole-pipeline options."""

    blend: str = "overlay"          # 'overlay' | 'feather' | 'multiband'
    dtype: str = "float32"          # compute dtype for image math
    canvas_bucket: int = 128        # kept for config parity: the port
    #                                 allocates the exact canvas
    interpolation: str = "bilinear"  # warp sampling
    gain_compensation: bool = False  # scalar exposure gain over the
    #                                  overlap, applied to the warped
    #                                  right image (any blend)
    bundle_adjust: str = "auto"     # not ported yet (multi-image modes)


@dataclasses.dataclass(frozen=True)
class PanoConfig:
    harris: HarrisOptions = dataclasses.field(default_factory=HarrisOptions)
    ransac: RansacOptions = dataclasses.field(default_factory=RansacOptions)
    stitch: StitchOptions = dataclasses.field(default_factory=StitchOptions)

    def replace(self, **kw) -> "PanoConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PanoConfig()


def config_from_reference(obj) -> PanoConfig:
    """Build this package's PanoConfig from any object with the same
    fields, such as ``pano_tpu.config.PanoConfig``."""

    def convert(cls, sub):
        return cls(
            **{f.name: getattr(sub, f.name) for f in dataclasses.fields(cls)}
        )

    return PanoConfig(
        harris=convert(HarrisOptions, obj.harris),
        ransac=convert(RansacOptions, obj.ransac),
        stitch=convert(StitchOptions, obj.stitch),
    )
