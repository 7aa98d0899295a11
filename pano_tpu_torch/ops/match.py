"""SSD patch matching: descriptors (K2), matcher cores (K3), epilogue.

Counterpart of ``pano_tpu/ops/match.py``. Descriptors are the 5x5x3 patch
around each keypoint as f32, zero-padded to 128 columns; the cores come
from the streaming kernel or the dense plain version (bit-identical, see
``ops/cuda_match.py``), followed by the JAX package's validity, Lowe ratio
and cross-check epilogue.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pano_tpu_torch.config import HarrisOptions
from pano_tpu_torch.ops import cuda_gather, cuda_match
from pano_tpu_torch.ops.harris import KeyPoints
from pano_tpu_torch.timer import span


class Matches(NamedTuple):
    """Fixed-capacity match set; row i is query keypoint i.

    train_idx: (K,) int32 best-match index into the train keypoints.
    ssd:       (K,) float32 best SSD.
    valid:     (K,) bool: border-valid query, a train match, ssd < thresh,
               and the ratio test and cross-check when enabled.
    """

    train_idx: torch.Tensor
    ssd: torch.Tensor
    valid: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def extract_patch_descriptors(
    img_u8: torch.Tensor, kps: KeyPoints, patch_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (desc (K, d_pad) float32, border_valid (K,) bool), one K2
    call: descriptors of invalid keypoints are zeros; border validity is
    the reference's clip test on valid keypoints."""
    return cuda_gather.gather_patches(img_u8, kps.xy.contiguous(),
                                      kps.valid.contiguous(), patch_size)


def match_descriptors(
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    max_ssd_thresh: float,
    ratio_thresh: float = 0.0,
    cross_check: bool = False,
) -> Matches:
    """Brute-force argmin-SSD matching of query descriptors against train.

    Lowe ratio: reject if best >= ratio^2 * second-best (a missing second
    neighbour passes). Cross check: require a mutual nearest neighbour."""
    best_ssd, best_idx, second, col_best = cuda_match.match_cores(
        desc_q, valid_q, desc_t, valid_t
    )
    valid = (
        valid_q
        & torch.isfinite(best_ssd)
        & (best_ssd < torch.tensor(max_ssd_thresh, dtype=torch.float32))
    )
    if ratio_thresh > 0.0:
        r2 = torch.tensor(ratio_thresh * ratio_thresh, dtype=torch.float32)
        valid = valid & (~torch.isfinite(second) | (best_ssd < r2 * second))
    if cross_check:
        rows = torch.arange(desc_q.shape[0], dtype=torch.int32,
                            device=desc_q.device)
        valid = valid & (col_best[best_idx.long()] == rows)
    best_ssd = torch.where(valid, best_ssd, torch.zeros_like(best_ssd))
    best_idx = torch.where(valid, best_idx, torch.zeros_like(best_idx))
    return Matches(train_idx=best_idx, ssd=best_ssd, valid=valid)


def match_keypoints(
    kps_q: KeyPoints,
    kps_t: KeyPoints,
    img_q: torch.Tensor,
    img_t: torch.Tensor,
    opts: HarrisOptions,
) -> Matches:
    """Descriptors for both sides, then argmin-SSD. ``q`` is the query
    side (the reference's keypointsL/image1), ``t`` the train side."""
    with span("match"):
        desc_q, bq = extract_patch_descriptors(img_q, kps_q, opts.patch_size)
        desc_t, bt = extract_patch_descriptors(img_t, kps_t, opts.patch_size)
        return match_descriptors(
            desc_q, bq, desc_t, bt, opts.max_ssd_thresh,
            ratio_thresh=opts.ratio_thresh, cross_check=opts.cross_check,
        )


def gather_match_points(
    kps_q: KeyPoints, kps_t: KeyPoints, matches: Matches
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pts_q (K, 2) f32, pts_t (K, 2) f32, valid (K,) bool): row i pairs
    a query keypoint with its train match; valid matches are compacted to
    the front in order, so RANSAC samples from [0, count)."""
    with span("match"):
        order = torch.argsort((~matches.valid).to(torch.uint8), stable=True)
        pts_q = kps_q.xy[order].float()
        pts_t = kps_t.xy[matches.train_idx[order].long()].float()
        count = matches.valid.sum(dtype=torch.int32)
        valid = torch.arange(
            matches.valid.shape[0], dtype=torch.int32, device=count.device
        ) < count
        return pts_q, pts_t, valid
