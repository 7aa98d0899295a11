#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (pano_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py [--seed N]

Phases, one line of numbers each; any failure raises, so the exit code is
non-zero and the last line is not printed:

1. device: nvidia-smi name and power limit, torch and CUDA versions;
   no CUDA device -> exit 1.
2. build: compiles pano_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
   process per source, all started together.
3. pair: a deterministic 4156x3117 textured pair from --seed; the right
   image is the left one's scene shifted by (dx, dy) = (1400, 37), so
   the right->left homography is that translation.
4. kernels: each of the six kernels against its plain PyTorch version on
   the card, at the main path's shapes, with the tolerances below; median
   time of 10 runs (CUDA events, L2 flushed) beside the plain version's
   and, where one PyTorch call computes the same function, that call's.
   K4a, K4b and K5 run on the planted translation and on a mild
   projective H; K4b with and without the ramp alpha, K5 with overlay
   and feather.
5. main path (overlay): PairStitcher(DEFAULT_CONFIG, device="cuda")
   .stitch_pair_fast(left, right) with K = 8192 and 1000 hypotheses: the
   recovered H within 0.5 px of the planted one at the right image's
   corners, the canvas of the planted geometry, the overlap equal to the
   left image up to +-1, and each kernel launched by that call
   (K1 x2, K2 x2, K3 x1, K4a x1, K4b x0, K5 x0); warm wall time on
   device-resident images (median of 5, synchronized on both sides) and
   peak device memory.
6. feather path: the same with blend="feather" (K4b x1, K5 x1, K4a x0),
   the same checks, median of 5 and peak memory.
7. multiband and feather+gain: one call each, launch counts, the overlap
   against the left image (+-1 with gain, +-2 with multiband: its f32
   pyramid round trip) and the call's wall time; multiband also on the
   planted H itself.
8. staged path: stitch_pair with print_timing=True and overlay, once: the
   four stage lines in the reference's format, and the panorama within
   +-1 of the fused one.

The last three lines are the nvidia-smi line, a JSON object with the
per-kernel numbers (each kernel's launches from the path that runs it:
K1-K4a from phase 5, K4b and K5 from phase 6), and {"ok": true, ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import time

import numpy as np

H_IMG, W_IMG = 3117, 4156   # the mountain pair's size (bench.py)
DX, DY = 1400, 37           # planted right -> left translation

# name, source, TPU kernel it replaces (file:line of its pallas_call)
KERNELS = {
    "K1": ("harris_scores", "pano_tpu_torch/csrc/harris.cu",
           "pano_tpu/ops/pallas_harris.py:406"),
    "K2": ("gather_patches", "pano_tpu_torch/csrc/gather.cu",
           "pano_tpu/ops/pallas_gather.py:188"),
    "K3": ("match_streaming", "pano_tpu_torch/csrc/match.cu",
           "pano_tpu/ops/pallas_match.py:193"),
    "K4a": ("warp_compose_overlay", "pano_tpu_torch/csrc/warp.cu",
            "pano_tpu/ops/pallas_warp.py:1030"),
    "K4b": ("warp_packed", "pano_tpu_torch/csrc/warp.cu",
            "pano_tpu/ops/pallas_warp.py:870"),
    "K5": ("compose_canvas", "pano_tpu_torch/csrc/compose.cu",
           "pano_tpu/ops/pallas_compose.py:341"),
}

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of its bytes over the memory rate and its operations
# over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12        # f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12    # bf16 tensor cores (K3's exact alternative)

# Operations per output pixel, counted from each kernel's arithmetic.
# K1: gray 5, two Sobels 22, products 3, two 5-tap Gaussian passes over
#     three planes 54, R 7, NMS 9 compares.
K1_OPS_PER_PX = 100
# K4a/K4b: inverse map 14, floor and fractions 4, tap weights 8, three
#     channels of four taps 24, round and clip 9; the weight 4 more, and
#     with the ramp alpha 12 a tap for the ramp and its sum.
WARP_OPS_PER_PX = 59
ALPHA_OPS_PER_PX = 52
# K5 feather: the left ramp 8, the total 2, per channel 2 products, a sum,
#     a division, two selects, round and clip (8).
FEATHER_OPS_PER_PX = 34

STAGE_LINE = re.compile(r"^(.+): (\d+\.\d{3}) ms$")
STAGES = ("Harris Corner Detection", "Harris Corner Matching",
          "RANSAC Homography Estimation", "Image Stitching")


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """Noise background (0..59) with bright 6x6 squares: the pattern of
    tests/test_pipeline.py's checkerboard_texture, drawn in bulk."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 60, (h, w, 3)).astype(np.uint8)
    n = max(60, h * w // 150)
    ys = r.integers(2, h - 10, n)
    xs = r.integers(2, w - 10, n)
    cols = r.integers(60, 255, (n, 3)).astype(np.uint8)
    for y, x, c in zip(ys, xs, cols):
        img[y:y + 6, x:x + 6] = c
    return img


def synthetic_pair(seed: int):
    base = texture(H_IMG + DY, W_IMG + DX, seed)
    left = np.ascontiguousarray(base[:H_IMG, :W_IMG])
    right = np.ascontiguousarray(base[DY:DY + H_IMG, DX:DX + W_IMG])
    return left, right


class Timer:
    """Median device time of `reps` runs with CUDA events, the 50 MB L2
    overwritten before each run."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the two least times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_harris(got, want) -> float:
    """tests/test_pallas_harris.py's bar: peak classification agrees on
    > 99.95% of block slots; on shared peaks rel > 2e-4 on < 0.5% of them
    and rel < 0.02 everywhere. Returns the max abs error on shared peaks."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    check(got.shape == want.shape, f"K1 shape {got.shape} vs {want.shape}")
    same = (np.isneginf(got) == np.isneginf(want)).mean()
    check(same > 0.9995, f"K1 peak agreement {same}")
    both = ~np.isneginf(got) & ~np.isneginf(want)
    if not both.any():
        return 0.0
    err = np.abs(got[both] - want[both])
    rel = err / np.maximum(np.abs(want[both]), 1.0)
    check((rel > 2e-4).mean() < 0.005, f"K1 rel>2e-4 share {(rel > 2e-4).mean()}")
    check(rel.max() < 0.02, f"K1 max rel {rel.max()}")
    return float(err.max())


def check_warp(got, want, window, name="K4a") -> float:
    """Exact bilinear against itself in another rounding order: max |d| <= 1,
    d != 0 on < 0.1% of the window's pixels."""
    d = (got.int() - want.int()).abs().amax(-1)
    wy0, wx0, wy1, wx1 = window
    win_px = max((wy1 - wy0) * (wx1 - wx0), 1)
    dmax = int(d.max()) if d.numel() else 0
    share = float((d != 0).sum()) / win_px
    check(dmax <= 1, f"{name} max |d| {dmax}")
    check(share < 1e-3, f"{name} share of d != 0: {share}")
    return float(dmax)


def stitch_once(torch, stitcher, left, right, mods, want_launches, tag):
    """One stitch_pair_fast with every launch count zeroed just before and
    read just after; checks the counts and the result's type. Returns
    (panorama, launches, wall ms)."""
    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pano = stitcher.stitch_pair_fast(left, right)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}
    check(launches == want_launches,
          f"{tag}: kernel launches in one stitch_pair_fast: {launches}")
    check(pano is not None, f"{tag}: stitch_pair_fast returned None")
    check(pano.is_cuda and pano.dtype == torch.uint8,
          f"{tag}: result {pano.device} {pano.dtype}")
    return pano, launches, wall


def check_planted(stitcher, pano, left, tag):
    """The recovered H and the canvas of the planted pair. Returns (corner
    error px, per-pixel max |d| of the overlap against the left image)."""
    from pano_tpu_torch.pipeline import fused_canvas_geometry

    est = stitcher.last_estimate
    h_est = est[:9].reshape(3, 3).astype(np.float64)
    corners = np.array([[0, 0], [W_IMG, 0], [W_IMG, H_IMG], [0, H_IMG]],
                       np.float64)
    ch = np.c_[corners, np.ones(4)] @ h_est.T
    corner_err = float(np.abs(ch[:, :2] / ch[:, 2:3]
                              - (corners + [DX, DY])).max())
    check(corner_err < 0.5, f"{tag}: recovered H off by {corner_err} px")
    # The canvas is ceil() of the warped extent, so f32 noise of 1e-5 px
    # in the estimate can add a row or column to the planted geometry.
    geo = fused_canvas_geometry(est, (H_IMG, W_IMG), (H_IMG, W_IMG))
    plant_shape = (H_IMG + DY, W_IMG + DX)
    check(tuple(pano.shape) == (geo.canvas_h, geo.canvas_w, 3)
          and all(0 <= a - b <= 1 for a, b in zip(pano.shape, plant_shape)),
          f"{tag}: canvas {tuple(pano.shape)} vs planted {plant_shape}")
    return corner_err, overlap_diff(pano, left)


def overlap_diff(pano, left):
    """Per-pixel max |d| of the planted overlap against the left image."""
    return (pano[DY:H_IMG, DX:W_IMG].int()
            - left[DY:H_IMG, DX:W_IMG].int()).abs().amax(-1)


def overlap_stats(ov) -> dict:
    """Max |d| over the overlap, and the share of pixels off by more
    than 1."""
    return dict(max=int(ov.max()), share_gt1=float((ov > 1).float().mean()))


def warm_walls(torch, stitcher, left, right, first, reps=5):
    """Median of `reps` warm calls (synchronized on both sides), every one
    equal to `first`, and the peak device memory over them."""
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stitcher.stitch_pair_fast(left, right)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(out, first), "repeat stitch differs from the first")
    return walls, torch.cuda.max_memory_allocated() / 2**20


def stage_breakdown(torch, stitcher, left, right, reps=5) -> dict:
    """Median ms of each stage of the fused pair, serialized (synchronize
    around every stage), over `reps` warm runs, through the same calls
    stitch_pair_fast makes."""
    from pano_tpu_torch.ops import harris, match, ransac
    from pano_tpu_torch.pipeline import fused_canvas_geometry

    cfg = stitcher.config
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        kps_l = timed("detect_left", lambda: harris.harris_detect(
            left, cfg.harris))
        kps_r = timed("detect_right", lambda: harris.harris_detect(
            right, cfg.harris))
        m = timed("match", lambda: match.match_keypoints(
            kps_r, kps_l, right, left, cfg.harris))
        pts = timed("match_points", lambda: match.gather_match_points(
            kps_r, kps_l, m))
        res = timed("ransac", lambda: ransac.ransac_homography(
            *pts, cfg.ransac, sampler=stitcher.sampler))
        row = np.zeros(14, np.float32)
        row[:9] = res.H.reshape(-1).cpu().numpy()
        geo = fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
        timed("compose", lambda: stitcher._compose(
            left, right, geo.m_inv, geo.ty, geo.tx, geo.window,
            geo.canvas_h, geo.canvas_w))
    return {k: round(float(np.median(v)), 3) for k, v in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs a GPU")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build (from the sources in this checkout)
    from pano_tpu_torch import _build

    t0 = time.perf_counter()
    _build.lib()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        library=_build.LIB_PATH.relative_to(_build.BUILD_DIR.parent.parent))
    for line in _build.LOG_PATH.read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)

    import dataclasses

    import torch.nn.functional as F

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.ops import (
        cuda_compose, cuda_gather, cuda_harris, cuda_match, cuda_warp,
        harris, match,
    )
    from pano_tpu_torch.ops import warp as warp_ops
    from pano_tpu_torch.pipeline import fused_canvas_geometry

    # 3. the synthetic pair
    t0 = time.perf_counter()
    left_np, right_np = synthetic_pair(args.seed)
    left = torch.from_numpy(left_np).cuda()
    right = torch.from_numpy(right_np).cuda()
    torch.cuda.synchronize()
    log("pair", shape=left_np.shape, dx=DX, dy=DY,
        seconds=round(time.perf_counter() - t0, 3))

    # 4. each kernel against its plain version, at the main path's shapes
    timer = Timer(torch)
    hopts = DEFAULT_CONFIG.harris
    res = {}

    got = cuda_harris.harris_scores(left, hopts.k, hopts.nms_thresh)
    want = cuda_harris.harris_scores_plain(left, hopts.k, hopts.nms_thresh)
    err = check_harris(got, want)
    res["K1"] = dict(
        max_abs_err=err,
        ms=timer(lambda: cuda_harris.harris_scores(
            left, hopts.k, hopts.nms_thresh)),
        plain_ms=timer(lambda: cuda_harris.harris_scores_plain(
            left, hopts.k, hopts.nms_thresh)),
        library_ms=None,
        bound=bound(nbytes(left, got), left.shape[0] * left.shape[1]
                    * K1_OPS_PER_PX),
    )
    log("K1 harris_scores", shape=tuple(got.shape), **res["K1"])

    kps_l = harris.harris_detect(left, hopts)
    kps_r = harris.harris_detect(right, hopts)
    p = hopts.patch_size
    _, bv_l = match.extract_patch_descriptors(left, kps_l, p)
    _, bv_r = match.extract_patch_descriptors(right, kps_r, p)
    xy_l = kps_l.xy.contiguous()
    got = cuda_gather.gather_patches(left, xy_l, bv_l, p)
    want = cuda_gather.gather_patches_plain(left, xy_l, bv_l, p)
    check(torch.equal(got, want), "K2 descriptors differ from the plain version")
    res["K2"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: cuda_gather.gather_patches(left, xy_l, bv_l, p)),
        plain_ms=timer(
            lambda: cuda_gather.gather_patches_plain(left, xy_l, bv_l, p)),
        library_ms=None,
        # The patch pixels it reads, the keypoints, the descriptors.
        bound=bound(xy_l.shape[0] * p * p * 3 + nbytes(xy_l, bv_l, got), 0),
    )
    log("K2 gather_patches", shape=tuple(got.shape),
        valid=int(bv_l.sum()), **res["K2"])

    desc_r = cuda_gather.gather_patches(right, kps_r.xy.contiguous(), bv_r, p)
    desc_l = got
    got = cuda_match.match_cores(desc_r, bv_r, desc_l, bv_l)
    want = cuda_match.match_cores_plain(desc_r, bv_r, desc_l, bv_l)
    for name, a, b in zip(("best", "idx", "second", "col_best"), got, want):
        check(torch.equal(a, b), f"K3 {name} differs from the plain version")
    fin = torch.isfinite(want[0]) & torch.isfinite(got[0])
    # Only p*p*3 = 75 of the 128 descriptor columns carry data (K2 writes
    # zeros in the rest); the function's work is over those 75. The kernel
    # still spends time on the zero columns.
    k3_ops = 2 * desc_r.shape[0] * desc_l.shape[0] * p * p * 3
    k3_bytes = nbytes(desc_r, bv_r, desc_l, bv_l, *got)
    res["K3"] = dict(
        max_abs_err=float((got[0][fin] - want[0][fin]).abs().max())
        if bool(fin.any()) else 0.0,
        ms=timer(lambda: cuda_match.match_cores(desc_r, bv_r, desc_l, bv_l)),
        plain_ms=timer(
            lambda: cuda_match.match_cores_plain(desc_r, bv_r, desc_l, bv_l)),
        library_ms=None,
        bound=bound(k3_bytes, k3_ops),
    )
    log("K3 match_streaming", kq=desc_r.shape[0], kt=desc_l.shape[0],
        d=desc_r.shape[1], bound_bf16_tensor_core=bound(
            k3_bytes, k3_ops, BF16_TC_OPS_PER_S), **res["K3"])

    h_plant = np.array([[1.0, 0, DX], [0, 1.0, DY], [0, 0, 1.0]])
    m_proj = np.array(
        [[0.97, 0.02, 12.0], [-0.015, 1.02, 4.0], [2e-5, -1e-5, 1.0]]
    )
    errs = {"K4a": [], "K4b": [], "K5": []}
    for tag, hmat in (("planted", h_plant), ("projective", h_plant @ m_proj)):
        row = np.zeros(14, np.float32)
        row[:9] = hmat.ravel()
        geo = fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
        wy0, wx0, wy1, wx1 = geo.window
        win_px = (wy1 - wy0) * (wx1 - wx0)

        # K4a: fused warp + overlay
        call_args = (right, geo.m_inv, left, geo.ty, geo.tx, geo.window,
                     geo.canvas_h, geo.canvas_w)
        got = cuda_warp.warp_compose_overlay(*call_args)
        want = cuda_warp.warp_compose_overlay_plain(*call_args)
        errs["K4a"].append(check_warp(got, want, geo.window))
        log(f"K4a {tag}", canvas=(geo.canvas_h, geo.canvas_w),
            window=geo.window, max_abs_err=errs["K4a"][-1])
        if tag == "planted":
            res["K4a"] = dict(
                ms=timer(lambda: cuda_warp.warp_compose_overlay(*call_args)),
                plain_ms=timer(
                    lambda: cuda_warp.warp_compose_overlay_plain(*call_args)),
                library_ms=None,
                bound=bound(nbytes(right, left, got),
                            win_px * WARP_OPS_PER_PX),
            )

        # K4b: the windowed warp, without and with the ramp alpha
        for has_alpha in (False, True):
            wargs = (right, geo.m_inv, geo.window, has_alpha)
            rgb, w = cuda_warp.warp_packed(*wargs)
            rgb_p, w_p = cuda_warp.warp_packed_plain(*wargs)
            rgb_err = check_warp(rgb, rgb_p, geo.window, "K4b")
            w_err = float((w - w_p).abs().max())
            check(w_err <= 1e-5, f"K4b {tag} weight max |d| {w_err}")
            errs["K4b"].append(max(rgb_err, w_err))
            log(f"K4b {tag}", has_alpha=has_alpha, window=geo.window,
                rgb_max_abs_err=rgb_err, weight_max_abs_err=w_err)
        if tag == "planted":
            # The library yardstick: grid_sample (bilinear, zero border) of
            # the f32 NCHW image on the precomputed sampling grid: the RGB
            # sample alone, unrounded, without the map or the weight.
            sx, sy = warp_ops._inverse_map(geo.m_inv, wy1 - wy0, wx1 - wx0,
                                           wx0, wy0, right.device)
            grid = torch.stack([sx / (W_IMG - 1) * 2 - 1,
                                sy / (H_IMG - 1) * 2 - 1], -1)[None]
            src = right.permute(2, 0, 1)[None].float().contiguous()
            res["K4b"] = dict(
                ms=timer(lambda: cuda_warp.warp_packed(*wargs)),
                plain_ms=timer(lambda: cuda_warp.warp_packed_plain(*wargs)),
                library_ms=timer(lambda: F.grid_sample(
                    src, grid, mode="bilinear", padding_mode="zeros",
                    align_corners=True)),
                bound=bound(nbytes(right, rgb, w),
                            win_px * (WARP_OPS_PER_PX + ALPHA_OPS_PER_PX)),
            )
            del sx, sy, grid, src

        # K5: compose the ramp-alpha window by overlay and by feather
        for blend in ("overlay", "feather"):
            cargs = (left, rgb, w, geo.ty, geo.tx, geo.window, geo.canvas_h,
                     geo.canvas_w, blend)
            got = cuda_compose.compose_canvas(*cargs)
            want = cuda_compose.compose_canvas_plain(*cargs)
            d = int((got.int() - want.int()).abs().max())
            check(d <= (0 if blend == "overlay" else 1),
                  f"K5 {tag} {blend} max |d| {d}")
            errs["K5"].append(float(d))
            log(f"K5 {tag}", blend=blend, canvas=(geo.canvas_h, geo.canvas_w),
                max_abs_err=d)
        if tag == "planted":
            res["K5"] = dict(
                ms=timer(lambda: cuda_compose.compose_canvas(*cargs)),
                plain_ms=timer(
                    lambda: cuda_compose.compose_canvas_plain(*cargs)),
                library_ms=None,
                bound=bound(nbytes(left, rgb, w, got),
                            win_px * FEATHER_OPS_PER_PX),
            )
    for k in ("K4a", "K4b", "K5"):
        res[k]["max_abs_err"] = max(errs[k])
        log(f"{k} {KERNELS[k][0]}", **res[k])
    del got, want, desc_r, desc_l, rgb, w, rgb_p, w_p

    mods = {"K1": (cuda_harris, "launches"), "K2": (cuda_gather, "launches"),
            "K3": (cuda_match, "launches"), "K4a": (cuda_warp, "launches"),
            "K4b": (cuda_warp, "packed_launches"),
            "K5": (cuda_compose, "launches")}
    front = {"K1": 2, "K2": 2, "K3": 1}

    def stitch_config(blend, gain=False):
        cfg = DEFAULT_CONFIG.replace(stitch=dataclasses.replace(
            DEFAULT_CONFIG.stitch, blend=blend, gain_compensation=gain))
        return PairStitcher(cfg, print_timing=False, device="cuda")

    # 5. the main path (overlay), through the entry point a user calls
    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    pano, launches, first_ms = stitch_once(
        torch, stitcher, left, right, mods,
        {**front, "K4a": 1, "K4b": 0, "K5": 0}, "overlay")
    corner_err, ov = check_planted(stitcher, pano, left, "overlay")
    ov_max = int(ov.max())
    check(ov_max <= 1, f"overlay: overlap differs from the left by {ov_max}")
    est = stitcher.last_estimate
    log("main path", inliers=int(est[9]), matches=int(est[12]),
        corner_err_px=round(corner_err, 5), canvas=tuple(pano.shape),
        overlap_max_abs_diff=ov_max, first_call_ms=round(first_ms, 3),
        launches=launches)
    walls, peak = warm_walls(torch, stitcher, left, right, pano)
    log("wall", pair_ms_median=round(float(np.median(walls)), 3),
        pair_ms_all=[round(w, 3) for w in walls],
        peak_mem_mib=round(peak, 1), card=f"'{smi}'")
    log("stages overlay", **stage_breakdown(torch, stitcher, left, right))

    # 6. the feather path: this slice's main path (K4b + K5)
    feather = stitch_config("feather")
    pano_f, launches_f, first_ms = stitch_once(
        torch, feather, left, right, mods,
        {**front, "K4a": 0, "K4b": 1, "K5": 1}, "feather")
    corner_err, ov = check_planted(feather, pano_f, left, "feather")
    ov_max = int(ov.max())
    check(ov_max <= 1, f"feather: overlap differs from the left by {ov_max}")
    log("feather path", corner_err_px=round(corner_err, 5),
        canvas=tuple(pano_f.shape), overlap_max_abs_diff=ov_max,
        first_call_ms=round(first_ms, 3), launches=launches_f)
    walls, peak = warm_walls(torch, feather, left, right, pano_f)
    log("wall feather", pair_ms_median=round(float(np.median(walls)), 3),
        pair_ms_all=[round(w, 3) for w in walls],
        peak_mem_mib=round(peak, 1), card=f"'{smi}'")
    log("stages feather", **stage_breakdown(torch, feather, left, right))
    del pano_f

    # 7. multiband and feather + gain, one call each. The pair is one
    # scene, so every blend gives the left image back over the overlap:
    # within +-1 with gain, within +-2 with multiband (its f32 pyramid
    # round trip), through the estimate and on the planted H itself.
    for tag, blend, gain in (("multiband", "multiband", False),
                             ("feather+gain", "feather", True)):
        st = stitch_config(blend, gain)
        torch.cuda.reset_peak_memory_stats()
        out, launches_x, wall = stitch_once(
            torch, st, left, right, mods,
            {**front, "K4a": 0, "K4b": 1, "K5": 1}, tag)
        peak = torch.cuda.max_memory_allocated() / 2**20
        corner_err, ov = check_planted(st, out, left, tag)
        stats = overlap_stats(ov)
        log(f"{tag} path", canvas=tuple(out.shape),
            overlap=stats, call_ms=round(wall, 3), launches=launches_x,
            peak_mem_mib=round(peak, 1))
        if blend == "multiband":
            check(stats["max"] <= 2, f"multiband overlap {stats}")
            row = np.zeros(14, np.float32)
            row[:9] = h_plant.ravel()
            geo = fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
            exact = st._compose(left, right, geo.m_inv, geo.ty, geo.tx,
                                geo.window, geo.canvas_h, geo.canvas_w)
            d_exact = int(overlap_diff(exact, left).max())
            check(d_exact <= 2, f"multiband round trip max |d| {d_exact}")
            log("multiband planted H", overlap_max_abs_diff=d_exact)
            del exact
        else:
            check(stats["max"] <= 1, f"{tag} overlap {stats}")
        del out
    # 8. the staged path with its stage lines (overlay)
    staged = PairStitcher(DEFAULT_CONFIG, print_timing=True, device="cuda")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pano_s = staged.stitch_pair(left, right)
        torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    labels = [m.group(1) for m in map(STAGE_LINE.match, lines) if m]
    check(len(labels) == len(lines) and labels == [STAGES[0], *STAGES],
          f"staged stage lines: {lines}")
    for line in lines:
        print("  " + line, flush=True)
    check(pano_s is not None and pano_s.is_cuda, "stitch_pair returned None")
    check(all(abs(a - b) <= 1 for a, b in zip(pano_s.shape, pano.shape)),
          f"staged canvas {tuple(pano_s.shape)} vs fused {tuple(pano.shape)}")
    hh, ww = min(pano_s.shape[0], pano.shape[0]), min(pano_s.shape[1],
                                                      pano.shape[1])
    d_staged = int((pano_s[:hh, :ww].int() - pano[:hh, :ww].int()).abs().max())
    check(d_staged <= 1, f"staged vs fused panorama max |d| {d_staged}")
    log("staged path", canvas=tuple(pano_s.shape), fused=tuple(pano.shape),
        max_abs_diff_vs_fused=d_staged)

    # 9. the record lines
    all_launches = {**launches, "K4b": launches_f["K4b"],
                    "K5": launches_f["K5"]}
    print(smi)
    print(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": all_launches[k],
         "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
         "plain_ms": res[k]["plain_ms"], "bound_ms": res[k]["bound"][0],
         "bound_by": res[k]["bound"][1], "library_ms": res[k]["library_ms"]}
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
