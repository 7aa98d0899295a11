#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (pano_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py [--seed N]

Phases, one line of numbers each; any failure raises, so the exit code is
non-zero and the last line is not printed:

1. device: nvidia-smi name and power limit, torch and CUDA versions;
   no CUDA device -> exit 1.
2. build: compiles pano_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. pair: a deterministic 4156x3117 textured pair from --seed; the right
   image is the left one's scene shifted by (dx, dy) = (1400, 37), so
   the right->left homography is that translation.
4. kernels: each of the four kernels against its plain PyTorch version
   on the card, at the main path's shapes, with the tolerances below;
   median time of 10 runs (CUDA events, L2 flushed) beside the plain
   version's.
5. main path: PairStitcher(DEFAULT_CONFIG, device="cuda")
   .stitch_pair_fast(left, right) with K = 8192 and 1000 hypotheses: the
   recovered H within 0.5 px of the planted one at the right image's
   corners, the canvas of the planted geometry, the overlap equal to the
   left image up to +-1, and each kernel launched by that call
   (K1 x2, K2 x2, K3 x1, K4a x1); warm wall time on device-resident
   images (median of 5, synchronized on both sides) and peak device
   memory.

The last three lines are the nvidia-smi line, a JSON object with the
per-kernel numbers, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
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
}


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


def check_warp(got, want, window) -> float:
    """Exact bilinear against itself in another rounding order: max |d| <= 1,
    d != 0 on < 0.1% of the window's pixels."""
    d = (got.int() - want.int()).abs().amax(-1)
    wy0, wx0, wy1, wx1 = window
    win_px = max((wy1 - wy0) * (wx1 - wx0), 1)
    dmax = int(d.max())
    share = float((d != 0).sum()) / win_px
    check(dmax <= 1, f"K4a max |d| {dmax}")
    check(share < 1e-3, f"K4a share of d != 0: {share}")
    return float(dmax)


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

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.ops import (
        cuda_gather, cuda_harris, cuda_match, cuda_warp, harris, match,
    )
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
    res["K3"] = dict(
        max_abs_err=float((got[0][fin] - want[0][fin]).abs().max())
        if bool(fin.any()) else 0.0,
        ms=timer(lambda: cuda_match.match_cores(desc_r, bv_r, desc_l, bv_l)),
        plain_ms=timer(
            lambda: cuda_match.match_cores_plain(desc_r, bv_r, desc_l, bv_l)),
    )
    log("K3 match_streaming", kq=desc_r.shape[0], kt=desc_l.shape[0],
        d=desc_r.shape[1], **res["K3"])

    h_plant = np.array([[1.0, 0, DX], [0, 1.0, DY], [0, 0, 1.0]])
    m_proj = np.array(
        [[0.97, 0.02, 12.0], [-0.015, 1.02, 4.0], [2e-5, -1e-5, 1.0]]
    )
    errs = []
    for tag, hmat in (("planted", h_plant), ("projective", h_plant @ m_proj)):
        row = np.zeros(14, np.float32)
        row[:9] = hmat.ravel()
        geo = fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
        call_args = (right, geo.m_inv, left, geo.ty, geo.tx, geo.window,
                     geo.canvas_h, geo.canvas_w)
        got = cuda_warp.warp_compose_overlay(*call_args)
        want = cuda_warp.warp_compose_overlay_plain(*call_args)
        errs.append(check_warp(got, want, geo.window))
        log(f"K4a {tag}", canvas=(geo.canvas_h, geo.canvas_w),
            window=geo.window, max_abs_err=errs[-1])
        if tag == "planted":
            res["K4a"] = dict(
                ms=timer(lambda: cuda_warp.warp_compose_overlay(*call_args)),
                plain_ms=timer(
                    lambda: cuda_warp.warp_compose_overlay_plain(*call_args)),
            )
    res["K4a"]["max_abs_err"] = max(errs)
    log("K4a warp_compose_overlay", **res["K4a"])
    del got, want, desc_r, desc_l

    # 5. the main path, through the entry point a user calls
    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    mods = {"K1": cuda_harris, "K2": cuda_gather, "K3": cuda_match,
            "K4a": cuda_warp}
    for mod in mods.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pano = stitcher.stitch_pair_fast(left, right)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: mod.launches for k, mod in mods.items()}
    check(launches == {"K1": 2, "K2": 2, "K3": 1, "K4a": 1},
          f"kernel launches in one stitch_pair_fast: {launches}")
    check(pano is not None, "stitch_pair_fast returned None")
    check(pano.is_cuda and pano.dtype == torch.uint8,
          f"result {pano.device} {pano.dtype}")

    est = stitcher.last_estimate
    h_est = est[:9].reshape(3, 3).astype(np.float64)
    corners = np.array([[0, 0], [W_IMG, 0], [W_IMG, H_IMG], [0, H_IMG]],
                       np.float64)
    ch = np.c_[corners, np.ones(4)] @ h_est.T
    corner_err = float(np.abs(ch[:, :2] / ch[:, 2:3]
                              - (corners + [DX, DY])).max())
    check(corner_err < 0.5, f"recovered H off by {corner_err} px at corners")
    # The canvas is ceil() of the warped extent, so f32 noise of 1e-5 px
    # in the estimate can add a row or column to the planted geometry.
    geo = fused_canvas_geometry(est, left.shape[:2], right.shape[:2])
    plant_shape = (H_IMG + DY, W_IMG + DX)
    check(tuple(pano.shape) == (geo.canvas_h, geo.canvas_w, 3)
          and all(0 <= a - b <= 1 for a, b in zip(pano.shape, plant_shape)),
          f"canvas {tuple(pano.shape)} vs planted {plant_shape}")
    ov = (pano[DY:H_IMG, DX:W_IMG].int() - left[DY:H_IMG, DX:W_IMG].int())
    ov_max = int(ov.abs().max())
    check(ov_max <= 1, f"overlap differs from the left image by {ov_max}")
    log("main path", inliers=int(est[9]), matches=int(est[12]),
        corner_err_px=round(corner_err, 5), canvas=tuple(pano.shape),
        overlap_max_abs_diff=ov_max, first_call_ms=round(first_ms, 3),
        launches=launches)

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stitcher.stitch_pair_fast(left, right)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(out, pano), "repeat stitch differs from the first")
    peak = torch.cuda.max_memory_allocated() / 2**20
    log("wall", pair_ms_median=round(float(np.median(walls)), 3),
        pair_ms_all=[round(w, 3) for w in walls],
        peak_mem_mib=round(peak, 1), card=f"'{smi}'")

    # 6. the record lines
    print(smi)
    print(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
         "plain_ms": res[k]["plain_ms"]}
        for k in ("K1", "K2", "K3", "K4a")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
