#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (pano_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py [--seed N]

Phases, one line of numbers each; any failure raises, so the exit code is
non-zero and the last line is not printed. No phase catches its own
failure.

1. device: nvidia-smi name and power limit, torch and CUDA versions;
   no CUDA device -> exit 1.
2. build: compiles pano_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
   process per source, all started together.
3. data: a deterministic 4156x3117 textured pair from --seed (the right
   image is the left one's scene shifted by (dx, dy) = (1400, 37), so the
   right->left homography is that translation), and a strip of four
   4156x3117 crops of one 8356x3169 scene at the planted offsets
   (0, 0), (1400, 37), (2800, 15), (4200, 52).
4. kernels: each of the eight kernels against its plain PyTorch version
   on the card, at the main path's shapes, with the tolerances below
   (every kernel bit-identical: torch.equal on every output, beside the
   tolerance checks); K1 also at the NMS windows 5, 7, 9 (one launch of
   the stencil) and 11, 15 (the R plane and the fold kernel), each also
   through harris_detect, which must return keypoints; median
   time of 10 runs (CUDA events, L2 flushed; `ms`, the wrapper's host
   time included where it outlasts the flush) beside the plain version's
   and, where one PyTorch call computes the same function, that call's.
   After all of them, each kernel's device time alone (`device_ms`: the
   card warmed by ~0.2 s of memsets, a spin before each run so that it
   is still busy while the host enqueues; K4b also without the ramp
   alpha and without the weight, K5 and K6 also with overlay, K1 at the
   other NMS windows), and the launch floor: the device time of a
   one-element fill_ under the same timer. K2 (the whole descriptor
   step: border flags and descriptors) runs on the left image's
   keypoints; its library call is torch.take of the flat image by the
   patches' byte index (no border test, mask, cast or padding). K3 has
   no library call; its product alone, torch.mm in f32 with TF32 off, is
   timed beside it as a yardstick (product_ms); K4a's and K4b's is
   F.grid_sample of the window. K4a, K4b and K5 run on the
   planted pair translation and on a mild projective H; K4b with and
   without the ramp alpha, K5 with overlay and feather. K6 runs a step
   of the strip's chain (image 2 into the canvas that holds image 1 and
   its weight ramp), planted and projective, overlay exact and feather
   within 1, the weight canvas exact; K6 updates in place, so each timed
   run starts from a fresh copy made outside the timed region. K7 (the
   refine's smallest eigenvector) runs on the planted pair's 9x9 normal
   matrix as the main path hands it over, also held to float64
   numpy.linalg.eigh (1 - |cos| <= 1e-5); its library call is
   torch.linalg.eigh, timed with the host sync of its error check. K8
   and K9, multiband's pyramid (REDUCE and the collapse step), run at a
   chain window's size (1504x2016) and its lower levels, each level
   torch.equal to the plain version and the whole blend to ops/blend.py's
   tap-per-launch route (its time `route_ms`, the kernels' `blend_ms`,
   with the launches a window), timed at level 0. Last,
   RANSAC's default table (JAX's randint, made on the card from a device
   n_valid) against the CPU's, and the time of one draw (draw_ms).
5. main path (overlay): PairStitcher(DEFAULT_CONFIG, device="cuda")
   .stitch_pair_fast(left, right) with K = 8192 and 1000 hypotheses: the
   recovered H within 0.5 px of the planted one at the right image's
   corners, the canvas of the planted geometry, the overlap equal to the
   left image up to +-1, and each kernel launched by that call
   (K1 x2, K2 x2, K3 x1, K7 x1, K4a x1, others x0); warm wall time on
   device-resident images (median of 5, synchronized on both sides) and
   peak device memory.
6. feather path: the same with blend="feather" (K4b x1, K5 x1, K4a x0),
   the same checks, median of 5 and peak memory.
7. multiband and feather+gain: one call each, launch counts, the overlap
   against the left image (+-1 with gain, +-2 with multiband: its f32
   pyramid round trip) and the call's wall time; multiband also on the
   planted H itself; multiband launches K8 x4 and K9 x5 (its one
   window's pyramid), feather+gain neither.
8. staged path: stitch_pair with print_timing=True and overlay, once: the
   four stage lines in the reference's format, and the panorama within
   +-1 of the fused one.
9. chain: stitch_all_images(strip, cfg, mode="chain", device="cuda") on
   the device-resident strip for overlay, feather, multiband and
   feather+gain: its printed lines, each recovered global within 0.5 px
   of the planted one at its image's corners, the planted canvas (+-1
   row or column), the panorama against the scene over covered pixels
   (+-2; multiband +-3; the composed globals carry about three times a
   pair's sub-pixel error onto sharp edges) with the share above +-1,
   and the launches (K1 x6, K2 x6, K3 x3, K7 x3, K4b x3, K6 x3 for overlay and
   feather and x0 for multiband and gain, K8 x12 and K9 x15 for multiband
   (4 and 5 a window) and x0 for the others, K4a and K5 x0); the warm wall
   time of overlay (median of 3) and peak memory, one call each for the
   others. After overlay, the chain's parts (its estimates, its
   composite) and the chain call with each result dropped before the
   next call and with the previous one held; then the panorama's host
   fetch on the 3169x8356x3 strip canvas: timer.fetch_image's no-alias
   check (a held result unchanged by the next fetch of other data, both
   in page-locked memory, a reused block equal), and the turns pageable
   (`.cpu().numpy()`, the parent's route), fetch_image, fetch_image,
   pageable, staged, staged (a reused page-locked buffer copied out into
   a fresh array, the design PERF.md weighs against fetch_image) under
   each of: results dropped, the previous one held, every one kept;
   5 calls a turn, each result equal to the canvas. Then
   composite_global on the planted globals themselves:
   overlay exact against the scene, feather +-1, multiband +-2.
10. auto: the strip in the order [2, 0, 3, 1], overlay: the
   "Auto-ordering" line places 4 of 4, the panorama against the scene
   over covered pixels within +-2 (the root goes in at its truncated
   offset, as in the JAX package), K1 x4, K2 x4, K3 x6, K7 x6; one call's wall
   time.
11. fold: mode="fold", timing="total", overlay, on the strip: the
   "Stitching image i of 4..." and "Image Stitching" lines, the
   panorama covering the planted canvas (+-2 px per step), K1 x6, K2 x6,
   K3 x3, K7 x3, K4a x3; one call's wall time.

12. cli: the strip's four images and the planted pair written as .ppm
   with the port's io (its codec named on the `cli data` line), each
   read back by the numpy PNM codec; one image's decode and the chain
   panorama's encode timed through both codecs; a child's start-up
   (import, CUDA context, library load) timed; then
   (a) `python -m pano_tpu_torch.cli gpu --mode chain --json` on the
   strip in a child process: exit 0, its printed lines, the panorama
   read back equal (np.array_equal) to phase 9's overlay chain, the
   --json stats (backend cuda, ok, the shape, the printed stage names);
   (b) `gpu --mode fold --blend feather` (K4b + K5) and `gpu --timing
   stages` (K1-K4a, the stage lines) on the pair in child processes,
   each against the planted canvas and the left image (+-1); (c)
   cli.main in process for chain and for fold with feather, the launch
   counts equal to phases 9 and 6; (d) `serve gpu --mode chain` in a
   child process with four jobs (the strip, the strip with feather, the
   strip again from the staging cache, one image alone): exit 0, status
   lines Job 1-3 ok and Job 4 failed in order, no staging failure on
   stderr, jobs 1 and 3 byte-equal to (a)'s file; make_staging_decoder
   on the card returns CUDA tensors equal to the files; (e) `gpu` with
   CUDA_VISIBLE_DEVICES="" exits 255 with its error on stderr and
   writes nothing; (f) one line: (a)'s process wall and its own Total
   Execution Time, each serve job's ms, the codec. The children load the
   library phase 2 built.

13. shard (pano_tpu_torch.parallel.shard), on phase 3's data:
   (a) batched K1 over the strip's four images in one launch:
   torch.equal to the plain version and to four single launches; its
   time (`ms`, `device_ms`) beside the four single launches' device time;
   (b) batched K4b over the chain's three windows (the planted globals,
   the ramp alpha): the same checks and times; (c)
   stitch_all_images_sharded on a mesh of the card: chain and auto equal
   byte for byte to phases 9 and 10's panoramas (K1 batched x1, K4b
   batched x1), fold the staged fold under the tag "Sharded"; the chain's
   call against the one-device chain's in turns (one-device, sharded,
   sharded, one-device), peak memory, launches; (d) the card repeated:
   chain on a mesh of data 3 (K1 and K4b batched x3), equal to phase 9's,
   and the fold on hyp 4, each pair's H within 0.5 px of the planted
   one; (e) stitch_pairs_batched on four 4156x3117 pairs (the strip's
   three adjacent pairs and phase 3's pair): each estimate row
   torch.equal to PairStitcher._fused_estimate_impl's, each canvas
   torch.equal to PairStitcher.composite of its H, the batch's wall time
   against the same four pairs one by one, in turns; (f) `python -m
   pano_tpu_torch.cli sharded --mode chain` in a child process: its lines,
   and its file equal to phase 9's panorama.

14. the measuring and driver layer, on phase 3's pair at full size:
   (b) benchmark_throughput_torch.throughput at depth 1 and 3, 30 pairs,
   in turns (1, 3, 3, 1): pairs/s, ms_per_pair, peak memory, K1-K4a and
   K7 x31, no fallback pair; at each depth once more untimed through its
   loop (`pipelined`), every retired panorama torch.equal to phase 5's;
   the synchronizing operations a pair pays under
   torch.cuda.set_sync_debug_mode, which must be 0; (a) then
   bench_torch's measurement (`_measure`: `measure`'s JSON and its last
   panorama): bench.py's keys, K1-K4a and K7 x9 (warm-up, 5
   timed calls, 3 traced), device_compute_ms between 0 and value (the
   busy share logged), the block's last panorama torch.equal to phase
   5's; and the loop at depth 1 once more after its profiler block;
   (c) benchmark_panorama_torch.py in child processes: the resolution
   sweep through the gpu CLI at scales 0.25, 0.5, 1.0 of the pair's .ppm
   files, and the device sweep on the card repeated at 1, 2, 4
   (--device-scale 1.0 --kpts 8192), each row's host fetches 1 for the
   estimates and 2 for the whole batch; (d)
   benchmark_serial_parallel_torch.py on the pair's directory at full
   size; (f) `bash pano_torch.sh perf gpu` on the pair: exit 0, the
   report naming K1, K2, K3 (its three kernels) and K4a with non-zero
   device time; (e) graft_entry_torch.entry() on the card (K1 x2, K2 x2,
   K3 x1, K7 x1) against the CPU's (inliers equal, H within 0.5 px, canvas
   within 1) and dryrun_multichip(1) (and the card count where there is
   more than one card) against the CPU's.

15. The last three lines are the nvidia-smi line, a JSON object with
the per-kernel numbers (each kernel's launches from the path that runs
it: K1-K4a and K7 from phase 5, K4b and K5 from phase 6, K6 from phase 9's
overlay chain, K8 and K9 from phase 9's multiband chain, the batched K1
and K4b from phase 13's chain on the card), and {"ok": true, ...}. The whole run takes about six minutes of
command time on an H100, the build included.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

H_IMG, W_IMG = 3117, 4156   # the mountain pair's size (bench.py)
DX, DY = 1400, 37           # planted right -> left translation
# The strip: each image's planted (x, y) offset in one scene.
STRIP = ((0, 0), (1400, 37), (2800, 15), (4200, 52))
AUTO_ORDER = (2, 0, 3, 1)   # the auto phase's shuffled input
DEVICE = "cuda"             # where every phase runs

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
    "K6": ("compose_chain_canvas", "pano_tpu_torch/csrc/compose.cu",
           "pano_tpu/ops/pallas_compose.py:249"),
    # No pallas_call: the refine's jnp.linalg.eigh, which XLA runs on the
    # TPU as Jacobi sweeps.
    "K7": ("smallest_eigvec9", "pano_tpu_torch/csrc/eigh9.cu",
           "pano_tpu/ops/ransac.py:245"),
}
# The batched entries of K1 and K4b (the TPU kernels' batched grids, under
# their custom_vmap rules), phase 13.
BATCHED = {
    "K1b": ("harris_scores_batched", "pano_tpu_torch/csrc/harris.cu",
            "pano_tpu/ops/pallas_harris.py:406"),
    "K4bb": ("warp_packed_batched", "pano_tpu_torch/csrc/warp.cu",
             "pano_tpu/ops/pallas_warp.py:870"),
}
# Multiband's pyramid, which replaces no TPU kernel (the JAX package leaves
# it to XLA).
PYRAMID = {
    "K8": ("pyramid_reduce", "pano_tpu_torch/csrc/pyramid.cu",
           "none (pano_tpu/ops/blend.py, XLA)"),
    "K9": ("pyramid_collapse", "pano_tpu_torch/csrc/pyramid.cu",
           "none (pano_tpu/ops/blend.py, XLA)"),
}
PYRAMID_WINDOW = (1504, 2016)  # a chain window of the oilseed images

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of its bytes over the memory rate and its operations
# over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12        # f32 outside the tensor cores
INT8_TC_OPS_PER_S = 1979e12   # int8 tensor cores (K3's u8 product)
FP64_OPS_PER_S = 34e12        # f64 outside the tensor cores (K7)

# Operations per output pixel, counted from each kernel's arithmetic.
# K1: gray 5, two Sobels 22, products 3, two 5-tap Gaussian passes over
#     three planes 54, R 7, NMS 9 compares.
K1_OPS_PER_PX = 100
# K3's f32 epilogue per (query, train) pair, from csrc/match.cu: the SSD
#     (convert, scale, two adds) 4, the row's best, index and second 5,
#     the column's masked minimum and its row 4.
K3_EPILOGUE_OPS = 13
# K4a/K4b: inverse map 14, floor and fractions 4, tap weights 8, three
#     channels of four taps 24, round and clip 9; the weight 4 more, and
#     with the ramp alpha 12 a tap for the ramp and its sum.
WARP_OPS_PER_PX = 59
ALPHA_OPS_PER_PX = 52
# K5 feather: the left ramp 8, the total 2, per channel 2 products, a sum,
#     a division, two selects, round and clip (8).
FEATHER_OPS_PER_PX = 34
# K6 feather: K5's without the left ramp (the weight is read), plus the
#     max of the two weights.
CHAIN_OPS_PER_PX = 27
# K7, f64, per rotation that its data needs (the 36 pairs of 0..8 a
#     sweep; the pad's 9 are skipped): its parameters 15, the columns of
#     A and V (18 rows of 6) 108, the rows of A (9 of 6) 54, the diagonal 2.
K7_OPS_PER_ROTATION = 179
# K8 per output pixel and plane: 25 taps of a product and a sum. K9 per
#     fine pixel: at most 9 hit taps of 9 planes (product and sum), the
#     normaliser 3, 9 divisions, the mask's clamp 3, three bands of 7.
K8_OPS_PER_PX = 50
K9_OPS_PER_PX = 9 * 18 + 3 + 9 + 3 + 21

# Device times of other variants of a kernel's timed call, logged beside
# its device_ms: K4b without the ramp alpha and without the weight, K5 and
# K6 with overlay, K1 at its other NMS windows; for a batched entry, its
# elements as single launches, one after another.
K1_WINDOWS = (5, 7, 9, 11, 15)  # K1's other NMS windows checked and timed
EXTRA_DEVICE_MS = ("device_ms_no_alpha", "device_ms_no_weight",
                   "device_ms_overlay",
                   *(f"device_ms_nms{n}" for n in K1_WINDOWS),
                   "singles_device_ms")

STAGE_LINE = re.compile(r"^(.+): (\d+\.\d{3}) ms$")
STAGES = ("Harris Corner Detection", "Harris Corner Matching",
          "RANSAC Homography Estimation", "Image Stitching")
TOTAL = "Total Stitching Process"


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


def strip_shape():
    return (H_IMG + max(y for _, y in STRIP), W_IMG + max(x for x, _ in STRIP))


def synthetic_strip(seed: int):
    """(scene, images): four crops of one scene at the STRIP offsets."""
    scene = texture(*strip_shape(), seed)
    return scene, [np.ascontiguousarray(scene[y:y + H_IMG, x:x + W_IMG])
                   for x, y in STRIP]


def translation(x: float, y: float) -> np.ndarray:
    return np.array([[1.0, 0.0, x], [0.0, 1.0, y], [0.0, 0.0, 1.0]])


class Timer:
    """Median device time of `reps` runs with CUDA events, the 50 MB L2
    overwritten before each run."""

    SPIN_CYCLES = 1_000_000  # ~0.5 ms of the card's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)

    def warm(self) -> None:
        """~0.2 s of memsets, so that the card leaves its idle clocks."""
        for _ in range(2000):
            self.flush.zero_()
        self.torch.cuda.synchronize()

    def __call__(self, fn, reps: int = 10, warmup: int = 2,
                 setup=None, spin: bool = False) -> float:
        """`setup`, when given, runs before each run, outside the timed
        region (a kernel that updates its input in place re-primes it).
        `spin` puts a ~0.5 ms spin before each run, so that the card is
        still busy while the host enqueues the call: the time is then the
        device's alone, without the wrapper's host time in the window."""
        torch = self.torch
        for _ in range(warmup):
            if setup is not None:
                setup()
            fn()
        times = []
        for _ in range(reps):
            if setup is not None:
                setup()
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S,
          more=()):
    """(bound_ms, bound_by): the larger of the two least times. `more`
    holds (ops, rate) of operations of other types, which run on other
    units: the operations time is the largest of them."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max([nops / ops_per_s] + [n / r for n, r in more]) * 1e3
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
    check(pano.device.type == DEVICE and pano.dtype == torch.uint8,
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
    stitch_pair_fast makes; match_keypoints as its two parts, describe
    (both images' descriptors, K2 x2) and match (K3 and the epilogue)."""
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
        p = cfg.harris.patch_size
        (dq, bq), (dt, bt) = timed("describe", lambda: (
            match.extract_patch_descriptors(right, kps_r, p),
            match.extract_patch_descriptors(left, kps_l, p)))
        m = timed("match", lambda: match.match_descriptors(
            dq, bq, dt, bt, cfg.harris.max_ssd_thresh,
            ratio_thresh=cfg.harris.ratio_thresh,
            cross_check=cfg.harris.cross_check))
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


@contextlib.contextmanager
def recorded_globals(pipeline):
    """Record the (globals, anchor) that each composite_global call of the
    multi-image modes receives."""
    seen = []
    real = pipeline.composite_global

    def spy(images, devs, globals_h, config, anchor=0, _weights_out=None):
        seen.append(([None if g is None else np.array(g, np.float64)
                      for g in globals_h], anchor))
        return real(images, devs, globals_h, config, anchor, _weights_out)

    pipeline.composite_global = spy
    try:
        yield seen
    finally:
        pipeline.composite_global = real


def run_mode(torch, mods, want_launches, tag, fn):
    """One multi-image call with every launch count zeroed just before it
    and read just after, its stdout captured; checks the counts and the
    result's type. Returns (panorama, stdout lines, launches, wall ms)."""
    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        pano = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}
    check(launches == want_launches, f"{tag}: kernel launches {launches}")
    check(isinstance(pano, np.ndarray) and pano.dtype == np.uint8
          and pano.ndim == 3, f"{tag}: result {type(pano)}")
    return pano, buf.getvalue().splitlines(), launches, wall


def check_lines(lines, want, tag):
    """The printed lines: `want` with each stage line's time as x.xxx."""
    got = [STAGE_LINE.sub(r"\1: x.xxx ms", line) for line in lines]
    check(got == want, f"{tag}: printed lines {lines}")


def globals_err(globals_h, offsets, anchor) -> float:
    """Max distance (px) of each recovered global from the planted one
    (the translation from its image's offset to the anchor's) at its
    image's corners."""
    corners = np.array([[0, 0], [W_IMG, 0], [W_IMG, H_IMG], [0, H_IMG]],
                       np.float64)
    ax, ay = offsets[anchor]
    err = 0.0
    for i, (g, (x, y)) in enumerate(zip(globals_h, offsets)):
        check(g is not None, f"image {i} was left out")
        ch = np.c_[corners, np.ones(4)] @ g.T
        err = max(err, float(np.abs(ch[:, :2] / ch[:, 2:3]
                                    - (corners + [x - ax, y - ay])).max()))
    return err


def scene_diff(pano, imgs, offsets, anchor, anchor_at):
    """Per-pixel max |d| of the panorama against the images pasted at
    their planted offsets (the scene itself), over the pixels they cover:
    the anchor first at `anchor_at` = (ty, tx), its placement,
    then the others over it where they are not black (overlay lets the
    canvas show through a (0, 0, 0) pixel, as the reference's does; the
    other blends place the anchor exactly here, so it is the same scene
    pixel beneath). Within the common extent of the two, and without the
    2-px band across each warped image's edge: an estimate a few
    thousandths of a pixel short of the planted offset samples the edge
    pixel's sliver just outside it, and overlay writes that dark fringe
    over the canvas (as the reference's does). Returns (|d| over the
    compared pixels, the band's pixel count)."""
    sh, sw = strip_shape()
    h, w = min(pano.shape[0], sh), min(pano.shape[1], sw)
    want = np.zeros((h, w, 3), np.int16)
    covered = np.zeros((h, w), bool)
    band = np.zeros((h, w), bool)
    for i in [anchor] + [i for i in range(len(imgs)) if i != anchor]:
        y0, x0 = anchor_at if i == anchor else offsets[i][::-1]
        y1, x1 = min(y0 + H_IMG, h), min(x0 + W_IMG, w)
        src = imgs[i][:y1 - y0, :x1 - x0]
        if i == anchor:
            want[y0:y1, x0:x1] = src
        else:
            nonblack = src.any(-1)
            want[y0:y1, x0:x1][nonblack] = src[nonblack]
        covered[y0:y1, x0:x1] = True
        if i != anchor:
            ya, xa = max(y0 - 1, 0), max(x0 - 1, 0)
            for r in (y0, y0 + H_IMG):
                band[max(r - 1, 0):r + 1, xa:x1 + 1] = True
            for c in (x0, x0 + W_IMG):
                band[ya:y1 + 1, max(c - 1, 0):c + 1] = True
    d = np.abs(pano[:h, :w].astype(np.int16) - want).max(-1)
    return d[covered & ~band], int((covered & band).sum())


def chain_breakdown(torch, pipeline, cfg, strip_np, strip, reps=3) -> dict:
    """Median ms, over `reps` warm runs, of the chain's parts, serialized
    (synchronize around each) through the calls stitch_all_images_chain
    makes: the adjacent estimates with their one host copy and the global
    composite on those globals (its panorama's fetch_image included);
    then the whole chain call with each result dropped before the next
    call, and with the previous result held across it."""
    stitcher = pipeline.get_pair_stitcher(cfg, True, "", DEVICE, None)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        rows = timed("estimates", lambda: pipeline._host_fetch(torch.stack(
            [stitcher._fused_estimate_impl(strip[i - 1], strip[i])[0]
             for i in range(1, len(strip))])))
        gs = [np.eye(3)]
        for row in rows:
            gs.append(gs[-1] @ row[:9].reshape(3, 3).astype(np.float64))
        timed("composite", lambda: pipeline.composite_global(
            strip_np, strip, gs, cfg))

    def chain():
        with contextlib.redirect_stdout(io.StringIO()):
            return pipeline.stitch_all_images(strip, cfg, True, "", DEVICE,
                                              "chain")

    for _ in range(reps):
        timed("chain_call_dropped", chain)
    held = None
    for _ in range(reps):
        held = timed("chain_call_held", chain)
    del held
    out = {k: round(float(np.median(v)), 3) for k, v in times.items()}
    out.update({k + "_all": [round(x, 3) for x in v]
                for k, v in times.items() if k.startswith("chain_call")})
    return out


# The panorama's device -> host copy in turns: the parent's pageable
# route, fetch_image, and the staging design PERF.md weighs against it.
FETCH_TURNS = ("pageable", "fetch_image", "fetch_image", "pageable",
               "staged", "staged")
# What a caller does with each result: drops it before the next call
# (the CLI, serve), holds the previous one across the next call, or keeps
# every one (each then needs a page-locked block of its own).
FETCH_REGIMES = ("dropped", "held", "kept")


def staged_fetch(torch, x, buffers: dict) -> np.ndarray:
    """The alternative to fetch_image's fresh block: one page-locked
    staging buffer per (shape, dtype, device), reused, and a copy out of
    it into a fresh numpy array."""
    key = (tuple(x.shape), x.dtype, x.device)
    if key not in buffers:
        buffers[key] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf = buffers[key]
    buf.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))
    done.synchronize()
    return buf.numpy().copy()


def fetch_phase(torch, timer, canvas, smi, reps=5) -> None:
    """The no-alias check of fetch_image at full size, then FETCH_TURNS
    under each of FETCH_REGIMES: `reps` calls a turn, each result equal
    to the pageable copy; per route its median ms per turn, every call's
    ms, GB/s of the median, and the host allocations the regime made."""
    want = canvas.cpu().numpy()
    other = 255 - canvas
    first = timer.fetch_image(canvas)
    kept = first.copy()
    second = timer.fetch_image(other)
    check(torch.from_numpy(first).is_pinned()
          and torch.from_numpy(second).is_pinned(),
          "fetch_image: a panorama did not land in page-locked memory")
    check(np.array_equal(first, want) and np.array_equal(first, kept)
          and np.array_equal(second, other.cpu().numpy())
          and not np.shares_memory(first, second),
          "fetch_image: a held result was overwritten by the next fetch")
    del first, second
    third = timer.fetch_image(canvas)
    check(np.array_equal(third, want), "fetch_image: reused block differs")
    del third, other
    log("panorama fetch no-alias", shape=tuple(canvas.shape),
        mb=round(canvas.nbytes / 1e6, 3), held_unchanged=True,
        reused_block_equal=True)

    buffers = {}
    routes = {"pageable": lambda: canvas.cpu().numpy(),
              "fetch_image": lambda: timer.fetch_image(canvas),
              "staged": lambda: staged_fetch(torch, canvas, buffers)}
    for regime in FETCH_REGIMES:
        # page-locked blocks PyTorch's caching host allocator has pinned
        allocs0 = torch.cuda.host_memory_stats()["num_host_alloc"]
        held = []
        per_route = {}
        for route in FETCH_TURNS:
            ms = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = routes[route]()
                ms.append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(got, want),
                      f"panorama fetch {route}: differs from the canvas")
                if regime != "dropped":
                    held.append(got)
                if regime == "held":
                    del held[:-1]
                del got
            per_route.setdefault(route, []).append(ms)
        allocs = torch.cuda.host_memory_stats()["num_host_alloc"] - allocs0
        numbers = {}
        for route, turns in per_route.items():
            med = [round(float(np.median(t)), 3) for t in turns]
            numbers[f"{route}_ms"] = med
            numbers[f"{route}_gb_s"] = [round(canvas.nbytes / m / 1e6, 3)
                                        for m in med]
            numbers[f"{route}_ms_all"] = [[round(x, 3) for x in t]
                                          for t in turns]
        del held
        log(f"panorama fetch {regime}", turns=FETCH_TURNS, reps=reps,
            **numbers, host_allocs=allocs,
            card=f"'{smi}'")


def run_python(args, stdin=None, env=None):
    """`python ARGS` in a child process, from the checkout's root (it
    loads the library this run built): (completed process, wall ms)."""
    env = dict(os.environ if env is None else env)
    for name in ("PANO_TPU_FORCE_CPU", "PANO_TPU_PROFILE"):
        env.pop(name, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        input=stdin, capture_output=True, text=True, timeout=600)
    return proc, (time.perf_counter() - t0) * 1e3


def run_cli(args, stdin=None, env=None):
    """`python -m pano_tpu_torch.cli ARGS` in a child process."""
    return run_python(["-m", "pano_tpu_torch.cli", *args], stdin, env)


# A child's start-up, split: importing torch and the CLI, making the CUDA
# context (a first tensor on the card), loading the kernel library.
STARTUP = """
import json, time
t0 = time.perf_counter()
import torch, pano_tpu_torch.cli
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
from pano_tpu_torch import _build
_build.lib()
t3 = time.perf_counter()
print(json.dumps({"import_ms": (t1 - t0) * 1e3, "cuda_context_ms":
                  (t2 - t1) * 1e3, "library_load_ms": (t3 - t2) * 1e3}))
"""


def timed(fn):
    """(fn(), its wall ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def check_cli_lines(proc, want, n_dev, tag):
    """Exit code 0 and the printed lines (times as x.xxx): `want` after
    the backend and device-count lines."""
    check(proc.returncode == 0,
          f"{tag}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    check_lines(proc.stdout.splitlines(), [
        "PyTorch backend: cuda", f"Number of Available Devices: {n_dev}",
        *want], tag)


def planted_pair_diff(pano, left, slack, tag) -> int:
    """The planted pair's canvas (each side `slack` = (lo, hi) rows or
    columns off) and the overlap against the left image (host arrays):
    max |d|."""
    plant = (H_IMG + DY, W_IMG + DX)
    check(all(slack[0] <= a - b <= slack[1]
              for a, b in zip(pano.shape[:2], plant)),
          f"{tag}: canvas {pano.shape} vs planted {plant}")
    return int(np.abs(pano[DY:H_IMG, DX:W_IMG].astype(np.int16)
                      - left[DY:H_IMG, DX:W_IMG]).max())


def cli_phase(torch, mods, strip, strip_np, pair_np, chain_ref,
              chain_launches, fold_launches) -> None:
    """Phase 12: the strip and the planted pair as .ppm files (written
    with the port's io), then (a) the chain through the CLI in a child
    process, its panorama equal to phase 9's; (b) fold with feather and
    the staged pair in child processes, against the planted canvas; (c)
    cli.main in process, with the launch counts of phases 9 and 6; (d)
    serve in a child process, four jobs in order, and the staging decoder
    in process; (e) gpu with no visible CUDA device: exit 255, no file."""
    from pano_tpu_torch import _build, cli
    from pano_tpu_torch import io as tio

    left_np = pair_np[0]
    n = len(strip_np)
    n_dev = torch.cuda.device_count()
    total_exec = re.compile(r"^Total Execution Time \(GPU\): (\d+\.\d{3}) ms$",
                            re.M)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        t0 = time.perf_counter()
        strip_paths = [os.path.join(d, f"strip{i}.ppm") for i in range(n)]
        pair_paths = [os.path.join(d, "left.ppm"), os.path.join(d, "right.ppm")]
        for path, img in zip(strip_paths + pair_paths, strip_np + [*pair_np]):
            check(tio.imwrite_bgr(path, img), f"cli: writing {path}")
        log("cli data", codec=tio.codec(), files=len(strip_paths) + 2,
            mb_each=round(os.path.getsize(strip_paths[0]) / 1e6, 3),
            write_seconds=round(time.perf_counter() - t0, 3))
        out = lambda name: os.path.join(d, name)  # noqa: E731
        # What the files cost at this size, through the codec in use and
        # through the numpy PNM codec, which must read back every file.
        for path, img in zip(strip_paths + pair_paths, strip_np + [*pair_np]):
            check(np.array_equal(tio.read_pnm(path), img),
                  f"cli: the numpy codec misreads {path}")
        got, decode_ms = timed(lambda: tio.imread_bgr(strip_paths[0]))
        check(np.array_equal(got, strip_np[0]), "cli: imread_bgr")
        _, pnm_decode_ms = timed(lambda: tio.read_pnm(strip_paths[0]))
        _, encode_ms = timed(lambda: tio.imwrite_bgr(out("enc.ppm"),
                                                     chain_ref))
        _, pnm_encode_ms = timed(lambda: tio.write_ppm(out("enc_np.ppm"),
                                                       chain_ref))
        check(np.array_equal(tio.read_pnm(out("enc.ppm")), chain_ref)
              and np.array_equal(tio.imread_bgr(out("enc_np.ppm")),
                                 chain_ref), "cli: the panorama's encodes")
        log("cli codec", codec=tio.codec(), image_decode_ms=round(decode_ms, 3),
            numpy_pnm_decode_ms=round(pnm_decode_ms, 3),
            panorama_encode_ms=round(encode_ms, 3),
            numpy_pnm_encode_ms=round(pnm_encode_ms, 3),
            panorama_mb=round(chain_ref.nbytes / 1e6, 3))
        # A child's start-up, before it reads an argument.
        proc, startup_wall = run_python(["-c", STARTUP])
        check(proc.returncode == 0, f"cli startup: {proc.stderr}")
        log("cli startup", process_wall_ms=round(startup_wall, 3),
            **{k: round(v, 3) for k, v in json.loads(
                proc.stdout.strip().splitlines()[-1]).items()})

        # (a) the chain, as a user runs it
        proc, chain_wall = run_cli(["gpu", "--mode", "chain", "--json",
                                    out("chain.json"), "--out",
                                    out("chain.ppm"), *strip_paths])
        steps = [f"Stitching image {i + 1} of {n}..." for i in range(1, n)]
        check_cli_lines(proc, [
            *steps, f"{TOTAL} (GPU): x.xxx ms",
            f"Stitched result saved to {out('chain.ppm')}", "",
            "Total Execution Time (GPU): x.xxx ms"], n_dev, "cli chain")
        got = tio.imread_bgr(out("chain.ppm"))
        check(got is not None and np.array_equal(got, chain_ref),
              "cli chain: the panorama differs from phase 9's")
        stats = json.load(open(out("chain.json")))
        labels = [m.group(1) for m in map(STAGE_LINE.match,
                                          proc.stdout.splitlines()) if m]
        check(stats["backend"] == "cuda" and stats["ok"] is True
              and stats["impl"] == "gpu" and stats["mode"] == "chain"
              and stats["panorama_shape"] == list(chain_ref.shape)
              and [r["stage"] for r in stats["stages"]] == labels,
              f"cli chain: --json {stats}")
        chain_total = float(total_exec.search(proc.stdout).group(1))
        log("cli chain", process_wall_ms=round(chain_wall, 3),
            total_execution_ms=chain_total, canvas=got.shape,
            equal_to_phase9=True, json_stages=labels)

        # (b) fold with feather (K4b + K5), and the staged pair (K1-K4a)
        proc, wall_f = run_cli(["gpu", "--mode", "fold", "--blend",
                                "feather", "--out", out("fold.ppm"),
                                *pair_paths])
        check_cli_lines(proc, [
            "Stitching image 2 of 2...", f"{STAGES[-1]} (GPU): x.xxx ms",
            f"{TOTAL} (GPU): x.xxx ms",
            f"Stitched result saved to {out('fold.ppm')}", "",
            "Total Execution Time (GPU): x.xxx ms"], n_dev, "cli fold feather")
        d_fold = planted_pair_diff(tio.imread_bgr(out("fold.ppm")), left_np,
                                   (0, 1), "cli fold feather")
        check(d_fold <= 1, f"cli fold feather: overlap max |d| {d_fold}")
        proc, wall_s = run_cli(["gpu", "--timing", "stages", "--out",
                                out("staged.ppm"), *pair_paths])
        check_cli_lines(proc, [
            "Stitching image 2 of 2...",
            *(f"{s} (GPU): x.xxx ms" for s in (STAGES[0], *STAGES)),
            f"{TOTAL} (GPU): x.xxx ms",
            f"Stitched result saved to {out('staged.ppm')}", "",
            "Total Execution Time (GPU): x.xxx ms"], n_dev, "cli staged")
        d_staged = planted_pair_diff(tio.imread_bgr(out("staged.ppm")),
                                     left_np, (-1, 1), "cli staged")
        check(d_staged <= 1, f"cli staged: overlap max |d| {d_staged}")
        log("cli fold", feather_overlap_max_abs_diff=d_fold,
            feather_process_wall_ms=round(wall_f, 3),
            staged_overlap_max_abs_diff=d_staged,
            staged_process_wall_ms=round(wall_s, 3))

        # (c) the launches of cli.main, in process
        counts = {}
        for tag, args, want in (
                ("chain", ["--mode", "chain", *strip_paths], chain_launches),
                ("fold feather", ["--mode", "fold", "--blend", "feather",
                                  *pair_paths], fold_launches)):
            for mod, attr in mods.values():
                setattr(mod, attr, 0)
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["gpu", *args, "--out", out("main.ppm")])
            torch.cuda.synchronize()
            counts[tag] = {k: getattr(mod, attr)
                           for k, (mod, attr) in mods.items()}
            check(rc == 0 and counts[tag] == want,
                  f"cli.main {tag}: exit {rc}, launches {counts[tag]} "
                  f"(want {want})")
        log("cli launches", chain=counts["chain"],
            fold_feather=counts["fold feather"])

        # (d) serve: the strip twice (the second from the staging cache),
        # with feather between, then a job of one image, which fails
        strip_args = " ".join(strip_paths)
        jobs = (f"{strip_args} --out {out('o1.ppm')}\n"
                f"{strip_args} --blend feather --out {out('o2.ppm')}\n"
                f"{strip_args} --out {out('o3.ppm')}\n"
                f"{strip_paths[0]} --out {out('o4.ppm')}\n"
                "quit\n")
        proc, serve_wall = run_cli(["serve", "gpu", "--mode", "chain"],
                                   stdin=jobs)
        check(proc.returncode == 0, f"serve: exit {proc.returncode}\n"
              f"{proc.stdout}\n{proc.stderr}")
        status = re.compile(r"^Job (\d+) (ok|failed) (\S+): (\d+\.\d{3}) ms$")
        jobs_seen = [m.groups() for m in map(status.match,
                                             proc.stdout.splitlines()) if m]
        check([(j, st) for j, st, _, _ in jobs_seen]
              == [("1", "ok"), ("2", "ok"), ("3", "ok"), ("4", "failed")],
              f"serve: status lines {jobs_seen}\n{proc.stdout}")
        check("staging" not in proc.stderr,
              f"serve: a staging failure was reported: {proc.stderr}")
        o1, o3 = (open(out(f), "rb").read() for f in ("o1.ppm", "o3.ppm"))
        check(o1 == o3 == open(out("chain.ppm"), "rb").read(),
              "serve: jobs 1 and 3 differ from each other or from (a)")
        check(tio.imread_bgr(out("o2.ppm")) is not None
              and not os.path.exists(out("o4.ppm")), "serve: job outputs")
        job_ms = [float(ms) for _, _, _, ms in jobs_seen]
        staged = cli.make_staging_decoder(torch.device("cuda"), 8)(
            strip_paths)
        for path, dev in zip(strip_paths, strip):
            t = staged[path]
            check(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                  and t.dtype == torch.uint8 and torch.equal(t, dev),
                  f"serve staging: {path} is not the file on the card")
        del staged
        log("cli serve", job_ms=job_ms, process_wall_ms=round(serve_wall, 3))

        # (e) no visible CUDA device: an error, never a CPU run
        proc, _ = run_cli(["gpu", "--out", out("none.ppm"), *pair_paths],
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        check(proc.returncode == 255 and "CUDA device" in proc.stderr
              and not os.path.exists(out("none.ppm")),
              f"cli without a card: exit {proc.returncode}, "
              f"stderr {proc.stderr!r}")
        log("cli no card", exit=proc.returncode,
            stderr=proc.stderr.strip().splitlines()[-1])

    # (f) the numbers of this phase on one line
    log("cli numbers", chain_process_wall_ms=round(chain_wall, 3),
        chain_total_execution_ms=chain_total, serve_job_ms=job_ms,
        codec=tio.codec())


def shard_phase(torch, mods, none, timer, res, smi, strip, strip_np, pair,
                chain_ref, auto_ref) -> dict:
    """Phase 13: the batched K1 and K4b against their plain versions and
    single launches, the sharded modes on a mesh of the card and on the
    card repeated, the batched pairs, and the sharded CLI. Fills res
    with the batched entries' numbers; returns the launches of the
    sharded chain on the card."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher, pipeline
    from pano_tpu_torch import io as tio
    from pano_tpu_torch import _build
    from pano_tpu_torch.ops import cuda_harris, cuda_warp
    from pano_tpu_torch.parallel import shard

    hopts = DEFAULT_CONFIG.harris
    n = len(strip)
    card = torch.device(DEVICE)

    # (a) batched K1 over the strip's four images
    stack = torch.stack(strip)
    args = (hopts.k, hopts.nms_thresh)
    got = cuda_harris.harris_scores_batched(stack, *args)
    want = cuda_harris.harris_scores_batched_plain(stack, *args)
    check(torch.equal(got, want), "K1 batched differs from the plain version")
    for i in range(n):
        check(torch.equal(got[i], cuda_harris.harris_scores(strip[i], *args)),
              f"K1 batched: image {i} differs from its single launch")

    def k1_batched():
        return cuda_harris.harris_scores_batched(stack, *args)

    def k1_singles():
        return [cuda_harris.harris_scores(im, *args) for im in strip]

    res["K1b"] = dict(
        max_abs_err=max(check_harris(got[i], want[i]) for i in range(n)),
        ms=timer(k1_batched),
        plain_ms=timer(lambda: cuda_harris.harris_scores_batched_plain(
            stack, *args), reps=3),
        library_ms=None,
        bound=bound(nbytes(stack, got), n * H_IMG * W_IMG * K1_OPS_PER_PX),
    )
    log("K1b harris_scores_batched", shape=tuple(got.shape),
        equal_to_plain=True, equal_to_single_launches=True, **res["K1b"])
    del got, want

    # (b) batched K4b over the chain's three windows, with the ramp alpha
    planted = [translation(x, y) for x, y in STRIP]
    t_mat, ch, cw = pipeline.global_canvas_geometry(strip_np, planted, 0)
    plan = pipeline.global_warp_plan(strip, planted, 0, t_mat, ch, cw)
    check([lvl for *_, lvl in plan] == [0] * (n - 1),
          f"K4b batched: mip levels {[lvl for *_, lvl in plan]}")
    srcs = [strip[i] for i, *_ in plan]
    maps = [m for _, m, _, _ in plan]
    wins = [w for _, _, w, _ in plan]
    got = cuda_warp.warp_packed_batched(srcs, maps, wins)
    want = cuda_warp.warp_packed_batched_plain(srcs, maps, wins)
    err = 0.0
    for (rgb, w), (rgb_p, w_p), src, m, win in zip(got, want, srcs, maps,
                                                  wins):
        one = cuda_warp.warp_packed(src, m, win)
        check(torch.equal(rgb, rgb_p) and torch.equal(w, w_p),
              f"K4b batched: window {win} differs from the plain version")
        check(torch.equal(rgb, one[0]) and torch.equal(w, one[1]),
              f"K4b batched: window {win} differs from its single launch")
        err = max(err, check_warp(rgb, rgb_p, win, "K4b batched"),
                  float((w - w_p).abs().max()))
    win_px = sum((w[2] - w[0]) * (w[3] - w[1]) for w in wins)

    def k4b_batched():
        return cuda_warp.warp_packed_batched(srcs, maps, wins)

    def k4b_singles():
        return [cuda_warp.warp_packed(src, m, win)
                for src, m, win in zip(srcs, maps, wins)]

    res["K4bb"] = dict(
        max_abs_err=err, ms=timer(k4b_batched),
        plain_ms=timer(lambda: cuda_warp.warp_packed_batched_plain(
            srcs, maps, wins), reps=3),
        library_ms=None,
        bound=bound(nbytes(*srcs, *(t for pr in got for t in pr)),
                    win_px * (WARP_OPS_PER_PX + ALPHA_OPS_PER_PX)),
    )
    log("K4bb warp_packed_batched", windows=wins, equal_to_plain=True,
        equal_to_single_launches=True, **res["K4bb"])
    del got, want

    # The device times, the card warmed first (as phase 4 takes them).
    timer.warm()
    for k, batched, singles in (("K1b", k1_batched, k1_singles),
                                ("K4bb", k4b_batched, k4b_singles)):
        res[k]["device_ms"] = timer(batched, spin=True)
        res[k]["singles_device_ms"] = timer(singles, spin=True)
    log("batched device time",
        **{f"{k}_{f}": res[k][f] for k in ("K1b", "K4bb")
           for f in ("device_ms", "singles_device_ms")})
    del stack

    # (c) the sharded modes on a mesh of the card
    steps = [f"Stitching image {i + 1} of {n}..." for i in range(1, n)]
    total = f"{TOTAL} (Sharded): x.xxx ms"
    mesh1 = shard.make_mesh()
    check(mesh1.shape == {"data": torch.cuda.device_count(), "hyp": 1},
          f"make_mesh(): {mesh1}")

    def sharded(mode, mesh, imgs=strip):
        return shard.stitch_all_images_sharded(imgs, DEFAULT_CONFIG,
                                               "Sharded", mesh, mode)

    n_pairs = n * (n - 1) // 2
    chain_want = {**none, "K1b": 1, "K2": 2 * (n - 1), "K3": n - 1,
                  "K7": n - 1, "K4bb": 1, "K6": n - 1}
    torch.cuda.reset_peak_memory_stats()
    out, lines, launches_c, first = run_mode(
        torch, mods, chain_want, "sharded chain",
        lambda: sharded("chain", mesh1))
    peak = torch.cuda.max_memory_allocated() / 2**20
    check_lines(lines, [*steps, total], "sharded chain")
    check(np.array_equal(out, chain_ref),
          "sharded chain: the panorama differs from phase 9's")

    def one_device_chain():
        return pipeline.stitch_all_images(strip, DEFAULT_CONFIG, True, "",
                                          DEVICE, "chain")

    walls = {"one_device": [], "sharded": []}
    for tag in ("one_device", "sharded", "sharded", "one_device"):
        fn = one_device_chain if tag == "one_device" else (
            lambda: sharded("chain", mesh1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            again = fn()
        walls[tag].append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(again, chain_ref), f"chain {tag} differs")
    log("sharded chain", mesh=mesh1.shape, equal_to_phase9=True,
        launches=launches_c, first_call_ms=round(first, 3),
        call_ms_in_turns={k: [round(x, 3) for x in v]
                          for k, v in walls.items()},
        peak_mem_mib=round(peak, 1), card=f"'{smi}'")

    imgs_auto = [strip[i] for i in AUTO_ORDER]
    torch.cuda.reset_peak_memory_stats()
    out, lines, launches_a, wall = run_mode(
        torch, mods, {**none, "K1b": 1, "K2": n, "K3": n_pairs,
                      "K7": n_pairs, "K4bb": 1, "K6": n - 1},
        "sharded auto", lambda: sharded("auto", mesh1, imgs_auto))
    peak = torch.cuda.max_memory_allocated() / 2**20
    order = [x for x in lines if x.startswith("Auto-ordering")]
    check(len(order) == 1 and order[0].endswith(f"placed {n} of {n}")
          and STAGE_LINE.sub(r"\1: x.xxx ms", lines[-1]) == total,
          f"sharded auto: printed lines {lines}")
    check(np.array_equal(out, auto_ref),
          "sharded auto: the panorama differs from phase 10's")
    log("sharded auto", order=AUTO_ORDER, equal_to_phase10=True,
        launches=launches_a, call_ms=round(wall, 3),
        peak_mem_mib=round(peak, 1))

    fold_stages = [f"{s} (Sharded): x.xxx ms" for s in (STAGES[0], *STAGES)]
    torch.cuda.reset_peak_memory_stats()
    out, lines, launches_f, wall = run_mode(
        torch, mods, {**none, "K1": 2 * (n - 1), "K2": 2 * (n - 1),
                      "K3": n - 1, "K7": n - 1, "K4a": n - 1},
        "sharded fold", lambda: sharded("fold", mesh1))
    peak = torch.cuda.max_memory_allocated() / 2**20
    check_lines(lines, [x for step in steps for x in (step, *fold_stages)]
                + [total], "sharded fold")
    plant = strip_shape()
    check(all(0 <= a - b <= 2 * (n - 1)
              for a, b in zip(out.shape[:2], plant)),
          f"sharded fold: canvas {out.shape} vs planted {plant}")
    log("sharded fold", mesh=mesh1.shape, canvas=out.shape,
        launches=launches_f, call_ms=round(wall, 3),
        peak_mem_mib=round(peak, 1))
    del out

    # (d) the card repeated: chain on data 3, the fold on hyp 4
    mesh3 = shard.make_mesh(3, 1, devices=[card] * 3)
    out, lines, launches_3, wall = run_mode(
        torch, mods, {**chain_want, "K1b": 3, "K4bb": 3},
        "sharded chain data 3", lambda: sharded("chain", mesh3))
    check(np.array_equal(out, chain_ref),
          "sharded chain on data 3: the panorama differs from phase 9's")
    log("sharded chain data 3", equal_to_phase9=True, launches=launches_3,
        call_ms=round(wall, 3))
    mesh_h = shard.make_mesh(1, 4, devices=[card] * 4)
    hs = []
    real_composite = pipeline.PairStitcher.composite

    def spy(self, left, right, h):
        hs.append(np.array(h, np.float64))
        return real_composite(self, left, right, h)

    pipeline.PairStitcher.composite = spy
    try:
        out, lines, launches_h, wall = run_mode(
            torch, mods, {**none, "K1": 2 * (n - 1), "K2": 2 * (n - 1),
                          "K3": n - 1, "K7": n - 1, "K4a": n - 1},
            "sharded fold hyp 4", lambda: sharded("fold", mesh_h))
    finally:
        pipeline.PairStitcher.composite = real_composite
    check_lines(lines, [x for step in steps for x in (step, *fold_stages)]
                + [total], "sharded fold hyp 4")
    corners = np.array([[0, 0], [W_IMG, 0], [W_IMG, H_IMG], [0, H_IMG]],
                       np.float64)
    h_err = []
    for h, (x, y) in zip(hs, STRIP[1:]):
        c = np.c_[corners, np.ones(4)] @ h.T
        h_err.append(float(np.abs(c[:, :2] / c[:, 2:3]
                                  - (corners + [x, y])).max()))
    check(len(hs) == n - 1 and max(h_err) < 0.5,
          f"sharded fold hyp 4: H corner errors {h_err}")
    log("sharded fold hyp 4", corner_err_px=[round(e, 5) for e in h_err],
        canvas=out.shape, launches=launches_h, call_ms=round(wall, 3))
    del out

    # (e) throughput mode: four same-shape pairs
    left, right = pair
    lefts = torch.stack([strip[0], strip[1], strip[2], left])
    rights = torch.stack([strip[1], strip[2], strip[3], right])
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device=DEVICE)
    rows, _ = shard.fused_estimate_batched(lefts, rights, DEFAULT_CONFIG)
    singles = [st._fused_estimate_impl(lefts[k], rights[k])[0]
               for k in range(4)]
    for k in range(4):
        check(torch.equal(rows[k], singles[k]),
              f"batched pairs: pair {k}'s estimate row differs from "
              f"PairStitcher._fused_estimate_impl's")
    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    panos = shard.stitch_pairs_batched(lefts, rights, DEFAULT_CONFIG)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches_p = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}
    groups = launches_p["K4bb"]
    check(launches_p == {**none, "K1b": 1, "K2": 8, "K3": 4, "K7": 4,
                         "K4bb": groups, "K5": 4} and 1 <= groups <= 4,
          f"batched pairs: kernel launches {launches_p}")
    hs = [r[:9].cpu().numpy().astype(np.float64).reshape(3, 3)
          for r in singles]
    for k in range(4):
        want = st.composite(lefts[k], rights[k], hs[k])
        check(panos[k] is not None
              and torch.equal(torch.from_numpy(panos[k]), want.cpu()),
              f"batched pairs: canvas {k} differs from PairStitcher."
              f"composite")

    def one_by_one():
        outs = []
        for k in range(4):
            row = pipeline._host_fetch(
                st._fused_estimate_impl(lefts[k], rights[k])[0])
            outs.append(pipeline._host_fetch(st.composite(
                lefts[k], rights[k],
                row[:9].astype(np.float64).reshape(3, 3))))
        return outs

    walls = {"one_by_one": [], "batched": []}
    for tag in ("one_by_one", "batched", "batched", "one_by_one"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = (one_by_one() if tag == "one_by_one" else
                shard.stitch_pairs_batched(lefts, rights, DEFAULT_CONFIG))
        walls[tag].append((time.perf_counter() - t0) * 1e3)
        check(all(np.array_equal(a, b) for a, b in zip(outs, panos)),
              f"batched pairs: {tag} differs")
    log("batched pairs", canvases=[p.shape for p in panos],
        launches=launches_p, first_call_ms=round(first, 3),
        call_ms_in_turns={k: [round(x, 3) for x in v]
                          for k, v in walls.items()},
        peak_mem_mib=round(peak, 1), card=f"'{smi}'")
    del lefts, rights, panos, outs

    # (f) the sharded CLI in a child process
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        paths = [os.path.join(d, f"strip{i}.ppm") for i in range(n)]
        for path, img in zip(paths, strip_np):
            check(tio.imwrite_bgr(path, img), f"sharded cli: writing {path}")
        out_file = os.path.join(d, "chain.ppm")
        proc, wall = run_cli(["sharded", "--mode", "chain", "--out",
                              out_file, *paths])
        check_cli_lines(proc, [
            *steps, total, f"Stitched result saved to {out_file}", "",
            "Total Execution Time (Sharded): x.xxx ms"],
            torch.cuda.device_count(), "sharded cli")
        check(np.array_equal(tio.imread_bgr(out_file), chain_ref),
              "sharded cli: the panorama differs from phase 9's")
    log("sharded cli", process_wall_ms=round(wall, 3), equal_to_phase9=True,
        total_execution=proc.stdout.strip().splitlines()[-1])
    return launches_c


# bench.py's JSON keys, which bench_torch.py prints on the card.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device_compute_ms"}
# Phase 14's throughput loop: pairs a run, and the depths it runs at.
THROUGHPUT_PAIRS = 30
THROUGHPUT_DEPTHS = (1, 3, 3, 1)   # in turns
# The kernels phase 14 (f) must find in the CLI's profiler trace: the
# overlay pair's K1, K2, K3 (its three launches' kernels) and K4a.
TRACE_KERNELS = {"K1": ("harris_scores_kernel",),
                 "K2": ("gather_patches_kernel",),
                 "K3": ("prologue_kernel", "match_kernel", "finish_kernel"),
                 "K4a": ("warp_overlay_canvas_kernel",)}
TABLE_ROW = re.compile(r"^  (.+?)\s+(\d+\.\d{3}) ms  x(\d+)$")


def driver_phase(torch, mods, none, smi, pair, pair_np, pano_ref,
                 pair_launches) -> None:
    """Phase 14: the measuring and driver layer on the planted pair at
    full size. (b) the throughput loop at depth 1 and 3, in turns; (a)
    bench_torch.measure; (c) the resolution sweep through the gpu CLI and the device
    sweep over the card repeated; (d) serial against gpu; (e)
    graft_entry_torch's forward step and dry runs; (f) pano_torch.sh
    perf. The in-process paths run with every launch count zeroed just
    before and read just after; the children's kernels show in (f)'s
    trace."""
    import bench_torch
    import benchmark_throughput_torch as bt
    import graft_entry_torch as ge

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher, _build
    from pano_tpu_torch import io as tio

    left, right = pair

    def zero():
        for mod, attr in mods.values():
            setattr(mod, attr, 0)

    def counts():
        torch.cuda.synchronize()
        return {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}

    def pairs_launches(n):
        return {k: v * n for k, v in pair_launches.items()}

    # (b) the throughput loop: a timed run (launches read around it), then
    # an untimed one at the same depth whose every retired panorama is
    # checked; then the syncs a pair pays, counted
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device=DEVICE)

    checked = set()
    for depth in THROUGHPUT_DEPTHS:
        zero()
        torch.cuda.reset_peak_memory_stats()
        res = bt.throughput(st, left, right, THROUGHPUT_PAIRS, depth)
        peak = torch.cuda.max_memory_allocated() / 2**20
        launches = counts()
        check(launches == pairs_launches(THROUGHPUT_PAIRS + 1),
              f"throughput depth {depth}: kernel launches {launches}")
        check(res["fallback_pairs"] == 0 and res["depth"] == depth,
              f"throughput: {res}")
        retired_checked = depth not in checked
        if retired_checked:
            n = 0
            for pano, row in bt.pipelined(
                    st, [(left, right)] * THROUGHPUT_PAIRS, depth):
                check(pano is not None and row[11] > 0.5
                      and torch.equal(pano, pano_ref),
                      f"throughput: retired panorama {n} differs from "
                      f"phase 5's")
                n += 1
            check(n == THROUGHPUT_PAIRS, f"throughput: {n} retired")
            checked.add(depth)
        print("  " + json.dumps(res), flush=True)
        log(f"throughput depth {depth}", pairs_per_s=res["value"],
            ms_per_pair=res["ms_per_pair"], pairs=THROUGHPUT_PAIRS,
            peak_mem_mib=round(peak, 1),
            retired_checked_equal_to_phase5=retired_checked,
            launches=launches, card=f"'{smi}'")
    syncs = bt.host_syncs_per_pair(st, left, right, 3)
    check(syncs == 0, f"throughput: {syncs} flagged host syncs a pair")
    log("throughput syncs", flagged_syncs_per_pair=syncs)

    # (a) the headline bench: warm-up, 5 timed calls, 3 traced ones (after
    # (b), so that no profiler run precedes the loop's timed runs)
    zero()
    out, pano = bench_torch._measure(left, right, 5, DEVICE)
    launches = counts()
    check(set(out) == BENCH_KEYS, f"bench: keys {sorted(out)}")
    check(launches == pairs_launches(1 + 5 + bench_torch.TRACE_REPS),
          f"bench: kernel launches {launches}")
    check(torch.equal(pano, pano_ref),
          "bench: the panorama differs from phase 5's")
    check(0 < out["device_compute_ms"] < out["value"],
          f"bench: device_compute_ms {out['device_compute_ms']} against "
          f"value {out['value']}")
    del pano
    print("  " + json.dumps(out), flush=True)
    log("bench", value_ms=out["value"],
        device_compute_ms=out["device_compute_ms"],
        busy_share=out["device_compute_ms"] / out["value"],
        launches=launches, card=f"'{smi}'")

    # The throughput loop once more after (a)'s torch.profiler block: does
    # profiling slow the launches that follow it?
    res = bt.throughput(st, left, right, THROUGHPUT_PAIRS, 1)
    log("throughput after the profiler", pairs_per_s=res["value"],
        ms_per_pair=res["ms_per_pair"], depth=1)

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        data = os.path.join(d, "pair")
        os.makedirs(data)
        paths = [os.path.join(data, f"{n}.ppm") for n in ("left", "right")]
        for path, img in zip(paths, pair_np):
            check(tio.imwrite_bgr(path, img), f"driver: writing {path}")

        # (c) the resolution sweep through the gpu CLI, then the device
        # sweep on the card repeated at full size
        res_csv = os.path.join(d, "res.csv")
        proc, wall = run_python([
            "benchmark_panorama_torch.py", "--dataset", data, "--impl", "gpu",
            "--scales", "0.25,0.5,1.0", "--repeats", "1", "--csv", res_csv,
            "--plot", os.path.join(d, "res.png")])
        check(proc.returncode == 0, f"resolution sweep: exit "
              f"{proc.returncode}\n{proc.stdout}\n{proc.stderr[-3000:]}")
        rows = [(float(r["scale"]), float(r["ms"]))
                for r in csv.DictReader(open(res_csv))]
        check([s for s, _ in rows] == [0.25, 0.5, 1.0]
              and all(ms > 0 for _, ms in rows),
              f"resolution sweep: rows {rows}")
        log("resolution sweep", impl="gpu", scale_ms=rows,
            process_wall_ms=round(wall, 3), card=f"'{smi}'")

        dev_csv = os.path.join(d, "dev.csv")
        proc, wall = run_python([
            "benchmark_panorama_torch.py", "--dataset", data, "--devices",
            "1,2,4", "--device-scale", "1.0", "--kpts", "8192", "--csv",
            dev_csv, "--plot", os.path.join(d, "dev.png")])
        check(proc.returncode == 0, f"device sweep: exit "
              f"{proc.returncode}\n{proc.stdout}\n{proc.stderr[-3000:]}")
        rows = list(csv.DictReader(open(dev_csv)))
        # The tests' values: one fetch for the estimates' batch, one for
        # the composite group of the batch's identical pairs.
        check([(r["devices"], r["batch"], r["est_fetches"],
                r["full_fetches"]) for r in rows]
              == [("1", "8", "1", "2"), ("2", "8", "1", "2"),
                  ("4", "8", "1", "2")], f"device sweep: rows {rows}")
        log("device sweep", mesh="the card repeated", kpts=8192,
            rows=[{k: r[k] for k in ("devices", "batch", "est_ms", "full_ms",
                                     "pairs_per_s")} for r in rows],
            fetches="1 / 2 per batch", process_wall_ms=round(wall, 3))

        # (d) serial against gpu on the pair's directory, at full size
        sp_csv = os.path.join(d, "sp.csv")
        proc, wall = run_python([
            "benchmark_serial_parallel_torch.py", "--datasets", data,
            "--repeats", "1", "--csv", sp_csv, "--plot",
            os.path.join(d, "sp.png")])
        check(proc.returncode == 0, f"serial vs gpu: exit "
              f"{proc.returncode}\n{proc.stdout}\n{proc.stderr[-3000:]}")
        row, = csv.DictReader(open(sp_csv))
        check(float(row["serial_s"]) > 0 and float(row["gpu_s"]) > 0,
              f"serial vs gpu: {row}")
        log("serial vs gpu", scale=1.0, serial_s=row["serial_s"],
            gpu_s=row["gpu_s"], speedup=row["speedup"],
            process_wall_ms=round(wall, 3), card=f"'{smi}'")

        # (f) pano_torch.sh perf on the pair: the report's kernels
        # (the report goes to the working directory, the trace to d)
        env = {k: v for k, v in os.environ.items()
               if k not in ("PANO_TPU_FORCE_CPU", "PANO_TPU_PROFILE")}
        env["PANO_TPU_TRACE_DIR"] = os.path.join(d, "gpu_perf_trace")
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["bash", os.path.join(root, "pano_torch.sh"), "perf", "gpu",
             *paths, "--out", os.path.join(d, "perf.ppm")], cwd=d, env=env,
            capture_output=True, text=True, timeout=600)
        wall = (time.perf_counter() - t0) * 1e3
        report = open(os.path.join(d, "gpu_perf_report.txt")).read()
        check(proc.returncode == 0 and "device busy" in report,
              f"pano_torch.sh perf: exit {proc.returncode}\n{proc.stdout}"
              f"\n{proc.stderr[-3000:]}")
        table = {}
        for m in map(TABLE_ROW.match, report.splitlines()):
            if m:
                table[m.group(1)] = table.get(m.group(1), 0.0) + float(
                    m.group(2))
        found = {}
        for k, names in TRACE_KERNELS.items():
            found[k] = {n: round(sum(ms for row, ms in table.items()
                                     if n in row), 3) for n in names}
            check(all(v > 0 for v in found[k].values()),
                  f"pano_torch.sh perf: {k} {found[k]} in the report\n"
                  f"{report}")
        busy = report.strip().splitlines()[-1]
        log("pano_torch.sh perf", kernels_ms=found, report_busy=busy,
            process_wall_ms=round(wall, 3))

    # (e) the driver entry points on the card, against the CPU
    zero()
    fn, args = ge.entry()
    h, count, canvas = fn(*args)
    launches = counts()
    check(launches == {**none, "K1": 2, "K2": 2, "K3": 1, "K7": 1},
          f"entry: kernel launches {launches}")
    fn_c, args_c = ge.entry("cpu")
    h_c, count_c, canvas_c = fn_c(*args_c)
    corners = np.array([[0, 0, 1], [160, 0, 1], [160, 128, 1], [0, 128, 1]],
                       np.float64)
    pa = corners @ h.double().cpu().numpy().T
    pb = corners @ h_c.double().numpy().T
    h_err = float(np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max())
    d_canvas = int((canvas.cpu().int() - canvas_c.int()).abs().max())
    check(int(count) == int(count_c) > 0 and h_err < 0.5 and d_canvas <= 1
          and tuple(canvas.shape) == (128, 256, 3),
          f"entry: inliers {int(count)} / {int(count_c)} (cpu), H off by "
          f"{h_err} px, canvas max |d| {d_canvas}")
    log("graft entry", inliers=int(count), h_err_vs_cpu_px=round(h_err, 6),
        canvas_max_abs_diff_vs_cpu=d_canvas, launches=launches)
    sizes = [1] + ([torch.cuda.device_count()]
                   if torch.cuda.device_count() > 1 else [])
    for n in sizes:
        zero()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hs, cnt = ge.dryrun_multichip(n)
        launches = counts()
        with contextlib.redirect_stdout(io.StringIO()):
            hs_c, cnt_c = ge.dryrun_multichip(n, device="cpu")
        n_data = len(hs)
        err = 0.0
        small = np.array([[0, 0, 1], [96, 0, 1], [96, 64, 1], [0, 64, 1]],
                         np.float64)
        for a, b in zip(hs, hs_c):
            pa, pb = small @ a.T, small @ b.T
            err = max(err, float(np.abs(pa[:, :2] / pa[:, 2:]
                                        - pb[:, :2] / pb[:, 2:]).max()))
        want = {**none, "K1b": n_data, "K2": 2 * n_data, "K3": n_data,
                "K7": n_data, "K4bb": 1, "K5": n_data} if n == 1 else None
        check(np.array_equal(cnt, cnt_c) and err < 0.5
              and (want is None or launches == want),
              f"dryrun_multichip({n}): inliers {cnt} / {cnt_c} (cpu), H off "
              f"by {err} px, launches {launches}")
        print("  " + buf.getvalue().strip(), flush=True)
        log(f"dryrun_multichip {n}", inliers=cnt.tolist(),
            h_err_vs_cpu_px=round(err, 6), launches=launches)


def pyramid_launches(windows: int) -> dict:
    """K8 and K9 launches of `windows` 5-level multiband blends: a REDUCE
    a level below the top, a collapse step a level."""
    return {"K8": 4 * windows, "K9": 5 * windows}


def pyramid_rows(torch, timer, res, device_runs) -> None:
    """Phase 4's K8 (REDUCE) and K9 (the collapse step): every level of a
    chain window's 5-level blend torch.equal to the plain versions and
    the whole blend to ops/blend.py's route on the card; `ms`, the plain
    version's and the bound at level 0 (the 7 planes of the images and
    the mask, as _multiband_compose hands them over)."""
    from pano_tpu_torch.ops import blend, cuda_blend

    h, w = PYRAMID_WINDOW
    r = np.random.default_rng(90)
    a = torch.from_numpy(texture(h, w, 91).astype(np.float32)).to(DEVICE)
    b = torch.from_numpy(texture(h, w, 92).astype(np.float32)).to(DEVICE)
    seam = np.arange(w)[None, :] + r.integers(-40, 41, (h, 1)) > w // 2
    m = torch.from_numpy(seam.astype(np.float32)).to(DEVICE)
    gs = [[*a.unbind(-1), *b.unbind(-1), m]]
    for _ in range(4):
        got = cuda_blend.reduce(gs[-1])
        check(torch.equal(got, cuda_blend.reduce_plain(gs[-1])),
              f"K8 differs from the plain version at level {len(gs) - 1}")
        gs.append(list(got))
    out = None
    for i in reversed(range(5)):
        coarse = None if out is None else gs[i + 1][:6] + list(out)
        got = cuda_blend.collapse_step(gs[i], coarse)
        check(torch.equal(got, cuda_blend.collapse_step_plain(gs[i], coarse)),
              f"K9 differs from the plain version at level {i}")
        out = got
    check(torch.equal(out.permute(1, 2, 0), blend.laplacian_blend(a, b, m, 5)),
          "the pyramid kernels' blend differs from ops/blend.py's route")
    cuda_blend.reduce_launches = cuda_blend.collapse_launches = 0
    cuda_blend.laplacian_blend(a, b, m, 5)
    launches = {"K8": cuda_blend.reduce_launches,
                "K9": cuda_blend.collapse_launches}
    check(launches == pyramid_launches(1), f"pyramid launches {launches}")
    g0, g1 = gs[0], gs[1]
    fine, coarse = g0, g1[:6] + list(torch.rand_like(torch.stack(g1[:3])))
    planes = h * w
    calls = {
        "K8": (functools.partial(cuda_blend.reduce, g0),
               functools.partial(cuda_blend.reduce_plain, g0),
               # 7 planes read, 7 quarter planes written
               bound(planes * 7 * 4 * 1.25, planes // 4 * 7 * K8_OPS_PER_PX)),
        "K9": (functools.partial(cuda_blend.collapse_step, fine, coarse),
               functools.partial(cuda_blend.collapse_step_plain, fine,
                                 coarse),
               # 7 planes read, 9 quarter planes read, 3 planes written
               bound(planes * 4 * (7 + 9 / 4 + 3), planes * K9_OPS_PER_PX)),
    }
    for k, (fn, plain, bnd) in calls.items():
        res[k] = dict(max_abs_err=0.0, ms=timer(fn), plain_ms=timer(plain),
                      library_ms=None, bound=bnd)
        device_runs.append((k, "device_ms", fn, None))
        log(f"{k} {PYRAMID[k][0]}", shape=(h, w), levels=5,
            launches_a_window=launches[k], **res[k])
    log("pyramid blend", shape=(h, w),
        blend_ms=timer(lambda: cuda_blend.laplacian_blend(a, b, m, 5)),
        route_ms=timer(lambda: blend.laplacian_blend(a, b, m, 5), reps=3),
        equal_to_route=True)


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
        cuda_blend, cuda_compose, cuda_eigh, cuda_gather, cuda_harris,
        cuda_match, cuda_warp, harris, match, ransac,
    )
    from pano_tpu_torch.ops import warp as warp_ops
    from pano_tpu_torch.pipeline import fused_canvas_geometry

    # 3. the synthetic pair and strip
    t0 = time.perf_counter()
    left_np, right_np = synthetic_pair(args.seed)
    left = torch.from_numpy(left_np).to(DEVICE)
    right = torch.from_numpy(right_np).to(DEVICE)
    scene, strip_np = synthetic_strip(args.seed)
    strip = [torch.from_numpy(im).to(DEVICE) for im in strip_np]
    torch.cuda.synchronize()
    log("data", pair=left_np.shape, dx=DX, dy=DY, strip_scene=scene.shape,
        strip_offsets=STRIP, seconds=round(time.perf_counter() - t0, 3))

    # 4. each kernel against its plain version, at the main path's shapes
    timer = Timer(torch)
    hopts = DEFAULT_CONFIG.harris
    res = {}
    # (kernel, call, setup) of each kernel's timed call, for the device
    # times taken after all of the `ms` below.
    device_runs = []

    got = cuda_harris.harris_scores(left, hopts.k, hopts.nms_thresh)
    want = cuda_harris.harris_scores_plain(left, hopts.k, hopts.nms_thresh)
    err = check_harris(got, want)
    check(torch.equal(got, want), "K1 differs from the plain version")
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
    device_runs.append(("K1", "device_ms", functools.partial(
        cuda_harris.harris_scores, left, hopts.k, hopts.nms_thresh), None))
    log("K1 harris_scores", shape=tuple(got.shape), **res["K1"])
    # The other NMS windows (the JAX CLI's --nms-size): bit-identical, and
    # harris_detect on the card returns keypoints at each.
    peaks = {}
    for n in K1_WINDOWS:
        got = cuda_harris.harris_scores(left, hopts.k, hopts.nms_thresh, n)
        want = cuda_harris.harris_scores_plain(left, hopts.k,
                                               hopts.nms_thresh, n)
        check(torch.equal(got, want),
              f"K1 NMS window {n} differs from the plain version")
        kps = harris.harris_detect(left, dataclasses.replace(
            hopts, nms_neighborhood=n))
        peaks[n] = (int(torch.isfinite(got).sum()), int(kps.count()))
        check(peaks[n][1] > 0, f"K1 NMS window {n}: no keypoints")
        device_runs.append(("K1", f"device_ms_nms{n}", functools.partial(
            cuda_harris.harris_scores, left, hopts.k, hopts.nms_thresh, n),
            None))
    log("K1 NMS windows", peaks_and_keypoints=peaks)

    kps_l = harris.harris_detect(left, hopts)
    kps_r = harris.harris_detect(right, hopts)
    p = hopts.patch_size
    xy_l, kv_l = kps_l.xy.contiguous(), kps_l.valid
    got, bv_l = cuda_gather.gather_patches(left, xy_l, kv_l, p)
    want, want_bv = cuda_gather.gather_patches_plain(left, xy_l, kv_l, p)
    check(torch.equal(got, want), "K2 descriptors differ from the plain version")
    check(torch.equal(bv_l, want_bv)
          and int(bv_l.view(torch.uint8).max()) <= 1,
          "K2 border flags differ from the plain version")
    # The library yardstick: one torch.take of the flat image by the
    # (K, p*p*3) byte index of the per-tap clamped patches, the index built
    # outside the timed window. It does less than K2: no border test, no
    # mask, no f32 cast, no padding columns.
    k_cap, half = xy_l.shape[0], p // 2
    offs = torch.arange(-half, half + 1, device=DEVICE)
    ys = torch.clamp(xy_l[:, 1:2].long() + offs, 0, left.shape[0] - 1)
    xs = torch.clamp(xy_l[:, 0:1].long() + offs, 0, left.shape[1] - 1)
    take_idx = ((ys[:, :, None] * left.shape[1] + xs[:, None, :])[..., None]
                * 3 + torch.arange(3, device=DEVICE)).reshape(k_cap, -1)
    flat = left.reshape(-1)
    n_bv = int(bv_l.sum())
    res["K2"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: cuda_gather.gather_patches(left, xy_l, kv_l, p)),
        plain_ms=timer(
            lambda: cuda_gather.gather_patches_plain(left, xy_l, kv_l, p)),
        library_ms=timer(lambda: torch.take(flat, take_idx)),
        # The patch bytes of the border-valid rows (the only pixels it
        # reads), the keypoints and their flags in, descriptors and border
        # flags out.
        bound=bound(n_bv * p * p * 3 + nbytes(xy_l, kv_l, got, bv_l), 0),
    )
    device_runs.append(("K2", "device_ms", functools.partial(
        cuda_gather.gather_patches, left, xy_l, kv_l, p), None))
    log("K2 gather_patches", shape=tuple(got.shape), valid=int(kv_l.sum()),
        border_valid=n_bv, **res["K2"])
    del take_idx, flat, ys, xs

    desc_r, bv_r = cuda_gather.gather_patches(right, kps_r.xy.contiguous(),
                                              kps_r.valid, p)
    desc_l = got
    got = cuda_match.match_cores(desc_r, bv_r, desc_l, bv_l)
    want = cuda_match.match_cores_plain(desc_r, bv_r, desc_l, bv_l)
    for name, a, b in zip(("best", "idx", "second", "col_best"), got, want):
        check(torch.equal(a, b), f"K3 {name} differs from the plain version")
    fin = torch.isfinite(want[0]) & torch.isfinite(got[0])
    # Only p*p*3 = 75 of the 128 descriptor columns carry data (K2 writes
    # zeros in the rest); the product's work is over those 75, at the
    # int8 tensor-core rate. The f32 epilogue is per (query, train) pair.
    kq, kt = desc_r.shape[0], desc_l.shape[0]
    k3_mma = 2 * kq * kt * p * p * 3
    k3_epilogue = kq * kt * K3_EPILOGUE_OPS
    k3_bytes = nbytes(desc_r, bv_r, desc_l, bv_l, *got)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    res["K3"] = dict(
        max_abs_err=float((got[0][fin] - want[0][fin]).abs().max())
        if bool(fin.any()) else 0.0,
        ms=timer(lambda: cuda_match.match_cores(desc_r, bv_r, desc_l, bv_l)),
        plain_ms=timer(
            lambda: cuda_match.match_cores_plain(desc_r, bv_r, desc_l, bv_l)),
        library_ms=None,
        bound=bound(k3_bytes, k3_epilogue,
                    more=((k3_mma, INT8_TC_OPS_PER_S),)),
    )
    device_runs.append(("K3", "device_ms", functools.partial(
        cuda_match.match_cores, desc_r, bv_r, desc_l, bv_l), None))
    log("K3 match_streaming", kq=kq, kt=kt, d=desc_r.shape[1],
        product_ms=timer(lambda: torch.mm(desc_r, desc_l.T)),
        bound_int8_product_ms=k3_mma / INT8_TC_OPS_PER_S * 1e3,
        bound_f32_epilogue_ms=k3_epilogue / FP32_OPS_PER_S * 1e3,
        bound_bytes_ms=k3_bytes / HBM_BYTES_PER_S * 1e3, **res["K3"])

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
        check(torch.equal(got, want),
              f"K4a {tag} differs from the plain version")
        log(f"K4a {tag}", canvas=(geo.canvas_h, geo.canvas_w),
            window=geo.window, max_abs_err=errs["K4a"][-1])
        if tag == "planted":
            # The library yardstick of K4a and K4b: grid_sample (bilinear,
            # zero border) of the f32 NCHW image on the precomputed
            # sampling grid: the window's RGB sample alone, unrounded,
            # without the map, the weight, the overlay or the canvas.
            sx, sy = warp_ops._inverse_map(geo.m_inv, wy1 - wy0, wx1 - wx0,
                                           wx0, wy0, right.device)
            grid = torch.stack([sx / (W_IMG - 1) * 2 - 1,
                                sy / (H_IMG - 1) * 2 - 1], -1)[None]
            src = right.permute(2, 0, 1)[None].float().contiguous()

            def grid_sample():
                return F.grid_sample(src, grid, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=True)

            res["K4a"] = dict(
                ms=timer(lambda: cuda_warp.warp_compose_overlay(*call_args)),
                plain_ms=timer(
                    lambda: cuda_warp.warp_compose_overlay_plain(*call_args)),
                library_ms=timer(grid_sample),
                bound=bound(nbytes(right, left, got),
                            win_px * WARP_OPS_PER_PX),
            )
            device_runs.append(("K4a", "device_ms", functools.partial(
                cuda_warp.warp_compose_overlay, *call_args), None))

        # K4b: the windowed warp, without and with the ramp alpha
        for has_alpha in (False, True):
            wargs = (right, geo.m_inv, geo.window, has_alpha)
            rgb, w = cuda_warp.warp_packed(*wargs)
            rgb_p, w_p = cuda_warp.warp_packed_plain(*wargs)
            rgb_err = check_warp(rgb, rgb_p, geo.window, "K4b")
            w_err = float((w - w_p).abs().max())
            check(w_err <= 1e-5, f"K4b {tag} weight max |d| {w_err}")
            check(torch.equal(rgb, rgb_p) and torch.equal(w, w_p),
                  f"K4b {tag} has_alpha={has_alpha} differs from the plain "
                  f"version")
            errs["K4b"].append(max(rgb_err, w_err))
            log(f"K4b {tag}", has_alpha=has_alpha, window=geo.window,
                rgb_max_abs_err=rgb_err, weight_max_abs_err=w_err)
        if tag == "planted":
            res["K4b"] = dict(
                ms=timer(lambda: cuda_warp.warp_packed(*wargs)),
                plain_ms=timer(lambda: cuda_warp.warp_packed_plain(*wargs)),
                library_ms=timer(grid_sample),
                bound=bound(nbytes(right, rgb, w),
                            win_px * (WARP_OPS_PER_PX + ALPHA_OPS_PER_PX)),
            )
            device_runs.append(("K4b", "device_ms", functools.partial(
                cuda_warp.warp_packed, *wargs), None))
            device_runs.append(("K4b", "device_ms_no_alpha", functools.partial(
                cuda_warp.warp_packed, *wargs[:3], False), None))
            device_runs.append(("K4b", "device_ms_no_weight", functools.partial(
                cuda_warp.warp_packed, *wargs, emit_weight=False), None))
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
            check(torch.equal(got, want),
                  f"K5 {tag} {blend} differs from the plain version")
            errs["K5"].append(float(d))
            log(f"K5 {tag}", blend=blend, canvas=(geo.canvas_h, geo.canvas_w),
                max_abs_err=d)
            if tag == "planted" and blend == "overlay":
                device_runs.append(("K5", "device_ms_overlay",
                                    functools.partial(
                                        cuda_compose.compose_canvas, *cargs),
                                    None))
        if tag == "planted":
            res["K5"] = dict(
                ms=timer(lambda: cuda_compose.compose_canvas(*cargs)),
                plain_ms=timer(
                    lambda: cuda_compose.compose_canvas_plain(*cargs)),
                library_ms=None,
                bound=bound(nbytes(left, rgb, w, got),
                            win_px * FEATHER_OPS_PER_PX),
            )
            device_runs.append(("K5", "device_ms", functools.partial(
                cuda_compose.compose_canvas, *cargs), None))
    del got, want, desc_r, desc_l, rgb, w, rgb_p, w_p

    # K6: a chain step of the strip, image 2 into the canvas that holds
    # image 1 and its weight ramp, overlay (in-bounds weight) and feather
    # (ramp alpha). K6 updates in place: every run starts from a copy.
    sh, sw = strip_shape()
    base_c = torch.zeros((sh, sw, 3), dtype=torch.uint8, device=DEVICE)
    warp_ops._place(base_c, strip[0], 0, 0)
    base_w = torch.zeros((sh, sw), dtype=torch.float32, device=DEVICE)
    warp_ops._place(base_w, warp_ops._edge_ramp(H_IMG, W_IMG, DEVICE), 0, 0)
    work = (base_c.clone(), base_w.clone())
    ref = (base_c.clone(), base_w.clone())

    def prime(bufs):
        bufs[0].copy_(base_c)
        bufs[1].copy_(base_w)

    errs["K6"] = []
    x1, y1 = STRIP[1]
    for tag, m in (("planted", translation(x1, y1)),
                   ("projective", translation(x1, y1) @ m_proj)):
        window = warp_ops.warp_window(warp_ops.warp_corners(m, H_IMG, W_IMG),
                                      sh, sw)
        wy0, wx0, wy1, wx1 = window
        win_px = (wy1 - wy0) * (wx1 - wx0)
        for blend in ("overlay", "feather"):
            rgb, w = cuda_warp.warp_packed(strip[1], np.linalg.inv(m), window,
                                           has_alpha=blend == "feather")
            cargs = (rgb, w, window, blend)
            prime(work)
            cuda_compose.compose_chain_canvas(*work, *cargs)
            prime(ref)
            cuda_compose.compose_chain_canvas_plain(*ref, *cargs)
            d = int((work[0].int() - ref[0].int()).abs().max())
            w_err = float((work[1] - ref[1]).abs().max())
            check(d <= (0 if blend == "overlay" else 1),
                  f"K6 {tag} {blend} max |d| {d}")
            check(w_err == 0.0, f"K6 {tag} {blend} weight max |d| {w_err}")
            check(torch.equal(work[0], ref[0]) and torch.equal(work[1], ref[1]),
                  f"K6 {tag} {blend} differs from the plain version")
            errs["K6"].append(float(d))
            log(f"K6 {tag}", blend=blend, canvas=(sh, sw), window=window,
                max_abs_err=d, weight_max_abs_err=w_err)
            if tag == "planted" and blend == "overlay":
                device_runs.append(("K6", "device_ms_overlay",
                                    functools.partial(
                                        cuda_compose.compose_chain_canvas,
                                        *work, *cargs),
                                    functools.partial(prime, work)))
        if tag == "planted":  # the feather step
            res["K6"] = dict(
                ms=timer(lambda: cuda_compose.compose_chain_canvas(
                    *work, *cargs), setup=lambda: prime(work)),
                plain_ms=timer(lambda: cuda_compose.compose_chain_canvas_plain(
                    *ref, *cargs), setup=lambda: prime(ref)),
                library_ms=None,
                # Canvas pixel and weight read and written, the window's
                # pixel and weight read: 3 + 3 + 4 + 4 + 3 + 4 bytes.
                bound=bound(win_px * 21, win_px * CHAIN_OPS_PER_PX),
            )
            device_runs.append(("K6", "device_ms", functools.partial(
                cuda_compose.compose_chain_canvas, *work, *cargs),
                functools.partial(prime, work)))
    for k in ("K4a", "K4b", "K5", "K6"):
        res[k]["max_abs_err"] = max(errs[k])
        log(f"{k} {KERNELS[k][0]}", **res[k])

    # K7: the refine's 9x9 normal matrix of the planted pair, as the main
    # path hands it to the kernel (recorded around the wrapper through one
    # estimate). Its library call is torch.linalg.eigh, timed with the host
    # sync of its error check: the end event is recorded after the call
    # returns, so the sync is inside the window.
    ata_seen = []
    k7 = cuda_eigh.smallest_eigvec9

    def record(ata):
        ata_seen.append(ata.clone())
        return k7(ata)

    # The default table injected: the eager estimate calls the wrapper (a
    # replay of the estimate's CUDA graph calls no Python).
    r_opts = DEFAULT_CONFIG.ransac
    table = ransac.default_sampler(r_opts.num_iterations, r_opts.num_samples,
                                   r_opts.seed, DEVICE)
    cuda_eigh.smallest_eigvec9 = record
    try:
        PairStitcher(DEFAULT_CONFIG, print_timing=False, device=DEVICE,
                     sampler=table)._fused_estimate_impl(left, right)
    finally:
        cuda_eigh.smallest_eigvec9 = k7
    ata, = ata_seen
    got = cuda_eigh.smallest_eigvec9(ata)
    want = cuda_eigh.smallest_eigvec9_plain(ata)
    check(torch.equal(got, want), "K7 differs from the plain version")
    v64 = np.linalg.eigh(ata.double().cpu().numpy())[1][:, 0]
    align = 1.0 - abs(float(got.double().cpu().numpy() @ v64))
    check(align <= 1e-5, f"K7: 1 - |v . v_f64| = {align}")
    res["K7"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: cuda_eigh.smallest_eigvec9(ata)),
        plain_ms=timer(lambda: cuda_eigh.smallest_eigvec9_plain(ata)),
        library_ms=timer(lambda: torch.linalg.eigh(ata)),
        # The matrix in, the vector out; the f64 rotations its data needs.
        bound=bound(nbytes(ata, got),
                    cuda_eigh.SWEEPS * 36 * K7_OPS_PER_ROTATION,
                    FP64_OPS_PER_S),
    )
    device_runs.append(("K7", "device_ms", functools.partial(
        cuda_eigh.smallest_eigvec9, ata), None))
    log("K7 smallest_eigvec9", shape=tuple(ata.shape),
        sweeps=cuda_eigh.SWEEPS, one_minus_cos_vs_f64=align, **res["K7"])
    del ata_seen, got, want

    pyramid_rows(torch, timer, res, device_runs)

    # Device time of each kernel, taken after every `ms` above so that
    # those stay as earlier versions of this script took them: the card
    # warmed first, and a spin before each run, so that the wrapper's
    # host time is not in the window. K4b also without the ramp alpha and
    # K6 also with overlay (the timed calls above are the feather ones).
    timer.warm()
    for k, field, fn, setup in device_runs:
        res[k][field] = timer(fn, setup=setup, spin=True)
    # What any launch costs under this timer: a one-element fill_.
    one = torch.zeros(1, device=DEVICE)
    log("launch floor", fill_device_ms=timer(lambda: one.fill_(1.0),
                                             spin=True))
    log("device time", **{k: res[k]["device_ms"] for k in KERNELS},
        K4b_no_alpha=res["K4b"]["device_ms_no_alpha"],
        K4b_no_weight=res["K4b"]["device_ms_no_weight"],
        K5_overlay=res["K5"]["device_ms_overlay"],
        K6_overlay=res["K6"]["device_ms_overlay"],
        **{f"K1_nms{n}": res["K1"][f"device_ms_nms{n}"] for n in K1_WINDOWS},
        **{k: res[k]["device_ms"] for k in PYRAMID})
    del device_runs, fn, setup, rgb, w, work, ref, base_c, base_w

    # RANSAC's default table, JAX's randint, made on the card from a
    # device n_valid: the CPU's, for every span the pair can give.
    shape = (r_opts.num_iterations, r_opts.num_samples)
    on_card = ransac.default_sampler(*shape, r_opts.seed, DEVICE)
    on_cpu = ransac.default_sampler(*shape, r_opts.seed, "cpu")
    spans = (0, 1, 7, 1000, 4097, hopts.max_keypoints)
    for n_valid in spans:
        got = on_card(torch.tensor(n_valid, dtype=torch.int32, device=DEVICE))
        check(got.device.type == DEVICE and torch.equal(
            got.cpu(), on_cpu(torch.tensor(n_valid, dtype=torch.int32))),
            f"RANSAC's default table on the card differs at n_valid "
            f"{n_valid}")
    nv = torch.tensor(hopts.max_keypoints, dtype=torch.int32, device=DEVICE)
    log("RANSAC default table", shape=shape, seed=r_opts.seed,
        n_valid=spans, equal_to_cpu=True,
        draw_ms=timer(lambda: on_card(nv)))

    mods = {"K1": (cuda_harris, "launches"), "K2": (cuda_gather, "launches"),
            "K3": (cuda_match, "launches"), "K4a": (cuda_warp, "launches"),
            "K4b": (cuda_warp, "packed_launches"),
            "K5": (cuda_compose, "launches"),
            "K6": (cuda_compose, "chain_launches"),
            "K7": (cuda_eigh, "launches"),
            "K1b": (cuda_harris, "batched_launches"),
            "K4bb": (cuda_warp, "batched_packed_launches"),
            "K8": (cuda_blend, "reduce_launches"),
            "K9": (cuda_blend, "collapse_launches")}
    none = dict.fromkeys(mods, 0)
    front = {**none, "K1": 2, "K2": 2, "K3": 1, "K7": 1}

    def stitch_config(blend, gain=False):
        cfg = DEFAULT_CONFIG.replace(stitch=dataclasses.replace(
            DEFAULT_CONFIG.stitch, blend=blend, gain_compensation=gain))
        return PairStitcher(cfg, print_timing=False, device=DEVICE)

    # 5. the main path (overlay), through the entry point a user calls
    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False, device=DEVICE)
    pano, launches, first_ms = stitch_once(
        torch, stitcher, left, right, mods,
        {**front, "K4a": 1}, "overlay")
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
        {**front, "K4b": 1, "K5": 1}, "feather")
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
        pyr = pyramid_launches(1) if blend == "multiband" else {}
        out, launches_x, wall = stitch_once(
            torch, st, left, right, mods,
            {**front, "K4b": 1, "K5": 1, **pyr}, tag)
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
    staged = PairStitcher(DEFAULT_CONFIG, print_timing=True, device=DEVICE)
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
    check(pano_s is not None and pano_s.device.type == DEVICE,
          "stitch_pair returned None")
    check(all(abs(a - b) <= 1 for a, b in zip(pano_s.shape, pano.shape)),
          f"staged canvas {tuple(pano_s.shape)} vs fused {tuple(pano.shape)}")
    hh, ww = min(pano_s.shape[0], pano.shape[0]), min(pano_s.shape[1],
                                                      pano.shape[1])
    d_staged = int((pano_s[:hh, :ww].int() - pano[:hh, :ww].int()).abs().max())
    check(d_staged <= 1, f"staged vs fused panorama max |d| {d_staged}")
    log("staged path", canvas=tuple(pano_s.shape), fused=tuple(pano.shape),
        max_abs_diff_vs_fused=d_staged)
    pano_ref = pano  # phase 14's benches must give these bytes
    del pano, pano_s

    # 9. chain, through the entry point a user calls, on the strip
    from pano_tpu_torch import pipeline, stitch_all_images
    from pano_tpu_torch import timer as pano_timer

    n = len(STRIP)
    steps = [f"Stitching image {i + 1} of {n}..." for i in range(1, n)]
    canvas_plant = strip_shape()

    def check_canvas(pano, tag, slack=1):
        check(all(0 <= a - b <= slack
                  for a, b in zip(pano.shape[:2], canvas_plant)),
              f"{tag}: canvas {pano.shape} vs planted {canvas_plant}")

    def check_scene(pano, imgs, offsets, seen, bar, tag):
        """The recovered globals and the panorama against the scene."""
        (gs, anchor), = seen
        t_mat, _, _ = pipeline.global_canvas_geometry(imgs, gs, anchor)
        corner_err = globals_err(gs, offsets, anchor)
        check(corner_err < 0.5, f"{tag}: a global is off by {corner_err} px")
        # The anchor at the pixel nearest its exact place, as blend_global
        # puts it.
        anchor_at = (int(np.round(t_mat[1, 2])), int(np.round(t_mat[0, 2])))
        d, n_band = scene_diff(pano, imgs, offsets, anchor, anchor_at)
        stats = dict(max=int(d.max()), share_gt1=float((d > 1).mean()),
                     bar=bar, edge_band_px=n_band, anchor=anchor,
                     anchor_at=anchor_at)
        check(stats["max"] <= bar, f"{tag}: panorama vs scene {stats}")
        return round(corner_err, 5), stats

    chain_launches = {}
    for tag, blend, gain in (("overlay", "overlay", False),
                             ("feather", "feather", False),
                             ("multiband", "multiband", False),
                             ("feather+gain", "feather", True)):
        cfg = DEFAULT_CONFIG.replace(stitch=dataclasses.replace(
            DEFAULT_CONFIG.stitch, blend=blend, gain_compensation=gain))
        k6 = n - 1 if blend != "multiband" and not gain else 0
        pyr = pyramid_launches(n - 1) if blend == "multiband" else {}
        want = {**none, "K1": 2 * (n - 1), "K2": 2 * (n - 1), "K3": n - 1,
                "K7": n - 1, "K4b": n - 1, "K6": k6, **pyr}

        def call():
            return stitch_all_images(strip, cfg, True, "", DEVICE, "chain")

        torch.cuda.reset_peak_memory_stats()
        with recorded_globals(pipeline) as seen:
            out, lines, launches_c, wall = run_mode(
                torch, mods, want, f"chain {tag}", call)
        peak = torch.cuda.max_memory_allocated() / 2**20
        check_lines(lines, [*steps, f"{TOTAL}: x.xxx ms"], f"chain {tag}")
        check_canvas(out, f"chain {tag}")
        corner_err, stats = check_scene(
            out, strip_np, STRIP, seen, 3 if blend == "multiband" else 2,
            f"chain {tag}")
        walls = [wall]
        if tag == "multiband":
            chain_pyramid = launches_c
        if tag == "overlay":  # warm calls: median of 3, each equal
            chain_launches = launches_c
            chain_ref = out  # phase 12's CLI must write these bytes
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    again = call()
                walls.append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(again, out), "repeat chain differs")
            peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"chain {tag}", canvas=out.shape, corner_err_px=corner_err,
            scene=stats, launches=launches_c,
            call_ms=round(float(np.median(walls)), 3),
            call_ms_all=[round(x, 3) for x in walls],
            first_call_ms=round(wall, 3), peak_mem_mib=round(peak, 1),
            card=f"'{smi}'")
        if tag == "overlay":
            print("  " + lines[-1], flush=True)
            log("stages chain overlay", **chain_breakdown(
                torch, pipeline, cfg, strip_np, strip))
            canvas = torch.zeros(strip_shape() + (3,), dtype=torch.uint8,
                                 device=DEVICE)
            ch, cw = min(out.shape[0], canvas.shape[0]), \
                min(out.shape[1], canvas.shape[1])
            canvas[:ch, :cw] = torch.from_numpy(out[:ch, :cw]).to(DEVICE)
            fetch_phase(torch, pano_timer, canvas, smi)
            del canvas

        # The planted globals themselves: no estimate error.
        if not gain:
            planted = [translation(x, y) for x, y in STRIP]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exact = pipeline.composite_global(strip_np, strip, planted, cfg)
            composite_ms = (time.perf_counter() - t0) * 1e3
            check(exact.shape[:2] == canvas_plant,
                  f"planted {tag}: canvas {exact.shape}")
            d, _ = scene_diff(exact, strip_np, STRIP, 0, (0, 0))
            bar = {"overlay": 0, "feather": 1, "multiband": 2}[blend]
            check(int(d.max()) <= bar, f"planted {tag}: max |d| {d.max()}")
            log(f"chain {tag} planted globals", max_abs_diff=int(d.max()),
                share_gt1=float((d > 1).mean()), bar=bar,
                composite_global_ms=round(composite_ms, 3))
            del exact
        del out

    # 10. auto: the strip shuffled, overlay
    imgs_auto = [strip[i] for i in AUTO_ORDER]
    np_auto = [strip_np[i] for i in AUTO_ORDER]
    off_auto = [STRIP[i] for i in AUTO_ORDER]
    n_pairs = n * (n - 1) // 2
    with recorded_globals(pipeline) as seen:
        out, lines, launches_a, wall = run_mode(
            torch, mods,
            {**none, "K1": n, "K2": n, "K3": n_pairs, "K7": n_pairs,
             "K4b": n - 1, "K6": n - 1},
            "auto",
            lambda: stitch_all_images(imgs_auto, DEFAULT_CONFIG, True, "",
                                      DEVICE, "auto"))
    order = [x for x in lines if x.startswith("Auto-ordering")]
    check(len(order) == 1 and order[0].endswith(f"placed {n} of {n}"),
          f"auto: printed lines {lines}")
    check(STAGE_LINE.match(lines[-1]) and lines[-1].startswith(TOTAL),
          f"auto: printed lines {lines}")
    check_canvas(out, "auto")
    corner_err, stats = check_scene(out, np_auto, off_auto, seen, 2, "auto")
    for line in lines:
        print("  " + line, flush=True)
    log("auto", order=AUTO_ORDER, canvas=out.shape,
        corner_err_px=corner_err, scene=stats, launches=launches_a,
        call_ms=round(wall, 3), card=f"'{smi}'")
    auto_ref = out  # phase 13's sharded auto must give these bytes

    # 11. fold, the single-sync pair per step, overlay
    out, lines, launches_fold, wall = run_mode(
        torch, mods,
        {**none, "K1": 2 * (n - 1), "K2": 2 * (n - 1), "K3": n - 1,
         "K7": n - 1, "K4a": n - 1},
        "fold",
        lambda: stitch_all_images(strip, DEFAULT_CONFIG, True, "", DEVICE,
                                  "fold", "total"))
    check_lines(lines, [x for step in steps
                        for x in (step, f"{STAGES[-1]}: x.xxx ms")]
                + [f"{TOTAL}: x.xxx ms"], "fold")
    check_canvas(out, "fold", slack=2 * (n - 1))
    log("fold", canvas=out.shape, launches=launches_fold,
        call_ms=round(wall, 3), card=f"'{smi}'")
    del out

    # 12. the CLI and serve, on files, in child processes and in process
    cli_phase(torch, mods, strip, strip_np, (left_np, right_np), chain_ref,
              chain_launches, launches_f)
    # 13. the batched entries and the sharded paths
    launches_s = shard_phase(torch, mods, none, timer, res, smi, strip,
                             strip_np, (left, right), chain_ref, auto_ref)
    del chain_ref, auto_ref
    # 14. the measuring and driver layer
    driver_phase(torch, mods, none, smi, (left, right), (left_np, right_np),
                 pano_ref, launches)
    del pano_ref
    # 15. the record lines
    all_launches = {**launches, "K4b": launches_f["K4b"],
                    "K5": launches_f["K5"], "K6": chain_launches["K6"],
                    "K1b": launches_s["K1b"], "K4bb": launches_s["K4bb"],
                    "K8": chain_pyramid["K8"], "K9": chain_pyramid["K9"]}
    names = {**KERNELS, **BATCHED, **PYRAMID}
    print(smi)
    print(json.dumps({"kernels": [
        {"name": names[k][0], "route": "cuda", "source": names[k][1],
         "replaces": names[k][2], "launches": all_launches[k],
         "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
         "device_ms": res[k]["device_ms"],
         "plain_ms": res[k]["plain_ms"], "bound_ms": res[k]["bound"][0],
         "bound_by": res[k]["bound"][1], "library_ms": res[k]["library_ms"],
         **{f: res[k][f] for f in EXTRA_DEVICE_MS if f in res[k]}}
        for k in names
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
