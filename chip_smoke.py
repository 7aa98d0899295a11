#!/usr/bin/env python3
"""The kernel table of the PyTorch + CUDA port (pano_tpu_torch) on a GPU.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py [--seed N]

It holds each hand-written kernel to its plain PyTorch version and times
it alone. The port's paths are checked on the card by the card tests
(`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`) and
measured end to end by the benchmark (`python3 -m pano_bench.run`,
BENCHMARK.json).

Phases, one line of numbers each; any failure raises, so the exit code is
non-zero and the last line is not printed.

1. device: nvidia-smi name and power limit, torch and CUDA versions.
2. build: compiles pano_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. data: a 4156x3117 textured pair from --seed (the right image the left
   one's scene shifted by (DX, DY), so the right->left homography is that
   translation), and a strip of four 4156x3117 crops of one 8356x3169
   scene at the STRIP offsets.
4. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, torch.equal on every output: K1 (also at the NMS
   windows 5-15, each through harris_detect), K2 on the left image's
   keypoints, K3, K4a / K4b / K5 on the planted H and a mild projective
   one (K4b with and without the ramp alpha, K5 overlay and feather), K6
   a step of the strip's chain, K7 on the planted pair's 9x9 normal
   matrix as the estimate hands it over (also against float64 eigh), K10
   on the planted pair's match points and the default table, K11 (the
   direct alignment's passes) on a rotating camera's pair from RANSAC's
   estimate (the overlap's count equal, image 1's corners within 1e-4
   px: its float64 sums run in another order than the plain version's), K8 /
   K9 at a chain window's size (the whole blend also equal to
   ops/blend.py's route), and the batched K1 (the strip) and K4b (the
   chain's three windows), also equal to their single launches. Each
   one's `ms` (median of 10, CUDA events, L2 flushed), its plain
   version's, a library call's where one computes the same function
   (K2: torch.take; K4a / K4b: F.grid_sample; K7: torch.linalg.eigh; K3's
   torch.mm as `product_ms`) and its bound; then each one's `device_ms`
   alone (the card warmed, a spin before each run so that the host's
   enqueue is not in the window; K4b also without the alpha and the
   weight, K5 / K6 also overlay, K1 at the other windows, the batched
   entries' singles) and the launch floor (a one-element fill_).
5. paths: the pair (overlay, multiband), the chain (multiband), auto and
   the fold on the planted data (pair_on_card, strip_on_card: the card
   tests run them with every blend), each with every kernel's launches.

The last two lines are a JSON object with the card (the nvidia-smi line)
and the per-kernel numbers, and {"ok": true, ...}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import time

import numpy as np

from pano_bench.roofline import (
    ALPHA_OPS_PER_PX, DETECT_OPS_PER_PX, EIGVEC_OPS, HBM_BYTES_PER_S,
    MATCH_EPILOGUE_OPS, PEAK_OPS_PER_S, WARP_OPS_PER_PX,
)

H_IMG, W_IMG = 3117, 4156   # the mountain pair's size (bench.py)
DX, DY = 1400, 37           # planted right -> left translation
# The strip: each image's planted (x, y) offset in one scene.
STRIP = ((0, 0), (1400, 37), (2800, 15), (4200, 52))
AUTO_ORDER = (2, 0, 3, 1)   # a shuffled order of the strip
DEVICE = "cuda"             # where every kernel runs

# name, source under pano_tpu_torch/csrc/, the TPU kernel it replaces (its
# pallas_call, file:line under pano_tpu/ops/)
KERNELS = {
    "K1": ("harris_scores", "harris.cu", "pallas_harris.py:406"),
    "K2": ("gather_patches", "gather.cu", "pallas_gather.py:188"),
    "K3": ("match_streaming", "match.cu", "pallas_match.py:193"),
    "K4a": ("warp_compose_overlay", "warp.cu", "pallas_warp.py:1030"),
    "K4b": ("warp_packed", "warp.cu", "pallas_warp.py:870"),
    "K5": ("compose_canvas", "compose.cu", "pallas_compose.py:341"),
    "K6": ("compose_chain_canvas", "compose.cu", "pallas_compose.py:249"),
    # No pallas_call: the refine's jnp.linalg.eigh, which XLA runs on the
    # TPU as Jacobi sweeps.
    "K7": ("smallest_eigvec9", "eigh9.cu", "ransac.py:245"),
    # No pallas_call: the hypothesis search, which XLA runs on the TPU
    # (homography_from_4pts under vmap, _score_hypotheses, argmax).
    "K10": ("ransac_search", "ransac.cu", "ransac.py:251"),
}
# The batched entries of K1 and K4b (the TPU kernels' batched grids, under
# their custom_vmap rules).
BATCHED = {
    "K1b": ("harris_scores_batched", "harris.cu", "pallas_harris.py:406"),
    "K4bb": ("warp_packed_batched", "warp.cu", "pallas_warp.py:870"),
}
# Multiband's pyramid, which replaces no TPU kernel (the JAX package leaves
# it to XLA in blend.py).
PYRAMID = {
    "K8": ("pyramid_reduce", "pyramid.cu", None),
    "K9": ("pyramid_collapse", "pyramid.cu", None),
}
PYRAMID_WINDOW = (1504, 2016)  # a chain window of the oilseed images
# The direct alignment of a pair's homography, which replaces no TPU kernel
# (the JAX package has none).
ALIGN = {"K11": ("align_gauss_newton", "align.cu", None)}
# The rotating camera's pair K11 is held and timed on (the benchmark's
# rotating_pair_4k configuration and the first of its rotate_serial poses).
ALIGN_POSE = (30.0, 0.5, 0.25)
ALIGN_SEED = 4200000001

# The least time a kernel could take is the larger of its bytes over the
# memory rate and its operations over the peak rate of their type (the
# H100's data sheet, pano_bench/roofline.py, which also counts K1, K3,
# K4a/K4b and K7). Operations per output pixel of the other kernels,
# counted from their arithmetic:
# K5 feather: the left ramp 8, the total 2, per channel 2 products, a sum,
#     a division, two selects, round and clip (8).
FEATHER_OPS_PER_PX = 34
# K6 feather: K5's without the left ramp (the weight is read), plus the
#     max of the two weights.
CHAIN_OPS_PER_PX = 27
# K8 per output pixel and plane: 25 taps of a product and a sum. K9 per
#     fine pixel: at most 9 hit taps of 9 planes (product and sum), the
#     normaliser 3, 9 divisions, the mask's clamp 3, three bands of 7.
K8_OPS_PER_PX = 50
K9_OPS_PER_PX = 9 * 18 + 3 + 9 + 3 + 21
# K10 per hypothesis, its DLT: the two Hartley similarities 2 x 42, the
#     four correspondences normalized 64, the system's products 32, the
#     elimination 8 x (8 magnitudes, 7 divisions, 72 products, 72
#     differences, 9 pivot-row sums, the pivot's compares) 1344, the
#     back-substitution 8, the inverse 41, two 3x3 products 90 and the
#     normalization 9. Per (hypothesis, valid match), its score: w, the two
#     numerators 3 x 4, two divisions, two differences, the squared
#     distance 3 and the compare.
K10_DLT_OPS = 84 + 64 + 32 + 1344 + 8 + 41 + 90 + 9
K10_SCORE_OPS = 12 + 2 + 2 + 3 + 1

# Device times of other variants of a kernel's timed call, logged beside
# its device_ms: K4b without the ramp alpha and without the weight, K5 and
# K6 with overlay, K1 at its other NMS windows; for a batched entry, its
# elements as single launches, one after another.
K1_WINDOWS = (5, 7, 9, 11, 15)  # K1's other NMS windows checked and timed
EXTRA_DEVICE_MS = ("device_ms_no_alpha", "device_ms_no_weight",
                   "device_ms_overlay",
                   *(f"device_ms_nms{n}" for n in K1_WINDOWS),
                   "singles_device_ms")


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


def bound(nbytes: float, nops: float, kind: str = "f32", more=()):
    """(bound_ms, bound_by): the larger of the two least times. `more`
    holds (ops, kind) of operations of other types, which run on other
    units: the operations time is the largest of them."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[k]
                for n, k in [(nops, kind), *more]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def equal_nan(a, b) -> bool:
    """torch.equal, with NaN equal to NaN in the same places."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = a.isnan(), b.isnan()
    return bool((na == nb).all() and (a[~na] == b[~nb]).all())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def batched_rows(torch, timer, res, device_runs, strip, strip_np) -> None:
    """Phase 4's batched K1 over the strip's four images and batched K4b
    over the chain's three windows (the planted globals, the ramp alpha):
    each torch.equal to its plain version and to its elements' single
    launches; their device times, and the single launches', join
    `device_runs`."""
    from pano_tpu_torch import DEFAULT_CONFIG, pipeline
    from pano_tpu_torch.ops import cuda_harris, cuda_warp

    hopts = DEFAULT_CONFIG.harris
    n = len(strip)
    # K1 over the strip's four images
    stack = torch.stack(strip)
    args = (hopts.k, hopts.nms_thresh)
    got = cuda_harris.harris_scores_batched(stack, *args)
    want = cuda_harris.harris_scores_batched_plain(stack, *args)
    check(torch.equal(got, want), "K1 batched differs from the plain version")
    for i in range(n):
        check(torch.equal(got[i], cuda_harris.harris_scores(strip[i], *args)),
              f"K1 batched: image {i} differs from its single launch")
    k1_batched = functools.partial(cuda_harris.harris_scores_batched, stack,
                                   *args)

    def k1_singles():
        return [cuda_harris.harris_scores(im, *args) for im in strip]

    res["K1b"] = dict(
        ms=timer(k1_batched),
        plain_ms=timer(lambda: cuda_harris.harris_scores_batched_plain(
            stack, *args), reps=3),
        library_ms=None,
        bound=bound(nbytes(stack, got), n * H_IMG * W_IMG * DETECT_OPS_PER_PX),
    )
    log("K1b harris_scores_batched", shape=tuple(got.shape),
        equal_to_plain=True, equal_to_single_launches=True, **res["K1b"])
    del got, want

    # K4b over the chain's three windows, with the ramp alpha
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
    for (rgb, w), (rgb_p, w_p), src, m, win in zip(got, want, srcs, maps,
                                                  wins):
        one = cuda_warp.warp_packed(src, m, win)
        check(torch.equal(rgb, rgb_p) and torch.equal(w, w_p),
              f"K4b batched: window {win} differs from the plain version")
        check(torch.equal(rgb, one[0]) and torch.equal(w, one[1]),
              f"K4b batched: window {win} differs from its single launch")
    win_px = sum((w[2] - w[0]) * (w[3] - w[1]) for w in wins)
    k4b_batched = functools.partial(cuda_warp.warp_packed_batched, srcs, maps,
                                    wins)

    def k4b_singles():
        return [cuda_warp.warp_packed(src, m, win)
                for src, m, win in zip(srcs, maps, wins)]

    res["K4bb"] = dict(
        ms=timer(k4b_batched),
        plain_ms=timer(lambda: cuda_warp.warp_packed_batched_plain(
            srcs, maps, wins), reps=3),
        library_ms=None,
        bound=bound(nbytes(*srcs, *(t for pr in got for t in pr)),
                    win_px * (WARP_OPS_PER_PX + ALPHA_OPS_PER_PX)),
    )
    log("K4bb warp_packed_batched", windows=wins, equal_to_plain=True,
        equal_to_single_launches=True, **res["K4bb"])
    del got, want
    for k, batched, singles in (("K1b", k1_batched, k1_singles),
                                ("K4bb", k4b_batched, k4b_singles)):
        device_runs.append((k, "device_ms", batched, None))
        device_runs.append((k, "singles_device_ms", singles, None))


def align_row(torch, timer, res, device_runs) -> None:
    """K11 on a rotating camera's 4156x3117 pair (pano_bench's rotating
    scene model at ALIGN_POSE, the rotating_pair_4k configuration) from
    RANSAC's estimate without the alignment: against its plain version
    (the same overlap count; the float64 sums run in another order, so the
    parameters agree to ~1e-12 and image 1's corners within 1e-4 px), its
    launches, `ms`, plain and bound (pano_bench/align_roofline.py)."""
    import dataclasses
    import pathlib

    from pano_bench import align_roofline, scenes
    from pano_bench.run import pano_config
    from pano_bench.scene_models import rotating
    from pano_tpu_torch import PairStitcher
    from pano_tpu_torch.ops import align, cuda_align

    path = pathlib.Path(__file__).resolve().parent / "pano_bench"
    cfg = json.loads((path / "configs" / "rotating_pair_4k.json").read_text())
    conf = pano_config(cfg["pano_config"])
    iters = conf.ransac.align_iterations
    traffic = {"hfov_deg": 65, "scenes": [[[0, 0, 0], list(ALIGN_POSE)]]}
    scene = rotating.make_pool(traffic, cfg, ALIGN_SEED, DEVICE, "device")[0]
    left, right = scene.images
    st = PairStitcher(conf.replace(ransac=dataclasses.replace(
        conf.ransac, align_iterations=0)), print_timing=False, device=DEVICE)
    st.stitch_pair_fast(left, right)
    h = torch.from_numpy(st.last_estimate[:9].copy()).reshape(3, 3).to(DEVICE)
    fr = cuda_align.frame(left.shape[:2], right.shape[:2])
    p0 = align.to_normalized(h, fr)
    before = cuda_align.launches
    got = cuda_align.gauss_newton(p0, left, right, iters, fr)
    check(cuda_align.launches == before + iters + 1,
          "K11: not iterations + 1 launches")
    want = cuda_align.gauss_newton_plain(p0, left, right, iters, fr)
    ne = [cuda_align.N_START, cuda_align.N_END, cuda_align.SINGULAR]
    check(torch.equal(got[ne], want[ne]), "K11 counts differ from the plain")
    c = np.array([[0, 0, 1], [W_IMG, 0, 1], [W_IMG, H_IMG, 1], [0, H_IMG, 1]],
                 np.float64)

    def corners(state):
        q = c @ align.from_normalized(state[:8], fr).cpu().numpy().T
        return q[:, :2] / q[:, 2:]
    corner_px = float(np.abs(corners(got) - corners(want)).max())
    check(corner_px <= 1e-4, f"K11 corners {corner_px} px off the plain")
    g = scenes.planted_globals(scene)[1]
    k11 = functools.partial(cuda_align.gauss_newton, p0, left, right, iters,
                            fr)
    # The passes' bytes and operations over the overlap (align_roofline.py).
    n = align_roofline.overlap_px(tuple(right.shape[:2]),
                                  tuple(left.shape[:2]), g)
    px = (iters + 1) * n
    res["K11"] = dict(
        ms=timer(k11),
        plain_ms=timer(lambda: cuda_align.gauss_newton_plain(
            p0, left, right, iters, fr), reps=3, warmup=1),
        library_ms=None,
        bound=bound(align_roofline.BYTES_PER_PX * px,
                    align_roofline.F32_OPS_PER_PX * px, "f32",
                    ((align_roofline.F64_OPS_PER_PX * px, "f64"),)),
        max_abs_err=float((got[:8] - want[:8]).abs().max()))
    device_runs.append(("K11", "device_ms", k11, None))
    log("K11 align_gauss_newton", shape=tuple(right.shape), passes=iters + 1,
        overlap_px=round(n), corner_px=corner_px,
        mse=(float(got[cuda_align.E_START]), float(got[cuda_align.E_END])),
        **res["K11"])


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
    # A REDUCE a level below the top, a collapse step a level.
    _, n_launch = launches(lambda: cuda_blend.laplacian_blend(a, b, m, 5))
    check(n_launch == {"K8": 4, "K9": 5}, f"pyramid launches {n_launch}")
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
        res[k] = dict(ms=timer(fn), plain_ms=timer(plain),
                      library_ms=None, bound=bnd)
        device_runs.append((k, "device_ms", fn, None))
        log(f"{k} {PYRAMID[k][0]}", shape=(h, w), levels=5,
            launches_a_window=n_launch[k], **res[k])
    log("pyramid blend", shape=(h, w),
        blend_ms=timer(lambda: cuda_blend.laplacian_blend(a, b, m, 5)),
        route_ms=timer(lambda: blend.laplacian_blend(a, b, m, 5), reps=3),
        equal_to_route=True)


# Each kernel's launch counter: its wrapper module under pano_tpu_torch.ops
# and the counter's name there.
COUNTERS = {"K1": ("cuda_harris", "launches"),
            "K1b": ("cuda_harris", "batched_launches"),
            "K2": ("cuda_gather", "launches"),
            "K3": ("cuda_match", "launches"),
            "K4a": ("cuda_warp", "launches"),
            "K4b": ("cuda_warp", "packed_launches"),
            "K4bb": ("cuda_warp", "batched_packed_launches"),
            "K5": ("cuda_compose", "launches"),
            "K6": ("cuda_compose", "chain_launches"),
            "K7": ("cuda_eigh", "launches"),
            "K8": ("cuda_blend", "reduce_launches"),
            "K9": ("cuda_blend", "collapse_launches"),
            "K10": ("cuda_ransac", "launches"),
            "K11": ("cuda_align", "launches")}
# The overlay pair's launches (stitch_pair_fast, default config).
PAIR_LAUNCHES = {"K1": 2, "K2": 2, "K3": 1, "K7": 1, "K10": 1, "K4a": 1}
# Phase 5's strip cases: case -> (mode, blend, gain, launches beside the
# estimates', the bar against the scene).
STRIP_CASES = {
    "chain_overlay": ("chain", "overlay", False, {"K4b": 3, "K6": 3}, 2),
    "chain_feather": ("chain", "feather", False, {"K4b": 3, "K6": 3}, 2),
    "chain_multiband": ("chain", "multiband", False,
                        {"K4b": 3, "K8": 12, "K9": 15}, 3),
    "chain_feather_gain": ("chain", "feather", True, {"K4b": 3}, 2),
    "auto": ("auto", "overlay", False, {"K1": 4, "K2": 4, "K3": 6, "K7": 6,
                                        "K10": 6, "K4b": 3, "K6": 3}, 2),
    "fold_total": ("fold", "overlay", False, {"K4a": 3}, None),
}


def launches(fn):
    """fn() with every launch counter zeroed just before: (its result,
    the launches of each kernel that ran)."""
    import importlib

    import torch

    mods = {k: (importlib.import_module(f"pano_tpu_torch.ops.{m}"), a)
            for k, (m, a) in COUNTERS.items()}
    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}
    return out, {k: n for k, n in counts.items() if n}


def blend_config(blend, gain=False):
    from pano_tpu_torch import DEFAULT_CONFIG

    return DEFAULT_CONFIG.replace(stitch=dataclasses.replace(
        DEFAULT_CONFIG.stitch, blend=blend, gain_compensation=gain))


def corner_err(h, shape, offset) -> float:
    """The largest distance (px) of H's image of an (h, w) image's corners
    from the corners moved by the planted (x, y) offset."""
    ih, iw = shape
    c = np.array([[0, 0], [iw, 0], [iw, ih], [0, ih]], np.float64)
    p = np.c_[c, np.ones(4)] @ np.asarray(h, np.float64).T
    return float(np.abs(p[:, :2] / p[:, 2:] - (c + offset)).max())


def overlap_err(pano, left) -> int:
    """Max |d| of the planted pair's overlap against the left image."""
    return int((pano[DY:H_IMG, DX:W_IMG].int()
                - left[DY:H_IMG, DX:W_IMG].int()).abs().max())


def scene_err(pano, imgs, offsets, anchor, anchor_at, scene_shape):
    """Per-pixel max |d| of a panorama against its images pasted at their
    planted (x, y) offsets (the anchor at `anchor_at`, (row, column); the
    others over it where not black, as overlay does), over the covered
    pixels less a 2 px band across each edge of the others (an estimate a
    hair short samples the edge pixel's dark sliver there)."""
    ih, iw = imgs[0].shape[:2]
    h, w = (min(a, b) for a, b in zip(pano.shape, scene_shape))
    want = np.zeros((h, w, 3), np.int16)
    covered = np.zeros((h, w), bool)
    band = np.zeros((h, w), bool)
    for i in [anchor] + [i for i in range(len(imgs)) if i != anchor]:
        y0, x0 = anchor_at if i == anchor else offsets[i][::-1]
        y1, x1 = min(y0 + ih, h), min(x0 + iw, w)
        src = imgs[i][:y1 - y0, :x1 - x0]
        keep = np.ones(src.shape[:2], bool) if i == anchor else src.any(-1)
        want[y0:y1, x0:x1][keep] = src[keep]
        covered[y0:y1, x0:x1] = True
        if i != anchor:
            ya, xa = max(y0 - 1, 0), max(x0 - 1, 0)
            for r in (y0, y0 + ih):
                band[max(r - 1, 0):r + 1, xa:x1 + 1] = True
            for c in (x0, x0 + iw):
                band[ya:y1 + 1, max(c - 1, 0):c + 1] = True
    d = np.abs(pano[:h, :w].astype(np.int16) - want).max(-1)
    return d[covered & ~band]


def pair_on_card(pair, blend="overlay", gain=False) -> dict:
    """Phase 5: stitch_pair_fast on the planted pair (card tensors), the
    graphed estimate: each kernel's launches, H within 0.5 px of the
    planted one at the corners, the planted canvas (+0..1), the overlap
    the left image within 1 (multiband 2, also on the planted H itself);
    overlay's second call equal."""
    import torch

    from pano_tpu_torch import PairStitcher
    from pano_tpu_torch.pipeline import fused_canvas_geometry

    left, right = pair
    st = PairStitcher(blend_config(blend, gain), print_timing=False,
                      device=DEVICE)
    pano, got = launches(lambda: st.stitch_pair_fast(left, right))
    compose = {} if blend == "overlay" else {"K4a": 0, "K4b": 1, "K5": 1}
    pyramid = {"K8": 4, "K9": 5} if blend == "multiband" else {}
    want = {k: n for k, n in {**PAIR_LAUNCHES, **compose, **pyramid}.items()
            if n}
    what = f"pair {blend}{' gain' if gain else ''}"
    check(got == want, f"{what}: launches {got}")
    check(pano.device.type == DEVICE and pano.dtype == torch.uint8,
          f"{what}: {pano.device} {pano.dtype}")
    est, shape = st.last_estimate, left.shape[:2]
    err = corner_err(est[:9].reshape(3, 3), shape, (DX, DY))
    check(err < 0.5, f"{what}: H corner error {err} px")
    geo = fused_canvas_geometry(est, shape, shape)
    check(tuple(pano.shape) == (geo.canvas_h, geo.canvas_w, 3)
          and all(0 <= a - b <= 1 for a, b in zip(
              pano.shape, (H_IMG + DY, W_IMG + DX))),
          f"{what}: canvas {tuple(pano.shape)}")
    bar = 2 if blend == "multiband" else 1
    d = overlap_err(pano, left)
    check(d <= bar, f"{what}: overlap max |d| {d}")
    if blend == "multiband":
        row = np.zeros(14, np.float32)
        row[:9] = translation(DX, DY).ravel()
        g = fused_canvas_geometry(row, shape, shape)
        exact = st._compose(left, right, g.m_inv, g.ty, g.tx, g.window,
                            g.canvas_h, g.canvas_w)
        d_exact = overlap_err(exact, left)
        check(d_exact <= bar, f"{what}: planted H's overlap max |d| {d_exact}")
    if blend == "overlay":
        check(torch.equal(st.stitch_pair_fast(left, right), pano),
              f"{what}: a second call differs")
    return dict(launches=got, corner_err_px=err, canvas=tuple(pano.shape),
                overlap_max_d=d)


def strip_on_card(strip, strip_dev, case) -> dict:
    """Phase 5: stitch_all_images on the planted strip (host images, card
    tensors) as STRIP_CASES[case] says (auto on the strip shuffled): its
    lines, each kernel's launches, the planted canvas (+0..1; the fold 2
    a step), each global within 0.5 px at its image's corners, the scene
    within the case's bar (multiband 3: the composed globals carry ~3x a
    pair's sub-pixel error onto sharp edges); overlay's repeat equal."""
    import contextlib
    import io
    import re

    from pano_tpu_torch import pipeline, stitch_all_images

    mode, blend, gain, extra, bar = STRIP_CASES[case]
    order = AUTO_ORDER if mode == "auto" else range(len(STRIP))
    imgs = [strip_dev[i] for i in order]
    host = [strip[i] for i in order]
    offsets = [STRIP[i] for i in order]
    n = len(imgs)
    seen = []
    composite_global = pipeline.composite_global

    def spy(images, devs, globals_h, config, anchor=0, _weights_out=None):
        seen.append((list(globals_h), anchor))
        return composite_global(images, devs, globals_h, config, anchor,
                                _weights_out)

    def call():
        with contextlib.redirect_stdout(out):
            return stitch_all_images(
                imgs, blend_config(blend, gain), device=DEVICE, mode=mode,
                timing="total" if mode == "fold" else "stages")

    out = io.StringIO()
    pipeline.composite_global = spy
    try:
        pano, got = launches(call)
    finally:
        pipeline.composite_global = composite_global
    lines = re.sub(r": \d+\.\d{3} ms", ": x ms", out.getvalue()).splitlines()
    check(got == {"K1": 6, "K2": 6, "K3": 3, "K7": 3, "K10": 3, **extra},
          f"{case}: launches {got}")
    check(isinstance(pano, np.ndarray) and pano.dtype == np.uint8,
          f"{case}: a {type(pano)}")
    steps = [f"Stitching image {i} of {n}..." for i in range(2, n + 1)]
    total = "Total Stitching Process: x ms"
    if mode == "chain":
        ok = lines == [*steps, total]
    elif mode == "fold":
        ok = lines == [*(x for step in steps
                         for x in (step, "Image Stitching: x ms")), total]
    else:
        placed = [x for x in lines if x.startswith("Auto-ordering")]
        ok = (len(placed) == 1 and placed[0].endswith(f"placed {n} of {n}")
              and lines[-1] == total)
    check(ok, f"{case}: printed lines {lines}")
    slack = 2 * (n - 1) if mode == "fold" else 1
    check(all(0 <= a - b <= slack
              for a, b in zip(pano.shape[:2], strip_shape())),
          f"{case}: canvas {pano.shape}")
    res = dict(launches=got, canvas=pano.shape)
    if mode == "fold":
        return res
    (gs, anchor), = seen
    check(all(g is not None for g in gs), f"{case}: an image not placed")
    ax, ay = offsets[anchor]
    res["global_err_px"] = max(
        corner_err(g, host[0].shape[:2], (x - ax, y - ay))
        for g, (x, y) in zip(gs, offsets))
    check(res["global_err_px"] < 0.5,
          f"{case}: global corner error {res['global_err_px']} px")
    t_mat, _, _ = pipeline.global_canvas_geometry(host, gs, anchor)
    anchor_at = (int(np.round(t_mat[1, 2])), int(np.round(t_mat[0, 2])))
    res["scene_max_d"] = int(scene_err(pano, host, offsets, anchor,
                                       anchor_at, strip_shape()).max())
    check(res["scene_max_d"] <= bar,
          f"{case}: scene max |d| {res['scene_max_d']}")
    if case == "chain_overlay":
        check(np.array_equal(call(), pano), f"{case}: a second call differs")
    return res


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

    import torch.nn.functional as F

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.ops import (
        cuda_compose, cuda_eigh, cuda_gather, cuda_harris, cuda_match,
        cuda_ransac, cuda_warp, harris, ransac,
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
    check(torch.equal(got, want), "K1 differs from the plain version")
    k1 = functools.partial(cuda_harris.harris_scores, left, hopts.k,
                           hopts.nms_thresh)
    res["K1"] = dict(
        ms=timer(k1), plain_ms=timer(lambda: cuda_harris.harris_scores_plain(
            left, hopts.k, hopts.nms_thresh)),
        library_ms=None,
        bound=bound(nbytes(left, got), H_IMG * W_IMG * DETECT_OPS_PER_PX),
    )
    device_runs.append(("K1", "device_ms", k1, None))
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
    k2 = functools.partial(cuda_gather.gather_patches, left, xy_l, kv_l, p)
    res["K2"] = dict(
        ms=timer(k2),
        plain_ms=timer(
            lambda: cuda_gather.gather_patches_plain(left, xy_l, kv_l, p)),
        library_ms=timer(lambda: torch.take(flat, take_idx)),
        # The patch bytes of the border-valid rows (the only pixels it
        # reads), the keypoints and their flags in, descriptors and border
        # flags out.
        bound=bound(n_bv * p * p * 3 + nbytes(xy_l, kv_l, got, bv_l), 0),
    )
    device_runs.append(("K2", "device_ms", k2, None))
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
    # Only p*p*3 = 75 of the 128 descriptor columns carry data (K2 writes
    # zeros in the rest); the product's work is over those 75, at the
    # int8 tensor-core rate. The f32 epilogue is per (query, train) pair.
    kq, kt = desc_r.shape[0], desc_l.shape[0]
    k3_mma = 2 * kq * kt * p * p * 3
    k3_epilogue = kq * kt * MATCH_EPILOGUE_OPS
    k3_bytes = nbytes(desc_r, bv_r, desc_l, bv_l, *got)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    k3 = functools.partial(cuda_match.match_cores, desc_r, bv_r, desc_l, bv_l)
    res["K3"] = dict(
        ms=timer(k3), plain_ms=timer(
            lambda: cuda_match.match_cores_plain(desc_r, bv_r, desc_l, bv_l)),
        library_ms=None,
        bound=bound(k3_bytes, k3_epilogue, more=((k3_mma, "int8"),)),
    )
    device_runs.append(("K3", "device_ms", k3, None))
    log("K3 match_streaming", kq=kq, kt=kt, d=desc_r.shape[1],
        product_ms=timer(lambda: torch.mm(desc_r, desc_l.T)),
        bound_int8_product_ms=k3_mma / PEAK_OPS_PER_S["int8"] * 1e3,
        bound_f32_epilogue_ms=k3_epilogue / PEAK_OPS_PER_S["f32"] * 1e3,
        bound_bytes_ms=k3_bytes / HBM_BYTES_PER_S * 1e3, **res["K3"])

    h_plant = translation(DX, DY)
    m_proj = np.array([[0.97, 0.02, 12.0], [-0.015, 1.02, 4.0],
                       [2e-5, -1e-5, 1.0]])
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
        check(torch.equal(got, want),
              f"K4a {tag} differs from the plain version")
        log(f"K4a {tag}", canvas=(geo.canvas_h, geo.canvas_w),
            window=geo.window)
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

            k4a = functools.partial(cuda_warp.warp_compose_overlay,
                                    *call_args)
            res["K4a"] = dict(
                ms=timer(k4a), plain_ms=timer(
                    lambda: cuda_warp.warp_compose_overlay_plain(*call_args)),
                library_ms=timer(grid_sample),
                bound=bound(nbytes(right, left, got),
                            win_px * WARP_OPS_PER_PX),
            )
            device_runs.append(("K4a", "device_ms", k4a, None))

        # K4b: the windowed warp, without and with the ramp alpha
        for has_alpha in (False, True):
            wargs = (right, geo.m_inv, geo.window, has_alpha)
            rgb, w = cuda_warp.warp_packed(*wargs)
            rgb_p, w_p = cuda_warp.warp_packed_plain(*wargs)
            check(torch.equal(rgb, rgb_p) and torch.equal(w, w_p),
                  f"K4b {tag} has_alpha={has_alpha} differs from the plain "
                  f"version")
            log(f"K4b {tag}", has_alpha=has_alpha, window=geo.window)
        if tag == "planted":
            k4b = functools.partial(cuda_warp.warp_packed, *wargs)
            res["K4b"] = dict(
                ms=timer(k4b),
                plain_ms=timer(lambda: cuda_warp.warp_packed_plain(*wargs)),
                library_ms=timer(grid_sample),
                bound=bound(nbytes(right, rgb, w),
                            win_px * (WARP_OPS_PER_PX + ALPHA_OPS_PER_PX)),
            )
            for field, fn in (
                    ("device_ms", k4b),
                    ("device_ms_no_alpha", functools.partial(
                        cuda_warp.warp_packed, *wargs[:3], False)),
                    ("device_ms_no_weight", functools.partial(
                        k4b, emit_weight=False))):
                device_runs.append(("K4b", field, fn, None))
            del sx, sy, grid, src

        # K5: compose the ramp-alpha window by overlay and by feather
        for blend in ("overlay", "feather"):
            cargs = (left, rgb, w, geo.ty, geo.tx, geo.window, geo.canvas_h,
                     geo.canvas_w, blend)
            got = cuda_compose.compose_canvas(*cargs)
            want = cuda_compose.compose_canvas_plain(*cargs)
            check(torch.equal(got, want),
                  f"K5 {tag} {blend} differs from the plain version")
            log(f"K5 {tag}", blend=blend, canvas=(geo.canvas_h, geo.canvas_w))
            k5 = functools.partial(cuda_compose.compose_canvas, *cargs)
            if tag == "planted" and blend == "overlay":
                device_runs.append(("K5", "device_ms_overlay", k5, None))
        if tag == "planted":  # the feather compose
            res["K5"] = dict(
                ms=timer(k5), plain_ms=timer(
                    lambda: cuda_compose.compose_canvas_plain(*cargs)),
                library_ms=None,
                bound=bound(nbytes(left, rgb, w, got),
                            win_px * FEATHER_OPS_PER_PX),
            )
            device_runs.append(("K5", "device_ms", k5, None))
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
            check(torch.equal(work[0], ref[0]) and torch.equal(work[1], ref[1]),
                  f"K6 {tag} {blend} differs from the plain version")
            log(f"K6 {tag}", blend=blend, canvas=(sh, sw), window=window)
            k6 = functools.partial(cuda_compose.compose_chain_canvas, *work,
                                   *cargs)
            if tag == "planted" and blend == "overlay":
                device_runs.append(("K6", "device_ms_overlay", k6,
                                    functools.partial(prime, work)))
        if tag == "planted":  # the feather step
            res["K6"] = dict(
                ms=timer(k6, setup=lambda: prime(work)),
                plain_ms=timer(lambda: cuda_compose.compose_chain_canvas_plain(
                    *ref, *cargs), setup=lambda: prime(ref)),
                library_ms=None,
                # Canvas pixel and weight read and written, the window's
                # pixel and weight read: 3 + 3 + 4 + 4 + 3 + 4 bytes.
                bound=bound(win_px * 21, win_px * CHAIN_OPS_PER_PX),
            )
            device_runs.append(("K6", "device_ms", k6,
                                functools.partial(prime, work)))
    for k in ("K4a", "K4b", "K5", "K6"):
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
        _, match_pts = PairStitcher(
            DEFAULT_CONFIG, print_timing=False, device=DEVICE,
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
        ms=timer(lambda: cuda_eigh.smallest_eigvec9(ata)),
        plain_ms=timer(lambda: cuda_eigh.smallest_eigvec9_plain(ata)),
        library_ms=timer(lambda: torch.linalg.eigh(ata)),
        # The matrix in, the vector out; the f64 rotations its data needs.
        bound=bound(nbytes(ata, got), EIGVEC_OPS, "f64"),
    )
    device_runs.append(("K7", "device_ms", functools.partial(
        cuda_eigh.smallest_eigvec9, ata), None))
    log("K7 smallest_eigvec9", shape=tuple(ata.shape),
        sweeps=cuda_eigh.SWEEPS, one_minus_cos_vs_f64=align, **res["K7"])
    del ata_seen, got, want

    # K10: the hypothesis search on the planted pair's match points and the
    # default table, as the estimate hands them over.
    pq, pt, valid = match_pts
    idx = table(valid.sum(dtype=torch.int32))
    thresh = r_opts.distance_threshold
    got = cuda_ransac.search(pq, pt, valid, idx, thresh)
    want = cuda_ransac.search_plain(pq, pt, valid, idx, thresh)
    for name, a, b in zip(("hs", "counts", "best_h", "best_count"), got, want):
        check(equal_nan(a, b), f"K10 {name} differs from the plain version")
    n_valid, n_hyp = int(valid.sum()), idx.shape[0]
    k10 = functools.partial(cuda_ransac.search, pq, pt, valid, idx, thresh)
    res["K10"] = dict(
        ms=timer(k10),
        plain_ms=timer(lambda: cuda_ransac.search_plain(pq, pt, valid, idx,
                                                        thresh)),
        library_ms=None,
        # Points, flags and the table in, the hypotheses and counts out; the
        # DLTs and the scores of the valid matches.
        bound=bound(nbytes(pq, pt, valid, idx, *got),
                    n_hyp * (K10_DLT_OPS + K10_SCORE_OPS * n_valid)),
    )
    device_runs.append(("K10", "device_ms", k10, None))
    log("K10 ransac_search", hypotheses=n_hyp, matches=pq.shape[0],
        valid=n_valid, best_count=int(got[3]), **res["K10"])
    del got, want, match_pts

    align_row(torch, timer, res, device_runs)
    pyramid_rows(torch, timer, res, device_runs)
    batched_rows(torch, timer, res, device_runs, strip, strip_np)

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

    # 5. the main paths on the planted data, each kernel's launches counted
    for blend in ("overlay", "multiband"):
        log(f"pair {blend}", **pair_on_card((left, right), blend))
    for case in ("chain_multiband", "auto", "fold_total"):
        log(case, **strip_on_card(strip_np, strip, case))

    # The record lines
    names = {**KERNELS, **BATCHED, **PYRAMID, **ALIGN}
    print(json.dumps({"card": smi, "kernels": [
        {"name": names[k][0], "route": "cuda",
         "source": f"pano_tpu_torch/csrc/{names[k][1]}",
         "replaces": f"pano_tpu/ops/{names[k][2]}" if names[k][2]
         else "none (the port's direct alignment)" if k in ALIGN
         else "none (pano_tpu/ops/blend.py, XLA)",
         # every output torch.equal to the plain version's but K11's,
         # whose float64 sums run in another order
         "max_abs_err": res[k].get("max_abs_err", 0.0),
         "ms": res[k]["ms"], "device_ms": res[k]["device_ms"],
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
