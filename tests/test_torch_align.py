"""The direct alignment of a pair's homography (``ops/align.py``) on the
CPU, where K11 (``ops/cuda_align.py``) runs its plain version: against a
plain float64 reference (``align_reference.py``) on a rotating camera's
pairs (``pano_bench/scene_models/rotating.py``, the ``rotate_serial``
poses at 320x256), what it does for RANSAC's estimate there, the whole
pair against the benchmark's plain reference within the configuration's
limits, the guard, the host, and the option off."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from align_reference import align_reference
from compose_reference import compose_max_d
from pano_bench import drivers
from pano_bench import reference as bench_ref
from pano_bench import scenes
from pano_bench.run import merged, pano_config
from pano_bench.spec import Spec
from pano_tpu_torch import pipeline
from pano_tpu_torch.config import RansacOptions
from pano_tpu_torch.ops import align, cuda_align

SPEC = Spec()
SEED = 2 ** 31 + 977
H_IMG, W_IMG = 256, 320
ITERATIONS = SPEC.config("rotating_pair_4k")["pano_config"]["ransac"][
    "align_iterations"]
# The port's alignment against the float64 reference, at image 1's
# corners: its per-pixel terms are float32 (coordinates to ~1e-5 px,
# residuals and Jacobians to ~1e-7 relative) and its H is float32, which
# moved the far corners by at most 1.2e-3 px on these scenes; the
# alignment itself moves them by 0.13-16 px.
REF_TOL_PX = 5e-3
# The stitch's panorama against the one drawn with its own H on its
# whole-pixel frame (compose_reference.py): both sample bilinearly from
# float32 coordinates and round, which read at most 1 on each scene.
COMPOSE_TOL = 2


@functools.lru_cache(maxsize=None)
def rotating_pairs():
    """The rotating configuration at 320x256 (K 1024, 1000 hypotheses):
    its pool of the rotate_serial poses from SEED, and per scene RANSAC's
    H without the alignment and the pair's answer with it."""
    cfg = merged(SPEC.config("rotating_pair_4k"), {
        "image_h": H_IMG, "image_w": W_IMG,
        "pano_config": {"harris": {"max_keypoints": 1024},
                        "ransac": {"num_iterations": 1000}}})
    pool = SPEC.pool(SPEC.traffic("rotate_serial"), cfg, SEED,
                     torch.device("cpu"))
    aligned = pano_config(cfg["pano_config"])
    assert aligned.ransac.align_iterations == ITERATIONS > 0
    plain = aligned.replace(ransac=dataclasses.replace(aligned.ransac,
                                                       align_iterations=0))
    st_plain = pipeline.PairStitcher(plain, print_timing=False, device="cpu")
    st = pipeline.PairStitcher(aligned, print_timing=False, device="cpu")
    out = []
    for k, scene in enumerate(pool):
        st_plain.stitch_pair_fast(*scene.images)
        h_ransac = torch.from_numpy(st_plain.last_estimate[:9].copy())
        pano = st.stitch_pair_fast(*scene.images)
        answer = drivers._answer(k, 0, pano, drivers._pair_placed(
            st.last_estimate), drivers.Sample({k: 0}, {k: pano.numel()},
                                              False), 0.0, 0.0)
        out.append((h_ransac.reshape(3, 3), answer))
    return pool, out


def _err(h, scene) -> float:
    """The farthest of image 1's corners from its planted place (px)."""
    return bench_ref.corner_error(np.asarray(h, np.float64),
                                  scenes.planted_globals(scene)[1], H_IMG,
                                  W_IMG)


@pytest.mark.parametrize("k", range(8))
def test_alignment_matches_the_float64_reference(k):
    pool, pairs = rotating_pairs()
    left, right = pool[k].images
    h = pairs[k][0]
    got = align.align_homography(h, left, right, ITERATIONS)
    want = align_reference(h.double().numpy(), left, right, ITERATIONS)
    assert got.dtype == torch.float32
    assert bench_ref.corner_error(got.double().numpy(), want, H_IMG,
                                  W_IMG) <= REF_TOL_PX


@pytest.mark.parametrize("k", range(8))
def test_alignment_brings_the_far_corners_closer_than_ransac(k):
    """At image 1's corners, outside the overlap, RANSAC's H from whole
    pixel corners reads 0.66-16.6 px off here; the aligned one is closer
    on every scene."""
    pool, pairs = rotating_pairs()
    h, answer = pairs[k]
    assert _err(answer["placed"][1], pool[k]) < _err(h, pool[k])


@pytest.mark.parametrize("k", range(8))
def test_pair_within_the_configurations_limits(k):
    """The aligned pair's answer (placement and panorama) against the
    benchmark's plain reference with limits/rotating_pair_4k.json."""
    pool, pairs = rotating_pairs()
    judged = bench_ref.judge([pairs[k][1]], pool,
                             SPEC.limits("rotating_pair_4k"))
    assert judged["failed"] == 0, judged["compared"]
    assert bench_ref.within(judged["compared"]), judged["compared"]


@pytest.mark.parametrize("k", range(8))
def test_compose_matches_the_whole_pixel_reference(k):
    """The aligned pair's panorama against the reference drawn with the
    stitch's own H on the stitch's whole-pixel frame: the same canvas,
    and every channel within COMPOSE_TOL outside the border band. The
    benchmark's reference draws the planted H at the union's fractional
    top-left, where a perspective pair's pixels part by up to 254, so
    the compose of a quadrilateral footprint is held here."""
    pool, pairs = rotating_pairs()
    answer = pairs[k][1]
    canvas_px, pixel = compose_max_d(answer["pano"], *pool[k].images,
                                     answer["placed"][1])
    assert canvas_px == 0
    assert pixel <= COMPOSE_TOL


@pytest.mark.parametrize("path", ["staged", "auto", "finalize"])
def test_option_refused_where_nothing_aligns(path):
    """Only the fused estimate hands the images over. With the option
    on, the staged estimate, auto mode and the search's finalize without
    images (the hypothesis-sharded search's) raise instead of leaving H
    unaligned."""
    pool, _ = rotating_pairs()
    left, right = pool[0].images
    cfg = pano_config({"harris": {"max_keypoints": 1024},
                       "ransac": {"num_iterations": 1000,
                                  "align_iterations": ITERATIONS}})
    with pytest.raises(ValueError, match="align_iterations"):
        if path == "staged":
            pipeline.PairStitcher(cfg, print_timing=True, device="cpu"
                                  ).estimate_homography(left, right)
        elif path == "auto":
            pipeline.stitch_all_images_auto([left, right], cfg,
                                            print_timing=False, device="cpu")
        else:
            pts = torch.zeros((8, 2))
            pipeline.ransac_ops.finalize_ransac(
                torch.eye(3), torch.tensor(0), pts, pts,
                torch.ones(8, dtype=torch.bool), cfg.ransac)


def _translated_pair():
    """A translated 320x256 pair of the crops model (the right image 83
    px along, 5 down) and a small configuration."""
    pool = scenes.make_pool([[[0, 0], [83, 5]]], H_IMG, W_IMG, SEED, "cpu",
                            "device")
    cfg = pano_config({"harris": {"max_keypoints": 1024},
                       "ransac": {"num_iterations": 1000}})
    return cfg, pool[0].images


@pytest.mark.parametrize("option", ["off", "on"])
def test_alignment_option(monkeypatch, option):
    """Off (the default), on the translated pair: the alignment never
    runs and the estimate row is the refined estimate's, bit for bit. On,
    on a rotating pair: it runs once with the configured iterations, and
    only the row's H moves; the counts and the gate stay the matches'."""
    if option == "off":
        cfg, (left, right) = _translated_pair()
        assert cfg.ransac.align_iterations == 0
    else:
        pool, _ = rotating_pairs()
        left, right = pool[0].images
        cfg = pano_config({"harris": {"max_keypoints": 1024},
                           "ransac": {"num_iterations": 1000}})
    kps = [pipeline.harris_ops.harris_detect(img, cfg.harris)
           for img in (left, right)]
    base, _ = pipeline.estimate_row(*kps, left, right, cfg)
    real = align.align_homography
    calls = []

    def spy(*args):
        calls.append(args[-1])
        return real(*args)
    monkeypatch.setattr(align, "align_homography", spy)
    if option == "on":
        cfg = cfg.replace(ransac=dataclasses.replace(
            cfg.ransac, align_iterations=ITERATIONS))
    row, _ = pipeline.estimate_row(*kps, left, right, cfg)
    if option == "off":
        assert calls == [] and torch.equal(row, base)
    else:
        assert calls == [ITERATIONS]
        assert torch.equal(row[9:], base[9:])
        assert _err(row[:9].reshape(3, 3), pool[0]) \
            < _err(base[:9].reshape(3, 3), pool[0])


@pytest.mark.parametrize("case", ["flat", "no_overlap"])
def test_guard_keeps_the_given_homography(case):
    """Flat images give a singular system; an H that places the right
    image beside the left one leaves no overlap to measure. Either way
    the given H comes back unchanged."""
    cfg, (left, right) = _translated_pair()
    h = torch.tensor([[1.0, 0.0, 83.0], [0.0, 1.0, 5.0], [0.0, 0.0, 1.0]])
    if case == "flat":
        left = torch.full_like(left, 128)
        right = torch.full_like(right, 128)
    else:
        h[0, 2] = 400.0
    fr = cuda_align.frame(left.shape[:2], right.shape[:2])
    state = cuda_align.gauss_newton(align.to_normalized(h, fr), left, right,
                                    ITERATIONS, fr)
    assert float(state[cuda_align.SINGULAR]) == 1.0
    assert torch.equal(align.align_homography(h, left, right, ITERATIONS), h)


class _HostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every operation that reads a tensor's value on the host."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "_local_scalar_dense" in str(func):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["align", "fused_estimate"])
def test_alignment_reads_nothing_on_the_host(path):
    """On the card nothing of the step may wait: on the CPU, no value of
    the alignment, alone or in the aligned fused estimate, is read on the
    host (an .item(), a bool() or a 0-d index)."""
    pool, pairs = rotating_pairs()
    left, right = pool[0].images
    if path == "align":
        def fn():
            return align.align_homography(pairs[0][0], left, right,
                                          ITERATIONS)
    else:
        cfg = pano_config(SPEC.config("rotating_pair_4k")["pano_config"])
        cfg = cfg.replace(harris=dataclasses.replace(cfg.harris,
                                                     max_keypoints=1024),
                          ransac=dataclasses.replace(cfg.ransac,
                                                     num_iterations=1000))
        st = pipeline.PairStitcher(cfg, print_timing=False, device="cpu")

        def fn():
            return st._fused_estimate_impl(left, right)[0]
    with _HostReads() as spy:
        out = fn()
    assert spy.seen == []
    assert bool(torch.isfinite(out).all())


def test_normalized_parameters_round_trip():
    """to_normalized and from_normalized are inverses, and the normalized
    parameters map the normalized right frame into the normalized left."""
    fr = cuda_align.frame((256, 320), (240, 300))
    h = torch.tensor([[0.9, 0.05, 120.0], [-0.02, 1.01, 7.0],
                      [1e-4, -2e-5, 1.0]], dtype=torch.float64)
    p = align.to_normalized(h, fr)
    assert torch.allclose(align.from_normalized(p, fr), h, rtol=1e-12,
                          atol=1e-10)
    u, v = 17.0, 200.0
    x = h @ torch.tensor([u, v, 1.0], dtype=torch.float64)
    n = torch.cat([p, torch.ones(1, dtype=torch.float64)]).reshape(3, 3)
    q = n @ torch.tensor([(u - fr.cxr) / fr.s, (v - fr.cyr) / fr.s, 1.0],
                         dtype=torch.float64)
    got = q[:2] / q[2] * fr.s + torch.tensor([fr.cxl, fr.cyl],
                                             dtype=torch.float64)
    assert torch.allclose(got, x[:2] / x[2], atol=1e-9)


@pytest.mark.parametrize("bad", ["float_image", "gray_image", "iterations"])
def test_gauss_newton_refuses_bad_inputs(bad):
    img = torch.zeros((8, 9, 3), dtype=torch.uint8)
    p0 = torch.zeros(8, dtype=torch.float64)
    iterations = 0 if bad == "iterations" else 1
    other = {"float_image": img.float(), "gray_image": img[..., 0]}.get(
        bad, img)
    fr = cuda_align.frame((8, 9), (8, 9))
    with pytest.raises(ValueError):
        cuda_align.gauss_newton(p0, img, other, iterations, fr)
    with pytest.raises(ValueError, match="align_iterations"):
        RansacOptions(align_iterations=-1)
