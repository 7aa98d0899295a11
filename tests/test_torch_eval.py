"""pano_tpu_torch.eval against pano_tpu.eval: the same metrics, grades and
printed report on the same seeded images (both are host code: numpy and
OpenCV)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from pano_tpu import eval as jeval
from pano_tpu_torch import eval as teval


def _scene(seed, h=200, w=300):
    """Filled circles on a flat ground (tests/test_eval.py's scene)."""
    img = np.full((h, w, 3), 40, np.uint8)
    r = np.random.default_rng(seed)
    for _ in range(120):
        y, x = r.integers(10, h - 20), r.integers(10, w - 20)
        cv2.circle(img, (int(x), int(y)), int(r.integers(3, 9)),
                   tuple(int(c) for c in r.integers(50, 255, 3)), -1)
    return img


def _pair(kind):
    img = _scene(0)
    r = np.random.default_rng(1)
    if kind == "self":
        return img, img.copy()
    if kind == "noisy":
        return img, (img.astype(np.int32)
                     + r.integers(-60, 60, img.shape)).clip(0, 255).astype(
                         np.uint8)
    if kind == "warped":  # a mild projective re-rendering
        h = np.array([[0.98, 0.02, 5.0], [-0.02, 1.01, 3.0],
                      [5e-5, -3e-5, 1.0]])
        return cv2.warpPerspective(img, h, (300, 200)), img
    if kind == "shifted":
        return img, np.roll(img, (3, 7), axis=(0, 1))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["self", "noisy", "warped", "shifted"])
def test_compute_metrics_equal_to_jax(kind, capsys):
    a, b = _pair(kind)
    want = jeval.compute_metrics(a, b)
    got = teval.compute_metrics(a, b)
    assert got == want
    assert teval.grade(got) == jeval.grade(want)
    assert teval.seam_frame_caveat(got) == jeval.seam_frame_caveat(want)
    assert teval.evaluate_quality(got) == jeval.evaluate_quality(want)
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "Overall stitching quality" in out
    if kind == "self":
        assert teval.grade(got)[1] == "Good"


GRADED = [
    {"PSNR": 40.0, "SSIM": 0.95, "Inlier Ratio": 0.9,
     "Reprojection Error": 0.5, "Seam Smoothness": 5.0},
    {"PSNR": 30.0, "SSIM": 0.85, "Inlier Ratio": 0.6,
     "Reprojection Error": 2.0, "Seam Smoothness": 20.0},
    {"PSNR": 10.0, "SSIM": 0.5, "Inlier Ratio": 0.3,
     "Reprojection Error": 4.0, "Seam Smoothness": 40.0},
    # The seam caveat's pattern: good alignment, poor seam.
    {"PSNR": 31.0, "SSIM": 0.95, "Inlier Ratio": 0.80,
     "Reprojection Error": 0.9, "Seam Smoothness": 56.0},
    # Exactly on every threshold.
    {"PSNR": 35, "SSIM": 0.90, "Inlier Ratio": 0.70,
     "Reprojection Error": 1.0, "Seam Smoothness": 10},
    {"PSNR": 25, "SSIM": 0.80, "Inlier Ratio": 0.50,
     "Reprojection Error": 3.0, "Seam Smoothness": 30},
]


@pytest.mark.parametrize("i", range(len(GRADED)))
def test_grade_and_report_equal_to_jax(i, capsys):
    m = GRADED[i]
    assert teval.grade(m) == jeval.grade(m)
    assert teval.seam_frame_caveat(m) == jeval.seam_frame_caveat(m)
    v_t = teval.evaluate_quality(m)
    out_t = capsys.readouterr().out
    v_j = jeval.evaluate_quality(m)
    assert (v_t, out_t) == (v_j, capsys.readouterr().out)
    assert teval.GUIDELINES == jeval.GUIDELINES


def test_ssim_equal_to_jax():
    r = np.random.default_rng(4)
    a = r.integers(0, 256, (40, 48, 3)).astype(np.float64)
    b = np.clip(a + r.normal(0, 12, a.shape), 0, 255)
    np.testing.assert_array_equal(teval.ssim_map(a[..., 0], b[..., 0]),
                                  jeval.ssim_map(a[..., 0], b[..., 0]))
    mask = np.zeros((40, 48), bool)
    mask[6:30, 5:40] = True
    assert teval.masked_ssim(a, b, mask) == jeval.masked_ssim(a, b, mask)
