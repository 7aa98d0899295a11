"""The port's scripts beside the pre-port ones, each run as a user runs
it: examples/library_quickstart_torch.py (its synthetic demo on the CPU)
and evaluate_panorama_torch.py (an image against itself, and the same
report as evaluate_panorama.py)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=REPO, **kw)


def test_library_quickstart_torch_synthetic_demo():
    out = _run([os.path.join(REPO, "examples", "library_quickstart_torch.py")],
               env=dict(os.environ, PANO_CPU="1"), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    m = re.search(r"synthetic demo ok: .* -> \((\d+), (\d+), 3\) on cpu",
                  out.stdout)
    assert m, out.stdout
    # The scene at its true extent (the canvas is the ceil of the warped
    # extent, so f32 noise in the estimate can add a row or column).
    h, w = int(m.group(1)), int(m.group(2))
    assert abs(h - 480) <= 2 and abs(w - 960) <= 2, (h, w)


def test_library_quickstart_torch_single_image_errors(tmp_path):
    out = _run([os.path.join(REPO, "examples", "library_quickstart_torch.py"),
                str(tmp_path / "only_one.ppm"), "--out",
                str(tmp_path / "p.ppm")],
               env=dict(os.environ, PANO_CPU="1"), timeout=300)
    assert out.returncode != 0
    assert "at least two images" in out.stderr
    assert "synthetic demo ok" not in out.stdout


def test_evaluate_panorama_torch_self_comparison(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = np.full((200, 300, 3), 40, np.uint8)
    r = np.random.default_rng(0)
    for _ in range(120):
        y, x = r.integers(10, 180), r.integers(10, 280)
        cv2.circle(img, (int(x), int(y)), int(r.integers(3, 9)),
                   tuple(int(c) for c in r.integers(50, 255, 3)), -1)
    p = str(tmp_path / "pano.ppm")
    cv2.imwrite(p, img)
    out = _run(["evaluate_panorama_torch.py", p, p], timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Overall stitching quality: Good" in out.stdout
    ref = _run(["evaluate_panorama.py", p, p], timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert out.stdout == ref.stdout
