"""pano_tpu_torch as a library — embed the stitcher in your own Python
process, on an NVIDIA GPU.

The port's CLI (`python -m pano_tpu_torch.cli ...`) is a thin wrapper over
the same calls shown here; embedding skips per-process startup (importing
PyTorch, the CUDA context, loading the kernel library), which is the
serving model — see `python -m pano_tpu_torch.cli serve`.

Reference analog: linking against the reference's stitcher objects instead
of exec'ing its mains (src/serial/main.cpp:395-414 stitchAllImages).

Run:  python examples/library_quickstart_torch.py IMG1 IMG2 [IMG3 ...] --out pano.ppm
      python examples/library_quickstart_torch.py      # synthetic smoke demo

Everything runs on the CUDA device; PANO_CPU=1 runs it on the CPU instead
(each kernel's plain PyTorch version). Without cv2 and Pillow, read and
write binary PPM (.ppm).
"""

import os
import sys

import numpy as np

# Allow running straight from a checkout:
# python examples/library_quickstart_torch.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher, stitch_all_images
from pano_tpu_torch.io import imread_bgr, imwrite_bgr

DEVICE = "cpu" if os.environ.get("PANO_CPU") else "cuda"


def stitch_files(paths, out_path):
    """Production path: multiband chain stitch, single-sync pair estimates."""
    images = [imread_bgr(p) for p in paths]
    for p, img in zip(paths, images):
        if img is None:
            raise SystemExit(f"could not read {p}")

    # dataclasses.replace works on every config level; every CLI flag maps
    # to one of these fields (see pano_tpu_torch/config.py).
    import dataclasses

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        stitch=dataclasses.replace(DEFAULT_CONFIG.stitch, blend="multiband"),
    )

    pano = stitch_all_images(
        images,
        config=config,
        print_timing=True,
        device=DEVICE,
        mode="chain",      # detect once per source image, composite globally
        timing="total",
    )
    if pano is None:
        raise SystemExit("stitching failed")
    if not imwrite_bgr(out_path, pano):
        raise SystemExit(f"could not write {out_path}")
    print(f"wrote {out_path}  ({pano.shape[1]}x{pano.shape[0]})")


def synthetic_demo():
    """No-dataset smoke: stitch two overlapping crops of a random scene.

    Uses the PairStitcher API directly — the per-stage entry points
    (detect / match / ransac / composite) are public too, for callers that
    want the intermediates rather than the panorama.
    """
    rng = np.random.default_rng(0)
    scene = rng.integers(0, 255, (480, 960, 3), np.uint8)
    # Blur a little so Harris finds stable corners on structure, not noise.
    scene = (
        scene.astype(np.float32) * 0.25
        + np.roll(scene, 1, 1).astype(np.float32) * 0.75
    ).astype(np.uint8)
    left, right = scene[:, :640], scene[:, 320:]

    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False, device=DEVICE)
    pano = stitcher.stitch_pair_fast(left, right)  # a tensor on DEVICE
    if pano is None:
        raise SystemExit("synthetic stitch failed")
    pano = pano.cpu().numpy()
    print(f"synthetic demo ok: {left.shape} + {right.shape} -> {pano.shape}"
          f" on {DEVICE}")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "images", nargs="*", help="two or more image files (none: synthetic demo)"
    )
    parser.add_argument("--out", default="panorama.ppm", help="output file")
    ns = parser.parse_args()
    if len(ns.images) >= 2:
        stitch_files(ns.images, ns.out)
    elif len(ns.images) == 1:
        # One path is almost always a typo'd second path — fail loudly
        # instead of silently running the synthetic demo.
        parser.error("need at least two images (or none for the synthetic demo)")
    else:
        synthetic_demo()
