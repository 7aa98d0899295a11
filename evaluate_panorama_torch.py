#!/usr/bin/env python3
"""Panorama quality evaluator of the PyTorch port — the interface of
evaluate_panorama.py (usage: evaluate_panorama_torch.py <baseline> <test>
[--threshold px]), over pano_tpu_torch.eval and pano_tpu_torch.io. The
metrics need OpenCV (ORB, findHomography)."""

import argparse

from pano_tpu_torch.eval import compute_metrics, evaluate_quality
from pano_tpu_torch.io import imread_bgr


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("baseline", help="Baseline panorama image")
    parser.add_argument("test", help="Test panorama image")
    parser.add_argument(
        "--threshold",
        type=float,
        default=3.0,
        help="RANSAC reproj threshold in pixels",
    )
    args = parser.parse_args()

    img1 = imread_bgr(args.baseline)
    img2 = imread_bgr(args.test)
    if img1 is None or img2 is None:
        raise RuntimeError("Failed to load images")

    metrics = compute_metrics(img1, img2, reproj_threshold=args.threshold)
    evaluate_quality(metrics)


if __name__ == "__main__":
    main()
