"""The hand-written kernels' share of their roofline: the sum of the
least times of the steps that have one (detect scores, describe, match,
warp and compose, the refine's eigenvector; ``roofline.py``), over the
device time of their kernels (``kernel_steps.json``), in the window."""

from pano_bench import roofline


def read(t):
    return roofline.roofline_pct(t.work, t.step_kernel_us())
