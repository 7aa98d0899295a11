"""auto_serial: one caller, one panorama at a time through
``pipeline.stitch_all_images(mode="auto")``, host numpy in and out, as
``chain_serial`` drives the chain.

Auto mode takes an unordered set: it detects each image once, estimates
every pair, frames the images by a maximum spanning tree over the pairs
that pass the inlier gate, rooted at the best-connected image, refines
the frames where the graph has cycles (``bundle_adjust``), and
composites them in the root's frame. Its traffic files say
``"pairs": "all"``: n(n - 1)/2 estimates a panorama.

``capture`` records what ``composite_global`` is handed: the frames in
the root's frame and the root (its ``anchor``), converted into image 0's
frame for the answer, which carries the root as its anchor.
"""

from __future__ import annotations

import time

from pano_bench import drivers
from pano_bench.trace import wrapped

# Auto mode computes the descriptors in its detect pass and matches them
# with match_descriptors; the pair and the chain do both inside
# match_keypoints. These put them under the match layer.
SPANS = [
    {"target": "pano_tpu_torch.ops.match:extract_patch_descriptors",
     "layer": "match"},
    {"target": "pano_tpu_torch.ops.match:match_descriptors",
     "layer": "match"},
]


def make(run: drivers.Run):
    from pano_tpu_torch import pipeline

    p = len(run.pool)
    dev = run.devices[0]

    def loop(stop: drivers.Stop, sample: drivers.Sample):
        out, i = [], 0
        while not stop(i):
            k = i % p
            run.placed.clear()
            t0 = time.perf_counter()
            with run.span("orchestration"):
                pano = pipeline.stitch_all_images(
                    run.pool[k].images, run.config, False, "", dev,
                    mode="auto")
            t1 = time.perf_counter()
            placed, anchor = run.placed[-1] if run.placed else (None, 0)
            out.append(drivers._answer(k, i // p, pano, placed, sample, t0,
                                       t1, anchor))
            i += 1
        return out
    return loop


def capture(run: drivers.Run):
    """composite_global(images, devs, globals_h, config, anchor=root):
    the placements in image 0's frame, and the root."""
    def make_call(real):
        def call(images, devs, globals_h, config, anchor=0, *args,
                 **kwargs):
            run.placed.append((drivers.in_image0_frame(globals_h), anchor))
            return real(images, devs, globals_h, config, anchor, *args,
                        **kwargs)
        return call
    return wrapped([("pano_tpu_torch.pipeline:composite_global", make_call)])
