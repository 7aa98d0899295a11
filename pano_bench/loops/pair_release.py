"""pair_release: ``drivers.pair_serial`` for a caller that writes each
panorama out before asking for the next. One caller, one pair at a time
through ``PairStitcher.stitch_pair_fast``, the panorama synchronized on
the card; once it is answered (and its sample copied, where the sample
wants it) the caller drops it, so that no panorama is held through the
next call. The window's peak memory is then the pool and the largest
single pair's working set, whatever order the seed gives the pool.

``SPANS`` puts the alignment's entry (``ops/align.py``) under the layer
``align``. In the traced run each panorama also leaves a span of no work,
``align.least_us=<us>``: the least time of the alignment's passes for
that pair on an H100, from its planted geometry and the configuration's
iterations (``align_roofline.py``), which ``align.roofline_pct`` sums.
"""

from __future__ import annotations

import time

from pano_bench import align_roofline, drivers, reference, scenes

SPANS = [
    {"target": "pano_tpu_torch.ops.align:align_homography",
     "layer": "align"},
]
LEAST = "align.least_us="


def make(run: drivers.Run):
    from pano_tpu_torch.pipeline import PairStitcher

    st = PairStitcher(run.config, print_timing=False, device=run.devices[0])
    p = len(run.pool)
    iterations = run.config.ransac.align_iterations
    least_us = []
    for scene in run.pool:
        left_hw, right_hw = reference.shapes(scene.images)
        g = scenes.planted_globals(scene)[1]
        least_us.append(1e6 * align_roofline.pair_seconds(
            right_hw, left_hw, g, iterations + 1) if iterations else 0.0)

    def loop(stop: drivers.Stop, sample: drivers.Sample):
        out, i = [], 0
        while not stop(i):
            k = i % p
            t0 = time.perf_counter()
            with run.span("orchestration"):
                pano = st.stitch_pair_fast(*run.pool[k].images)
            drivers._ready(pano)
            t1 = time.perf_counter()
            out.append(drivers._answer(k, i // p, pano,
                                       drivers._pair_placed(st.last_estimate),
                                       sample, t0, t1))
            del pano
            if least_us[k]:
                with run.span(f"{LEAST}{least_us[k]!r}"):
                    pass
            i += 1
        return out
    return loop
