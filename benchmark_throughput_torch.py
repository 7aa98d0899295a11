#!/usr/bin/env python3
"""Pipelined throughput benchmark of the PyTorch + CUDA port: pairs/s with
DEPTH pairs in flight, the serving counterpart of bench_torch.py's
single-pair latency.

Counterpart of benchmark_throughput.py (which stays the JAX package's),
with its flags and its JSON line. The loop (`pipelined`) runs the library's
own halves of `PairStitcher.stitch_pair_fast` (pano_tpu_torch/pipeline.py):
`dispatch` enqueues a pair's fused estimate and the copy of its 14-float
row into pinned host memory, and records an event; `retire` waits on
that event, computes the canvas geometry on the host, enqueues the
composite at the exact canvas and returns the panorama. The host keeps
DEPTH dispatched pairs and retires the oldest, so the row's copy and the
host's geometry overlap newer pairs' device work. Nothing inside an
estimate waits for the card (RANSAC's refine takes kernel K7, not
`torch.linalg.eigh`): `host_syncs_per_pair` counts 0, so a pair's only
wait is retire's on the row's event. Pairs whose estimate is below the
inlier gate take the fallback ladder inside `retire`; they are counted
and excluded from the rate.

The timed block ends with `torch.cuda.synchronize`, so the last pair's
composite is inside it.

Usage: python benchmark_throughput_torch.py [--pairs N] [--depth D] [--cpu]
           [left right]
Prints one JSON line: {"metric": "mountain_4k_throughput_pairs_per_s",
"value", "unit", "ms_per_pair", "depth", "fallback_pairs"}. The images
default to the mountain pair under images/mountain/ of the checkout;
--cpu (or PANO_TPU_FORCE_CPU=1) runs on the CPU; without a CUDA device
and without that request it prints an error line and exits 1.
"""

import argparse
import json
import os
import sys
import time
import warnings
from collections import deque
from itertools import repeat

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

MOUNTAIN = [os.path.join(HERE, "images", "mountain", f"mountain{i}.jpg")
            for i in (1, 2)]


def pipelined(stitcher, pairs, depth: int):
    """Stitch each (left, right) of `pairs` with at most `depth` pairs
    dispatched and not yet retired, oldest first; yields each pair's
    panorama (None where it failed) and its estimate row, in order."""
    inflight = deque()
    for left, right in pairs:
        inflight.append(stitcher.dispatch(left, right))
        if len(inflight) >= depth:
            yield stitcher.retire(inflight.popleft()), stitcher.last_estimate
    while inflight:
        yield stitcher.retire(inflight.popleft()), stitcher.last_estimate


def throughput(stitcher, left, right, pairs: int = 30,
               depth: int = 3) -> dict:
    """`pipelined` over `pairs` copies of the pair (tensors on the
    stitcher's device) at `depth`, after one warm-up pair: the JSON object
    the script prints. Raises RuntimeError when the warm-up pair needs the
    fallback ladder."""
    from pano_tpu_torch.timer import synchronize

    if stitcher.stitch_pair_fast(left, right) is None \
            or stitcher.last_estimate[11] <= 0.5:
        raise RuntimeError("bench pair needs the fallback ladder")
    synchronize(stitcher.device)

    fallbacks = 0
    t0 = time.perf_counter()
    for pano, row in pipelined(stitcher, repeat((left, right), pairs),
                               depth):
        if pano is None or row[11] <= 0.5:
            fallbacks += 1
    synchronize(stitcher.device)
    total_s = time.perf_counter() - t0
    return {
        "metric": "mountain_4k_throughput_pairs_per_s",
        "value": round((pairs - fallbacks) / total_s, 2),
        "unit": "pairs/s",
        "ms_per_pair": round(total_s / pairs * 1e3, 2),
        "depth": depth,
        "fallback_pairs": fallbacks,
    }


def host_syncs_per_pair(stitcher, left, right, pairs: int = 3) -> float:
    """Synchronizing CUDA operations per `stitch_pair_fast`, as
    torch.cuda.set_sync_debug_mode("warn") flags them (blocking copies
    between host and card, `.item()`, the error checks of torch.linalg):
    0 on the port's path. `retire`'s wait on the row's event is not among
    them: it is the pair's one wait."""
    import torch

    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(pairs):
                stitcher.retire(stitcher.dispatch(left, right))
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught) / pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (each kernel's plain version)")
    ap.add_argument("images", nargs="*", default=MOUNTAIN)
    args = ap.parse_args(argv)
    if len(args.images) != 2:
        ap.error(f"expected exactly 2 image paths, got {len(args.images)}")

    import torch

    cpu = args.cpu or bool(os.environ.get("PANO_TPU_FORCE_CPU"))
    if not cpu and not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device; pass --cpu (or set "
                          "PANO_TPU_FORCE_CPU=1) to run on the CPU"}))
        return 1

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.io import imread_bgr

    imgs = [imread_bgr(p) for p in args.images]
    if any(im is None for im in imgs):
        print(json.dumps({"error": f"missing bench images: {args.images}"}))
        return 1
    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                            device="cpu" if cpu else "cuda")
    left, right = (stitcher._to_device(im) for im in imgs)
    try:
        out = throughput(stitcher, left, right, args.pairs, args.depth)
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
