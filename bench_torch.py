#!/usr/bin/env python3
"""Headline benchmark of the PyTorch + CUDA port: a 2-image 4K stitch's
wall-clock on the mountain pair.

Counterpart of bench.py (which stays the JAX package's). Prints ONE
JSON line with bench.py's keys:
  {"metric": "mountain_4k_stitch_ms", "value": <ms>, "unit": "ms",
   "vs_baseline": <speedup or null>, "device_compute_ms": <ms>}

`value` is the steady-state per-pair wall-clock: the mean over one timed
block of PANO_BENCH_REPEATS (default 5) calls of
`PairStitcher(DEFAULT_CONFIG, print_timing=False).stitch_pair_fast` on
device-resident images, with one `torch.cuda.synchronize` at the block's
end, after one warm-up call (kernel build and first launches). The card
runs the calls in order, so the block charges every call's composite.

`device_compute_ms` is the device-busy time per pair of a SEPARATE block
of 3 calls under torch.profiler (the union of kernel, memcpy and memset
intervals over the card's streams, tools/torch_trace_summary.py), so the
profiler never touches `value`. A CPU run has no device time and leaves
the key out.

`vs_baseline` is PANO_BENCH_BASELINE_MS / value, and null without that
variable: bench.py's default baseline was measured on another machine
and is no baseline of this port.

Usage: python bench_torch.py [--cpu] [left right]
The images default to the mountain pair under images/mountain/ of the
checkout; --cpu (or PANO_TPU_FORCE_CPU=1) runs every kernel's plain
PyTorch version on the CPU. Without a CUDA device and without that
request it prints an error line and exits 1.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

MOUNTAIN = [os.path.join(HERE, "images", "mountain", f"mountain{i}.jpg")
            for i in (1, 2)]
TRACE_REPS = 3


def measure(left, right, repeats: int = 5, device="cuda") -> dict:
    """bench.py's measurement on an (H, W, 3) uint8 BGR pair (numpy
    arrays or tensors) on `device`: the JSON object bench_torch.py
    prints. Raises RuntimeError when the pair does not stitch."""
    return _measure(left, right, repeats, device)[0]


def _measure(left, right, repeats, device):
    """`measure`'s JSON object and the timed block's last panorama."""
    import torch

    import torch_trace_summary
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.pipeline import _to_device
    from pano_tpu_torch.timer import synchronize

    device = torch.device(device)
    dev_left = _to_device(left, device)
    dev_right = _to_device(right, device)
    synchronize(device)
    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False, device=device)

    pano = stitcher.stitch_pair_fast(dev_left, dev_right)   # warm-up
    if pano is None:
        raise RuntimeError("stitch failed")
    synchronize(device)

    t0 = time.perf_counter()
    for _ in range(repeats):
        pano = stitcher.stitch_pair_fast(dev_left, dev_right)
    synchronize(device)
    value = (time.perf_counter() - t0) * 1e3 / repeats

    device_ms = None
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with tempfile.TemporaryDirectory() as td:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_REPS):
                    stitcher.stitch_pair_fast(dev_left, dev_right)
                synchronize(device)
            path = os.path.join(td, "bench_trace.json")
            prof.export_chrome_trace(path)
            device_ms = (torch_trace_summary.device_busy_ms(
                torch_trace_summary.load(path)) / TRACE_REPS)

    baseline = os.environ.get("PANO_BENCH_BASELINE_MS")
    out = {
        "metric": "mountain_4k_stitch_ms",
        "value": round(value, 3),
        "unit": "ms",
        "vs_baseline": (round(float(baseline) / value, 2)
                        if baseline else None),
    }
    if device_ms is not None:
        out["device_compute_ms"] = round(device_ms, 3)
    return out, pano


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    if not all(os.path.exists(p) for p in args.images):
        print(json.dumps({"error": f"missing bench images: {args.images}"}))
        return 1

    from pano_tpu_torch.io import imread_bgr

    left, right = (imread_bgr(p) for p in args.images)
    if left is None or right is None:
        print(json.dumps({"error": f"unreadable bench images: "
                          f"{args.images}"}))
        return 1
    repeats = int(os.environ.get("PANO_BENCH_REPEATS", "5"))
    try:
        out = measure(left, right, repeats, "cpu" if cpu else "cuda")
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
