#!/usr/bin/env python3
"""Serial against the GPU through the PyTorch + CUDA port's CLI, per
dataset.

Counterpart of benchmark_serial_parallel.py (which stays the JAX
package's): for each dataset, the best of --repeats runs of `python -m
pano_tpu_torch.cli serial --warmup` (every stage on the CPU, each
kernel's plain PyTorch version) and of `... gpu --warmup` (the CUDA
kernels), each parsed from its last `Total Stitching Process[ (GPU)]: x
ms` line; the rows are appended to a CSV (dataset, serial_s, gpu_s,
speedup) and drawn as a grouped bar chart, in log scale when the times
span more than 10x.

Usage: python benchmark_serial_parallel_torch.py [--datasets D1,D2]
           [--repeats N] [--cpu] [--csv F] [--plot F]
The datasets default to images/{mountain,bridge,snow} of the checkout.
--cpu (or PANO_TPU_FORCE_CPU=1) runs the `gpu` side on the CPU too;
without a CUDA device and without that request the script prints an
error and exits 1 before any stitch.
"""

import argparse
import csv
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from benchmark_panorama_torch import STITCH_RE, _child_env  # noqa: E402


def run_impl(impl, image_args, cpu=False):
    """One CLI run in a child process: its last Total Stitching Process
    time, in seconds (the reference CSV's unit)."""
    proc = subprocess.run(
        [sys.executable, "-m", "pano_tpu_torch.cli", impl, "--warmup"]
        + image_args,
        capture_output=True, text=True, cwd=HERE, env=_child_env(cpu),
    )
    matches = STITCH_RE.findall(proc.stdout)
    if not matches:
        print(proc.stdout[-1500:], proc.stderr[-1500:], file=sys.stderr)
        raise RuntimeError(f"no timing line from {impl}")
    return float(matches[-1]) / 1000.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--datasets", default=",".join(
        os.path.join(HERE, "images", d) for d in ("mountain", "bridge",
                                                  "snow")))
    ap.add_argument("--csv", default="serial_vs_gpu_torch.csv")
    ap.add_argument("--plot", default="serial_vs_gpu_torch.png")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run the gpu side on the CPU as well")
    args = ap.parse_args(argv)

    import torch

    cpu = args.cpu or bool(os.environ.get("PANO_TPU_FORCE_CPU"))
    if not cpu and not torch.cuda.is_available():
        print("Error: no CUDA device; pass --cpu (or set "
              "PANO_TPU_FORCE_CPU=1) to run on the CPU.", file=sys.stderr)
        return 1

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for ds in args.datasets.split(","):
            name = os.path.basename(ds.rstrip("/"))
            image_args = ["--dir", ds, "--out",
                          os.path.join(tmp, f"bench_{name}.ppm")]
            serial_s = min(run_impl("serial", image_args)
                           for _ in range(args.repeats))
            gpu_s = min(run_impl("gpu", image_args, cpu)
                        for _ in range(args.repeats))
            rows.append({"dataset": name, "serial_s": serial_s,
                         "gpu_s": gpu_s, "speedup": serial_s / gpu_s})
            print(f"{name}: serial={serial_s:.2f}s gpu={gpu_s:.2f}s "
                  f"speedup={serial_s / gpu_s:.1f}x", flush=True)

    exists = os.path.exists(args.csv)
    with open(args.csv, "a", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["dataset", "serial_s", "gpu_s", "speedup"])
        if not exists:
            w.writeheader()
        w.writerows(rows)
    print(f"Appended {args.csv}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        names = [r["dataset"] for r in rows]
        x = np.arange(len(names))
        plt.figure(figsize=(8, 5))
        plt.bar(x - 0.2, [r["serial_s"] for r in rows], 0.4,
                label="serial (CPU)")
        plt.bar(x + 0.2, [r["gpu_s"] for r in rows], 0.4, label="GPU")
        spread = max(r["serial_s"] for r in rows) / max(
            1e-9, min(r["gpu_s"] for r in rows))
        if spread > 10:  # the reference's auto-log rule
            plt.yscale("log")
        plt.xticks(x, names)
        plt.ylabel("total stitching time (s)")
        plt.legend()
        plt.grid(True, axis="y", alpha=0.3)
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"Wrote {args.plot}")
    except ImportError as e:
        print(f"plotting skipped: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
