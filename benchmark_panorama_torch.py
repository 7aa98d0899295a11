#!/usr/bin/env python3
"""Scaling benchmark of the PyTorch + CUDA port: a resolution sweep
through the port's CLI, and a device-count sweep over
pano_tpu_torch.parallel.shard.

Counterpart of benchmark_panorama.py (which stays the JAX package's,
with its default output files). The resolution sweep downsamples the
dataset with cv2 to each scale and runs `python -m pano_tpu_torch.cli
<impl> --warmup --dir ... --out ...` in a child process per scale and
repeat, parsing the last `Total Stitching Process[ (GPU|Sharded)]: x ms`
line; it writes the best time per scale to a CSV and a log-log plot with
the ideal linear-in-pixels line.

The device sweep (--devices 1,2,4) runs one child process per device
count (--_worker n). Each times a batch of the dataset's first pair over
a (n x 1) mesh (`shard.make_mesh(n, 1, devices=...)`): the batched
estimate plus its one host fetch (`shard.fused_estimate_batched`,
`pipeline._host_fetch`), and the whole batch
(`shard.stitch_pairs_batched`), the best of --repeats after a warm-up,
and counts the host fetches each pays (one for the estimate's batch and
one a composite group, whatever the device count). The mesh is the
first card repeated n times by default (the counterpart of the JAX
script's virtual CPU devices), n distinct cards with --real-mesh, n CPU
slots with --cpu. Strong scaling by default (the batch rounded up to a
multiple of n); --weak makes it --batch x n.

--cpu (or PANO_TPU_FORCE_CPU=1) runs every child on the CPU; `--impl
serial` is the CPU by name. Otherwise, without a CUDA device, the script
prints an error and exits 1 before any stitch.
"""

import argparse
import csv
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

IMPLS = ("serial", "gpu", "sharded")
STITCH_RE = re.compile(
    r"^Total Stitching Process(?: \((?:GPU|Sharded)\))?: ([\d.]+) ms$",
    re.M,
)
SWEEP_RE = re.compile(
    r"DEVICE_SWEEP devices=(\d+) batch=(\d+) est_ms=([\d.]+) "
    r"full_ms=([\d.]+) est_fetches=(\d+) full_fetches=(\d+)"
)
IMAGE_EXTS = (".jpg", ".png", ".ppm")


def _cpu_requested(args) -> bool:
    return args.cpu or bool(os.environ.get("PANO_TPU_FORCE_CPU"))


def _child_env(cpu: bool) -> dict:
    env = dict(os.environ)
    env.pop("PANO_TPU_PROFILE", None)
    if cpu:
        env["PANO_TPU_FORCE_CPU"] = "1"
    else:
        env.pop("PANO_TPU_FORCE_CPU", None)
    return env


def downsample_images(src_dir, dst_dir, scale):
    """Every image of `src_dir` resized by `scale` (cv2, its default
    interpolation) into `dst_dir`, under the same name."""
    import cv2

    os.makedirs(dst_dir, exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        img = cv2.imread(os.path.join(src_dir, name))
        if img is None:
            continue
        if scale < 1.0:
            img = cv2.resize(
                img,
                (max(2, int(img.shape[1] * scale)),
                 max(2, int(img.shape[0] * scale))),
            )
        cv2.imwrite(os.path.join(dst_dir, name), img)


def run_once(impl, image_dir, out_file, cpu=False):
    """One CLI run in a child process: its last Total Stitching Process
    time (ms)."""
    proc = subprocess.run(
        [sys.executable, "-m", "pano_tpu_torch.cli", impl, "--warmup",
         "--dir", image_dir, "--out", out_file],
        capture_output=True, text=True, env=_child_env(cpu), cwd=HERE,
    )
    matches = STITCH_RE.findall(proc.stdout)
    if not matches:
        print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
        raise RuntimeError(f"no timing line from {impl}")
    return float(matches[-1])


def _mesh_devices(args, n):
    import torch

    if _cpu_requested(args):
        return [torch.device("cpu")] * n
    if args.real_mesh:
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"--real-mesh needs {n} CUDA devices, have "
                               f"{torch.cuda.device_count()}")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _device_worker(args):
    """Child process for one device count: times the batched paths and
    prints one DEVICE_SWEEP line."""
    import time

    import cv2
    import numpy as np
    import torch

    from pano_tpu_torch import pipeline
    from pano_tpu_torch.config import HarrisOptions, PanoConfig, RansacOptions
    from pano_tpu_torch.parallel import shard
    from pano_tpu_torch.timer import synchronize

    n = args._worker
    mesh = shard.make_mesh(n, 1, devices=_mesh_devices(args, n))
    home = mesh.device()
    names = sorted(f for f in os.listdir(args.dataset)
                   if f.lower().endswith(IMAGE_EXTS))[:2]
    imgs = []
    for f in names:
        im = cv2.imread(os.path.join(args.dataset, f))
        im = cv2.resize(
            im,
            (int(im.shape[1] * args.device_scale),
             int(im.shape[0] * args.device_scale)),
            interpolation=cv2.INTER_AREA,
        )
        imgs.append(im)
    h = min(i.shape[0] for i in imgs)
    w = min(i.shape[1] for i in imgs)
    imgs = [np.ascontiguousarray(i[:h, :w]) for i in imgs]
    if args.weak:
        b = args.batch * n          # constant per-device load
    else:
        b = ((args.batch + n - 1) // n) * n
    lefts = torch.from_numpy(np.stack([imgs[0]] * b)).to(home)
    rights = torch.from_numpy(np.stack([imgs[1]] * b)).to(home)
    cfg = PanoConfig(
        harris=HarrisOptions(max_keypoints=args.kpts),
        ransac=RansacOptions(num_iterations=1024),
    )

    # Count host fetches: the sync structure (one fetch for the batch's
    # estimates, one per composite group) holds whatever the wall-clock
    # over a repeated device says.
    fetch_calls = []
    real_fetch = pipeline._host_fetch
    pipeline._host_fetch = lambda x: (fetch_calls.append(1), real_fetch(x))[1]

    def run_est():
        packed, _ = shard.fused_estimate_batched(lefts, rights, cfg, mesh)
        pipeline._host_fetch(packed)  # one host sync for the whole batch

    def run_full():
        shard.stitch_pairs_batched(lefts, rights, cfg, mesh)

    out = {}
    for label, fn in (("est", run_est), ("full", run_full)):
        fn()  # warm-up
        times = []
        for _ in range(args.repeats):
            synchronize(home)
            t0 = time.perf_counter()
            fn()
            synchronize(home)
            times.append((time.perf_counter() - t0) * 1e3)
        out[label] = min(times)
        fetch_calls.clear()
        fn()
        out[label + "_fetches"] = len(fetch_calls)
    print(
        f"DEVICE_SWEEP devices={n} batch={b} est_ms={out['est']:.1f} "
        f"full_ms={out['full']:.1f} est_fetches={out['est_fetches']} "
        f"full_fetches={out['full_fetches']}",
        flush=True,
    )


def _device_sweep(args):
    """Parent: one worker per device count; CSV and log-log plot with the
    ideal line (1/n for strong scaling, flat for weak)."""
    counts = [int(c) for c in args.devices.split(",")]
    rows = []
    for n in counts:
        cmd = [
            sys.executable, os.path.abspath(__file__),
            "--_worker", str(n),
            "--dataset", args.dataset,
            "--batch", str(args.batch),
            "--kpts", str(args.kpts),
            "--device-scale", str(args.device_scale),
            "--repeats", str(args.repeats),
        ] + (["--real-mesh"] if args.real_mesh else []) \
          + (["--weak"] if args.weak else []) \
          + (["--cpu"] if _cpu_requested(args) else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                              env=_child_env(_cpu_requested(args)))
        m = SWEEP_RE.search(proc.stdout)
        if not m:
            print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
            raise RuntimeError(f"device sweep worker failed for n={n}")
        rows.append(
            {
                "devices": n,
                "batch": int(m.group(2)),
                "est_ms": float(m.group(3)),
                "full_ms": float(m.group(4)),
                "pairs_per_s": 1e3 * int(m.group(2)) / float(m.group(4)),
                "est_fetches": int(m.group(5)),
                "full_fetches": int(m.group(6)),
            }
        )
        print(
            f"devices={n} batch={rows[-1]['batch']} "
            f"est={rows[-1]['est_ms']:.1f} ms "
            f"full={rows[-1]['full_ms']:.1f} ms "
            f"({rows[-1]['pairs_per_s']:.2f} pairs/s, "
            f"{rows[-1]['est_fetches']}/{rows[-1]['full_fetches']} fetches)",
            flush=True,
        )

    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(
            f,
            fieldnames=["devices", "batch", "est_ms", "full_ms",
                        "pairs_per_s", "est_fetches", "full_fetches"],
        )
        w.writeheader()
        w.writerows(rows)
    print(f"Wrote {args.csv}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ns = [r["devices"] for r in rows]
        plt.figure(figsize=(7, 5))
        for key, label in (("est_ms", "estimation (batch)"),
                           ("full_ms", "full stitch (est + composite)")):
            ys = [r[key] for r in rows]
            plt.loglog(ns, ys, "o-", label=f"{label} measured")
            if args.weak:
                ideal = [ys[0]] * len(ns)
                ideal_lbl = f"{label} ideal (flat)"
            else:
                ideal = [ys[0] * ns[0] / n for n in ns]
                ideal_lbl = f"{label} ideal 1/n"
            plt.loglog(ns, ideal, "--", alpha=0.6, label=ideal_lbl)
        plt.xlabel("devices (mesh 'data' axis)")
        if args.weak:
            plt.ylabel(f"batch of {args.batch}x devices pairs: time (ms)")
            regime = "weak"
        else:
            plt.ylabel(f"batch of {rows[0]['batch']} pairs: time (ms)")
            regime = "strong"
        plt.title(f"Device-count {regime} scaling — "
                  f"{os.path.basename(args.dataset)}")
        plt.xticks(ns, [str(n) for n in ns])
        plt.legend(fontsize=8)
        plt.grid(True, which="both", alpha=0.3)
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"Wrote {args.plot}")
    except ImportError as e:
        print(f"plotting skipped: {e}", file=sys.stderr)


def _resolution_sweep(args):
    scales = [float(s) for s in args.scales.split(",")]
    cpu = _cpu_requested(args)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for scale in scales:
            d = os.path.join(tmp, f"s{scale}")
            downsample_images(args.dataset, d, scale)
            best = min(run_once(args.impl, d, os.path.join(tmp, "out.ppm"),
                                cpu)
                       for _ in range(args.repeats))
            area = scale * scale
            rows.append({"scale": scale, "area": area, "ms": best})
            print(f"scale={scale:.3f} area={area:.3f} best={best:.1f} ms",
                  flush=True)

    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["scale", "area", "ms"])
        w.writeheader()
        w.writerows(rows)
    print(f"Wrote {args.csv}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        areas = [r["area"] for r in rows]
        ms = [r["ms"] for r in rows]
        plt.figure(figsize=(7, 5))
        plt.loglog(areas, ms, "o-", label=f"{args.impl} measured")
        ideal = [ms[-1] * a / areas[-1] for a in areas]
        plt.loglog(areas, ideal, "--", label="ideal (linear in pixels)")
        plt.xlabel("image area (fraction of full)")
        plt.ylabel("total stitching time (ms)")
        plt.title(f"Resolution scaling — {os.path.basename(args.dataset)}")
        plt.legend()
        plt.grid(True, which="both", alpha=0.3)
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"Wrote {args.plot}")
    except ImportError as e:
        print(f"plotting skipped: {e}", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset",
                    default=os.path.join(HERE, "images", "mountain"))
    ap.add_argument("--impl", default="gpu", choices=IMPLS)
    ap.add_argument(
        "--scales", default="0.125,0.177,0.25,0.354,0.5,0.707,1.0",
        help="resolution scales to sweep (weak-scaling axis)",
    )
    ap.add_argument(
        "--devices", default=None,
        help="comma list of device counts: run the device-count sweep "
        "instead (the first card repeated unless --real-mesh or --cpu)",
    )
    ap.add_argument("--real-mesh", action="store_true",
                    help="n distinct CUDA devices for the device sweep")
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling for the device sweep: batch = "
                    "--batch x devices (constant per-device load)")
    ap.add_argument("--batch", type=int, default=8,
                    help="pairs per batch for the device sweep")
    ap.add_argument("--kpts", type=int, default=1024,
                    help="keypoint capacity for the device sweep")
    ap.add_argument("--device-scale", type=float, default=0.125,
                    dest="device_scale",
                    help="image downscale for the device sweep")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (each kernel's plain version)")
    ap.add_argument("--_worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--csv", default="benchmark_results_torch.csv")
    ap.add_argument("--plot", default="benchmark_scaling_torch.png")
    args = ap.parse_args(argv)

    if args._worker is not None:
        _device_worker(args)
        return 0
    import torch

    on_cpu = _cpu_requested(args) or (args.impl == "serial"
                                      and not args.devices)
    if not on_cpu and not torch.cuda.is_available():
        print("Error: no CUDA device; pass --cpu (or set "
              "PANO_TPU_FORCE_CPU=1) to run on the CPU.", file=sys.stderr)
        return 1
    if args.devices:
        _device_sweep(args)
    else:
        _resolution_sweep(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
