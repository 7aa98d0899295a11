#!/usr/bin/env python3
"""Measure one copy of pano_tpu_torch's fused estimate on the GPU, for
comparing versions of RANSAC (``ops/ransac.py``) in one run on one machine.

    python3 tools/torch_estimate_ab.py run DIR OUT.pt
    python3 tools/torch_estimate_ab.py compare A.pt B.pt

DIR holds a ``pano_tpu_torch`` package with its ``bench_torch.py``,
``benchmark_throughput_torch.py`` and ``tools/torch_trace_summary.py``
(this checkout, or another version unpacked beside it, e.g. ``git
archive <commit> pano_tpu_torch bench_torch.py
benchmark_throughput_torch.py tools/torch_trace_summary.py``); it builds
its kernels into ``DIR/build``. The data are ``chip_smoke.py``'s planted
4156x3117 pair and its strip of four crops, default config.

``run`` prints one JSON line and saves the estimates to OUT.pt:

- for the planted pair and the strip's three adjacent pairs: the match
  points of ``PairStitcher._fused_estimate_impl``, the hypothesis stage
  on them (``ransac_best_hypothesis`` with the default table: the best H,
  its count, its inlier mask) and the row's refined H;
- ``host_syncs_per_pair`` (torch.cuda.set_sync_debug_mode, 3 pairs);
- ``benchmark_throughput_torch.throughput`` (30 pairs) at depth 1, 3, 3,
  1, in turns;
- the overlay chain and auto walls on the strip (host clock around
  synchronizes, device-resident images, one warm-up, median of 5);
- last, as it runs a torch.profiler session, ``bench_torch._measure``
  (value, device_compute_ms and their ratio, the busy share).

``compare`` checks that the hypothesis stages are ``torch.equal`` (exit
1 if not) and prints, per pair, the refined H's largest difference
(normalized by H[2, 2]) and the largest difference of the reprojected
inliers (px). Run the versions in turns (A, B, B, A) in one call: cards
and calls differ.
"""

import contextlib
import io
import json
import pathlib
import statistics
import sys
import time

PAIRS = ("planted", "strip01", "strip12", "strip23")


def run(vdir: str, out_path: str) -> None:
    sys.path.insert(0, vdir)
    import torch

    import pano_tpu_torch

    if not pano_tpu_torch.__file__.startswith(vdir):
        raise SystemExit(f"imported {pano_tpu_torch.__file__}, not {vdir}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_estimate_ab: no CUDA device")
    sys.path.insert(1, str(pathlib.Path(vdir) / "tools"))
    sys.path.insert(2, str(pathlib.Path(__file__).resolve().parents[1]))
    import bench_torch
    import benchmark_throughput_torch as bt
    import chip_smoke as C
    from pano_tpu_torch import (DEFAULT_CONFIG, PairStitcher, _build,
                                stitch_all_images)
    from pano_tpu_torch.ops import ransac

    _build.lib()
    left_np, right_np = C.synthetic_pair(0)
    _, strip_np = C.synthetic_strip(0)
    left, right = (torch.from_numpy(x).cuda() for x in (left_np, right_np))
    strip = [torch.from_numpy(x).cuda() for x in strip_np]
    torch.cuda.synchronize()
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    r = DEFAULT_CONFIG.ransac
    out = {"dir": vdir, "card": C.nvidia_smi_line()}

    saved = {}
    for name, (a, b) in zip(PAIRS, [(left, right)] + list(
            zip(strip[:-1], strip[1:]))):
        row, (pq, pt, valid) = st._fused_estimate_impl(a, b)
        sampler = ransac.default_sampler(r.num_iterations, r.num_samples,
                                         r.seed, pq.device)
        best_h, count = ransac.ransac_best_hypothesis(
            pq, pt, valid, r.num_iterations, r.num_samples,
            r.distance_threshold, sampler)
        mask = ransac._inlier_mask(best_h, pq, pt, valid,
                                   r.distance_threshold)
        saved[name] = {k: v.cpu() for k, v in dict(
            pq=pq, pt=pt, valid=valid, best_h=best_h, count=count,
            mask=mask, row=row).items()}
    torch.save(saved, out_path)

    out["host_syncs_per_pair"] = bt.host_syncs_per_pair(st, left, right, 3)
    out["throughput"] = []
    for depth in (1, 3, 3, 1):
        res = bt.throughput(st, left, right, 30, depth)
        out["throughput"].append([depth, res["value"], res["ms_per_pair"]])

    for mode, imgs in (("chain", strip),
                       ("auto", [strip[i] for i in C.AUTO_ORDER])):
        walls = []
        for k in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                stitch_all_images(imgs, DEFAULT_CONFIG, False, "", "cuda",
                                  mode)
            torch.cuda.synchronize()
            if k:
                walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{mode}_ms"] = statistics.median(walls)
        out[f"{mode}_ms_all"] = [round(w, 3) for w in walls]

    bench, _ = bench_torch._measure(left, right, 5, "cuda")
    out["bench_value_ms"] = bench["value"]
    out["bench_device_compute_ms"] = bench["device_compute_ms"]
    out["busy_share"] = bench["device_compute_ms"] / bench["value"]
    print(json.dumps(out), flush=True)


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    ok = True
    for name in PAIRS:
        x, y = a[name], b[name]
        same = {k: torch.equal(x[k], y[k])
                for k in ("pq", "pt", "valid", "best_h", "count", "mask")}
        ok &= all(same.values())
        ha = x["row"][:9].double().reshape(3, 3)
        hb = y["row"][:9].double().reshape(3, 3)
        ha, hb = ha / ha[2, 2], hb / hb[2, 2]
        # the refined H's inliers (both rows' masks may differ: take the
        # hypothesis stage's, which is equal)
        pts = x["pq"][x["mask"]].double()
        p = torch.cat([pts, torch.ones_like(pts[:, :1])], 1)
        pa, pb = p @ ha.T, p @ hb.T
        reproj = (pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).abs().max()
        print(json.dumps({
            "pair": name, "hypothesis_equal": same,
            "inliers": int(x["count"]), "row_inliers": [
                float(x["row"][9]), float(y["row"][9])],
            "refined_h_max_abs_diff": float((ha - hb).abs().max()),
            "reprojection_max_diff_px": float(reproj)}))
    print(json.dumps({"hypothesis_stage_equal": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "run":
        run(str(pathlib.Path(sys.argv[2]).resolve()), sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        raise SystemExit(__doc__)
