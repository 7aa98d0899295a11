#!/usr/bin/env python3
"""Time the kernels of one copy of the pano_tpu_torch package on the GPU,
for comparing versions of the kernels in one run on one machine.

    python3 tools/torch_kernel_ab.py DIR

DIR holds a ``pano_tpu_torch`` package (this checkout's, or another
version unpacked beside it, e.g. ``git archive <commit> pano_tpu_torch``);
it builds its kernels into ``DIR/build``. The data and the timer are
``chip_smoke.py``'s: the planted 4156x3117 pair, its keypoints (K = 8192)
and its 3154x5556 canvas, the K5 window from K4b with the ramp alpha. It
prints one JSON line: each kernel's output against its plain version
(torch.equal), its median time around the wrapper with L2 flushed
(``ms``) and its device time alone (``device_ms``: the card warmed, a
spin before each of 20 runs) for K1 (also at the NMS windows 11 and 15),
K2 (on the left image's keypoints), K3, K4a, K4b, K5, the batched K1
(four images) and K4b (three windows, and 17) where the package has them, and a one-element ``fill_`` (the launch
floor); and the
describe step of a pair (``describe_ms``:
both images' ``extract_patch_descriptors``, host clock around
synchronizes, median of 20). K2 before its border test moved into the
kernel took the border flags where it now takes the keypoints' validity;
both are handled. Run the versions in turns (A, B, B, A) in one call:
cards and calls differ.
"""

import inspect
import json
import pathlib
import sys
import time


def main() -> None:
    vdir = str(pathlib.Path(sys.argv[1]).resolve())
    sys.path.insert(0, vdir)
    import numpy as np
    import torch

    import pano_tpu_torch

    if not pano_tpu_torch.__file__.startswith(vdir):
        raise SystemExit(f"imported {pano_tpu_torch.__file__}, not {vdir}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    from pano_tpu_torch import DEFAULT_CONFIG, _build

    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as C
    from pano_tpu_torch.ops import (
        cuda_compose, cuda_gather, cuda_harris, cuda_match, cuda_warp, harris,
        match,
    )
    from pano_tpu_torch.pipeline import fused_canvas_geometry

    left_np, right_np = C.synthetic_pair(0)
    left = torch.from_numpy(left_np).cuda()
    right = torch.from_numpy(right_np).cuda()
    row = np.zeros(14, np.float32)
    row[:9] = [1, 0, C.DX, 0, 1, C.DY, 0, 0, 1]
    geo = fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
    k4a = (right, geo.m_inv, left, geo.ty, geo.tx, geo.window, geo.canvas_h,
           geo.canvas_w)
    rgb, w = cuda_warp.warp_packed(right, geo.m_inv, geo.window, True)
    k5 = {b: (left, rgb, w, geo.ty, geo.tx, geo.window, geo.canvas_h,
              geo.canvas_w, b) for b in ("overlay", "feather")}
    equal = {"K4a": torch.equal(cuda_warp.warp_compose_overlay(*k4a),
                                cuda_warp.warp_compose_overlay_plain(*k4a))}
    for b, args in k5.items():
        equal[f"K5_{b}"] = torch.equal(
            cuda_compose.compose_canvas(*args),
            cuda_compose.compose_canvas_plain(*args))
    h = DEFAULT_CONFIG.harris
    p = h.patch_size
    kps_l = harris.harris_detect(left, h)
    kps_r = harris.harris_detect(right, h)
    desc_l, bv_l = match.extract_patch_descriptors(left, kps_l, p)
    desc_r, bv_r = match.extract_patch_descriptors(right, kps_r, p)
    xy_l = kps_l.xy.contiguous()
    takes_kp_valid = "kp_valid" in inspect.signature(
        cuda_gather.gather_patches).parameters
    flags = kps_l.valid if takes_kp_valid else bv_l

    def k2():
        return cuda_gather.gather_patches(left, xy_l, flags, p)

    def outputs(x):
        return x if isinstance(x, tuple) else (x,)

    equal["K2"] = all(map(torch.equal, outputs(k2()), outputs(
        cuda_gather.gather_patches_plain(left, xy_l, flags, p))))
    k3 = (desc_r, bv_r, desc_l, bv_l)
    equal["K3"] = all(map(torch.equal, cuda_match.match_cores(*k3),
                          cuda_match.match_cores_plain(*k3)))
    one = torch.zeros(1, device="cuda")
    runs = {
        "K1": lambda: cuda_harris.harris_scores(left, h.k, h.nms_thresh),
        "K1_nms11": lambda: cuda_harris.harris_scores(left, h.k,
                                                      h.nms_thresh, 11),
        "K1_nms15": lambda: cuda_harris.harris_scores(left, h.k,
                                                      h.nms_thresh, 15),
        "K2": k2,
        "K3": lambda: cuda_match.match_cores(*k3),
        "K4a": lambda: cuda_warp.warp_compose_overlay(*k4a),
        "K4b": lambda: cuda_warp.warp_packed(right, geo.m_inv, geo.window,
                                             True),
        "K4b_no_weight": lambda: cuda_warp.warp_packed(
            right, geo.m_inv, geo.window, True, emit_weight=False),
        "K5_feather": lambda: cuda_compose.compose_canvas(*k5["feather"]),
        "K5_overlay": lambda: cuda_compose.compose_canvas(*k5["overlay"]),
        "launch_floor": lambda: one.fill_(1.0),  # a one-element fill_
    }
    if hasattr(cuda_harris, "harris_scores_batched"):
        # The batched entries: K1 over (left, right, left, right), K4b
        # over the planted window of three sources.
        stack = torch.stack([left, right, left, right])
        srcs = [right, left, right]
        equal["K1_batch4"] = torch.equal(
            cuda_harris.harris_scores_batched(stack, h.k, h.nms_thresh),
            cuda_harris.harris_scores_batched_plain(stack, h.k,
                                                    h.nms_thresh))
        equal["K4b_batch3"] = all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(
                cuda_warp.warp_packed_batched(srcs, [geo.m_inv] * 3,
                                              [geo.window] * 3),
                cuda_warp.warp_packed_batched_plain(srcs, [geo.m_inv] * 3,
                                                    [geo.window] * 3)))
        runs["K1_batch4"] = lambda: cuda_harris.harris_scores_batched(
            stack, h.k, h.nms_thresh)
        runs["K4b_batch3"] = lambda: cuda_warp.warp_packed_batched(
            srcs, [geo.m_inv] * 3, [geo.window] * 3)
        runs["K4b_batch17"] = lambda: cuda_warp.warp_packed_batched(
            [right] * 17, [geo.m_inv] * 17, [geo.window] * 17)
    timer = C.Timer(torch)
    ms = {k: timer(fn) for k, fn in runs.items()}
    timer.warm()
    device_ms = {k: timer(fn, reps=20, spin=True) for k, fn in runs.items()}

    def describe():
        match.extract_patch_descriptors(right, kps_r, p)
        match.extract_patch_descriptors(left, kps_l, p)

    walls = []
    for i in range(22):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        describe()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"dir": vdir, "card": C.nvidia_smi_line(),
                      "build_s": round(build_s, 1), "equal": equal,
                      "ms": ms, "device_ms": device_ms,
                      "describe_ms": float(np.median(walls)),
                      "describe_ms_all": walls}), flush=True)


if __name__ == "__main__":
    main()
