#!/usr/bin/env python3
"""Driver entry points of the PyTorch + CUDA port: the forward step on one
device, and a dry run of the shipped mesh step.

Counterpart of __graft_entry__.py (which stays the JAX package's).

entry() returns (fn, example_args): fn is a plain function on tensors
with the pipeline's forward step (Harris on both images, SSD matching,
RANSAC, the inverse, fetched to the host as the port's warps take their
map, warp_and_blend's overlay into a 128x256 canvas), and example_args
the example pair on the device.

dryrun_multichip(n) builds the port's ('data' x 'hyp') mesh of n devices
with the JAX file's split rule (hyp = 2 when n is even) and runs the
SHIPPED steps, pano_tpu_torch.parallel.shard.batched_stitch_step (pairs
over 'data', RANSAC hypotheses over 'hyp', the first best count winning)
then shard.composite_pairs_batched, checks what the JAX dry run checks
and prints its OK line. The mesh is the visible cards, the first
repeated where there are fewer than n; device="cpu" (or
PANO_TPU_FORCE_CPU=1) makes it n CPU slots. Without a CUDA device and
without that request both raise before any stitch.

    python graft_entry_torch.py [--cpu] [N]   # N: mesh size, default the
                                              # card count (1 on the CPU)
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _example_pair(h=128, w=160, shift=32, seed=0):
    r = np.random.default_rng(seed)
    base = np.full((h, w + shift, 3), 30, np.uint8)
    for _ in range(60):
        y, x = r.integers(5, h - 12), r.integers(5, w - 12 + shift)
        base[y : y + 8, x : x + 8] = r.integers(60, 255, 3)
    return base[:, shift:].copy(), base[:, :w].copy()  # (left, right)


def _device(device=None):
    """`device`, else the CPU when PANO_TPU_FORCE_CPU asks for it, else
    the first CUDA device; without one this raises."""
    import torch

    if device is not None:
        return torch.device(device)
    if os.environ.get("PANO_TPU_FORCE_CPU"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("graft_entry_torch: no CUDA device; pass "
                           "device='cpu' (or set PANO_TPU_FORCE_CPU=1) to "
                           "run on the CPU")
    return torch.device("cuda")


def _check(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def entry(device=None):
    """(fn, example_args): the single-device forward step and its example
    pair on `device` (default: the card)."""
    import torch

    from pano_tpu_torch.config import HarrisOptions, PanoConfig, RansacOptions
    from pano_tpu_torch.ops import harris as harris_ops
    from pano_tpu_torch.ops import match as match_ops
    from pano_tpu_torch.ops import ransac as ransac_ops
    from pano_tpu_torch.ops import warp as warp_ops

    dev = _device(device)
    cfg = PanoConfig(
        harris=HarrisOptions(max_keypoints=512),
        ransac=RansacOptions(num_iterations=256),
    )

    def forward(left, right):
        kps_l = harris_ops.harris_detect(left, cfg.harris)
        kps_r = harris_ops.harris_detect(right, cfg.harris)
        m = match_ops.match_keypoints(kps_r, kps_l, right, left, cfg.harris)
        pq, pt, v = match_ops.gather_match_points(kps_r, kps_l, m)
        res = ransac_ops.ransac_homography(pq, pt, v, cfg.ransac)
        # The port's warps take their map's nine floats on the host.
        h_inv = ransac_ops.inv3x3(res.H).float().cpu()
        canvas = warp_ops.warp_and_blend(
            left, right, h_inv, 0, 0, 128, 256, "overlay")
        return res.H, res.inlier_count, canvas

    left, right = _example_pair()
    return forward, (torch.from_numpy(left).to(dev),
                     torch.from_numpy(right).to(dev))


def _mesh_devices(n_devices: int, device=None):
    import torch

    dev = _device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    cards = [torch.device("cuda", i)
             for i in range(min(torch.cuda.device_count(), n_devices))]
    return cards + [cards[0]] * (n_devices - len(cards))


def _dryrun_setup(n_devices: int, device=None):
    """The mesh, the config and the example pair batch (host tensors; the
    shard entry points move each shard to its device)."""
    import torch

    from pano_tpu_torch.config import HarrisOptions, PanoConfig, RansacOptions
    from pano_tpu_torch.parallel import shard

    n_hyp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_hyp
    mesh = shard.make_mesh(n_data, n_hyp,
                           devices=_mesh_devices(n_devices, device))
    cfg = PanoConfig(
        harris=HarrisOptions(max_keypoints=256),
        ransac=RansacOptions(num_iterations=64 * n_hyp),
    )
    pairs = [_example_pair(h=64, w=96, shift=24, seed=i)
             for i in range(n_data)]
    lefts = torch.from_numpy(np.stack([p[0] for p in pairs]))
    rights = torch.from_numpy(np.stack([p[1] for p in pairs]))
    return mesh, cfg, lefts, rights


def dryrun_multichip(n_devices: int, device=None):
    """Run the shipped mesh step over an n-device mesh:
    shard.batched_stitch_step, then shard.composite_pairs_batched. Returns
    (hs (n_data, 3, 3) f64, counts (n_data,)) on the host, so that tests
    can compare against a direct library call."""
    from pano_tpu_torch.parallel import shard

    mesh, cfg, lefts, rights = _dryrun_setup(n_devices, device)
    n_data, n_hyp = mesh.shape["data"], mesh.shape["hyp"]
    hs_d, counts_d = shard.batched_stitch_step(mesh, lefts, rights, cfg)
    hs = hs_d.cpu().numpy().astype(np.float64)
    counts = counts_d.cpu().numpy()
    _check(hs.shape == (n_data, 3, 3), hs.shape)
    _check((counts > 0).all(), counts)

    ok = counts >= cfg.ransac.min_inliers
    panos = shard.composite_pairs_batched(
        lefts, rights, hs, np.ones(n_data, bool), cfg, mesh)
    for b, p in enumerate(panos):
        _check(p is not None and p.ndim == 3, (b, type(p)))
        _check(p.shape[0] >= 64 and p.shape[1] >= 96, p.shape)
    print(
        f"dryrun_multichip OK: mesh=({n_data}x{n_hyp}) devices={n_devices}, "
        f"inliers={counts.tolist()}, gate>=min_inliers={ok.tolist()}, "
        f"composited={[p.shape[:2] for p in panos]}",
        flush=True,
    )
    return hs, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (each kernel's plain version)")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="mesh size (default: the CUDA device count)")
    args = ap.parse_args(argv)

    import torch

    try:
        device = _device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    fn, example = entry(device)
    out = fn(*example)
    print("entry OK:", [tuple(x.shape) for x in out], flush=True)
    n = args.n or (torch.cuda.device_count() if device.type == "cuda" else 1)
    dryrun_multichip(n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
