"""Batched and multi-device execution: the port's counterpart of
``pano_tpu/parallel/shard.py``.

JAX runs its sharded graphs from one controller under ``shard_map`` and
``jit`` shardings. The port keeps one process and an explicit ``Mesh``:
a (n_data, n_hyp) grid of ``torch.device`` with the axis names "data" and
"hyp". A shard of the data axis is a contiguous slice of the batch, run on
its device. As in JAX, the batch is padded to a multiple of n_data by
repeating its last row: padded rows ride along in their shard's batched
launches and their results are dropped (steps that run row by row skip
them). The hyp axis splits RANSAC's search: shard h draws its
``num_iterations / n_hyp`` hypotheses from ``fold_in(PRNGKey(seed), h)``,
the winners are stacked on the row's first device and the first maximum
wins (JAX's all_gather + argmax). A device may repeat: a mesh of the one
card repeated drives the split and gather code on it, and a mesh of CPU
devices runs every kernel's plain version. No torch.distributed is
involved.

As in the JAX package:

* throughput mode, a batch of pairs over the data axis
  (``fused_estimate_batched``, ``estimate_homographies_batched``,
  ``stitch_pairs_batched``): one K1 launch per shard over every image of
  its pairs, then K2 per image and K3 per pair (in JAX these two fall back
  to XLA under vmap), RANSAC per pair, one host fetch for the batch; then
  ``composite_pairs_batched``: one batched K4b launch per group of pairs of
  equal (canvas, window) size and shard, K5 per pair, each canvas copied
  to the host as it is composed, and one host fetch per group;
* ``batched_stitch_step``: pairs over data, hypotheses over hyp;
* ``match_descriptors_sharded``: query rows over the data axis;
* the multi-image modes (``stitch_all_images_sharded``: chain, auto and
  the hypothesis-sharded fold), which end in ``composite_global_sharded``:
  the placed images' warps as batched K4b launches (one per mip level and
  shard), then ``pipeline.composite_global``'s sequential blend.

Windows are exact, as everywhere in the port (not JAX's largest window
of a group), so every canvas equals its one-device counterpart's byte for
byte.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pano_tpu_torch import pipeline
from pano_tpu_torch.config import DEFAULT_CONFIG, PanoConfig
from pano_tpu_torch.ops import cuda_warp
from pano_tpu_torch.ops import harris as harris_ops
from pano_tpu_torch.ops import match as match_ops
from pano_tpu_torch.ops import ransac as ransac_ops
from pano_tpu_torch.ops import warp as warp_ops
from pano_tpu_torch.timer import Timer, print_stage, span, synchronize


class Mesh:
    """A (n_data, n_hyp) grid of devices with the axes "data" and
    "hyp"; `devices` lists its rows."""

    axis_names = ("data", "hyp")

    def __init__(self, devices: Sequence[Sequence]):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        self.shape = {"data": len(self.devices),
                      "hyp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["hyp"]

    def device(self, data: int = 0, hyp: int = 0) -> torch.device:
        return self.devices[data][hyp]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def make_mesh(
    n_data: Optional[int] = None, n_hyp: int = 1, devices=None,
) -> Mesh:
    """A ('data', 'hyp') mesh over the first n_data * n_hyp of `devices`
    (default: every visible CUDA device; without one this raises, it
    never falls back to the CPU). A device may repeat, e.g.
    ``make_mesh(4, 2, devices=[torch.device("cpu")] * 8)``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= for a mesh "
                "elsewhere, e.g. [torch.device('cpu')] * 8")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_hyp
    if n_data < 1 or n_hyp < 1 or n_data * n_hyp > len(devices):
        raise ValueError(f"make_mesh: a {n_data}x{n_hyp} mesh needs "
                         f"{n_data * n_hyp} devices, got {len(devices)}")
    return Mesh([devices[d * n_hyp:(d + 1) * n_hyp] for d in range(n_data)])


def _mesh_for(mesh: Optional[Mesh]) -> Mesh:
    """`mesh`, else a mesh of the first CUDA device (without one this
    raises): the inputs go to the mesh's devices wherever they lie, so
    the CPU runs only on a mesh of CPU devices."""
    return mesh if mesh is not None else make_mesh(1, 1)


def _data_shards(mesh: Mesh, n: int) -> List[Tuple[torch.device, List[int]]]:
    """(device, batch rows) of each data shard: rows 0..n-1 padded to a
    multiple of n_data by repeating the last, in contiguous slices."""
    n_data = mesh.shape["data"]
    per = -(-n // n_data)
    rows = list(range(n)) + [n - 1] * (per * n_data - n)
    return [(mesh.device(d), rows[d * per:(d + 1) * per])
            for d in range(n_data)]


def _to(x, dev) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on `dev`; a host
    array's copy is an upload span."""
    if pipeline._resident(x, dev):
        return x.to(dev).contiguous()
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    with span("upload"):
        return torch.as_tensor(x).to(dev).contiguous()


def _rows(x, rows: List[int], dev) -> torch.Tensor:
    """Rows `rows` of a batch (a slice when they are contiguous) on
    `dev`."""
    if rows == list(range(rows[0], rows[0] + len(rows))):
        return _to(x[rows[0]:rows[0] + len(rows)], dev)
    return _to(x[rows], dev)


def _detect_pairs(lefts, rights, h_opts):
    """Keypoints of each left and right of a shard, one K1 launch."""
    b = lefts.shape[0]
    kps = harris_ops.harris_detect_batched(torch.cat([lefts, rights]),
                                           h_opts)
    return kps[:b], kps[b:]


# --- the per-pair homography core -------------------------------------------


def fused_estimate_batched(
    lefts,                       # (B, H, W, 3) uint8
    rights,                      # (B, H, W, 3) uint8
    config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
):
    """``PairStitcher._fused_estimate_impl`` for a batch of same-shape
    pairs over the data axis. Returns (packed (B, 14) f32 on the mesh's
    first device, (pts_q (B, K, 2), pts_t (B, K, 2), valid (B, K)) there
    too); a row is [H (9), inlier_count, num_matches, ok, match_count, 0].
    The caller fetches `packed` with one host copy for the whole batch;
    the match points stay on the device for the low-inlier fallback."""
    mesh = _mesh_for(mesh)
    home = mesh.device()
    b = int(lefts.shape[0])
    if b == 0:
        return torch.zeros((0, 14), device=home), ()
    rows: List[Optional[tuple]] = [None] * b
    for dev, shard in _data_shards(mesh, b):
        ls, rs = _rows(lefts, shard, dev), _rows(rights, shard, dev)
        kps_l, kps_r = _detect_pairs(ls, rs, config.harris)
        for k, row in enumerate(shard):
            if rows[row] is not None:
                continue  # a padded repeat
            est, pts = pipeline.estimate_row(kps_l[k], kps_r[k], ls[k],
                                             rs[k], config)
            rows[row] = (est.to(home), *(p.to(home) for p in pts))
    packed = torch.stack([r[0] for r in rows])
    return packed, tuple(torch.stack([r[f] for r in rows])
                         for f in (1, 2, 3))


def estimate_homographies_batched(
    lefts, rights, config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch of pairs -> (H (B, 3, 3) f32, inlier_count (B,) int32, ok
    (B,) bool), on the mesh's first device: pure data parallelism."""
    packed, _ = fused_estimate_batched(lefts, rights, config, mesh)
    return (packed[:, :9].reshape(-1, 3, 3), packed[:, 9].to(torch.int32),
            packed[:, 11] > 0.5)


def _hyp_search(mesh: Mesh, data: int, pts_q, pts_t, valid, r_opts,
                iters_local: int) -> ransac_ops.RansacResult:
    """RANSAC with the hypotheses split over row `data`'s hyp devices:
    shard h scores `iters_local` hypotheses drawn from
    fold_in(PRNGKey(seed), h); the best of the shards (the first maximum)
    is finalized on the row's first device."""
    with span("ransac"):
        home = mesh.device(data)
        hs, counts = [], []
        for h in range(mesh.shape["hyp"]):
            dev = mesh.device(data, h)
            key = ransac_ops.fold_in(ransac_ops.prng_key(r_opts.seed), h)
            sampler = ransac_ops.key_sampler(key, iters_local,
                                             r_opts.num_samples, dev)
            bh, bc = ransac_ops.ransac_best_hypothesis(
                pts_q.to(dev), pts_t.to(dev), valid.to(dev), iters_local,
                r_opts.num_samples, r_opts.distance_threshold, sampler)
            hs.append(bh.to(home))
            counts.append(bc.to(home))
        all_h, all_c = torch.stack(hs), torch.stack(counts)
        win = torch.argmax(all_c)
        return ransac_ops.finalize_ransac(
            ransac_ops.take(all_h, win), ransac_ops.take(all_c, win), pts_q,
            pts_t, valid, r_opts)


def batched_stitch_step(
    mesh: Mesh, lefts, rights, config: PanoConfig = DEFAULT_CONFIG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full step over a (data x hyp) mesh: each data shard takes
    B / n_data pairs, each hyp shard num_iterations / n_hyp hypotheses.
    Returns (H (B, 3, 3), inlier_count (B,)) on the mesh's first
    device."""
    h_opts, r_opts = config.harris, config.ransac
    n_hyp, n_data = mesh.shape["hyp"], mesh.shape["data"]
    b = int(lefts.shape[0])
    if b % n_data != 0:
        raise ValueError(f"batch {b} not divisible by data axis {n_data}")
    if r_opts.num_iterations % n_hyp != 0:
        raise ValueError("num_iterations not divisible by hyp axis")
    iters_local = r_opts.num_iterations // n_hyp
    home = mesh.device()
    hs, counts = [], []
    for d, (dev, shard) in enumerate(_data_shards(mesh, b)):
        ls, rs = _rows(lefts, shard, dev), _rows(rights, shard, dev)
        kps_l, kps_r = _detect_pairs(ls, rs, h_opts)
        for k in range(len(shard)):
            m = match_ops.match_keypoints(kps_r[k], kps_l[k], rs[k], ls[k],
                                          h_opts)
            pq, pt, v = match_ops.gather_match_points(kps_r[k], kps_l[k], m)
            res = _hyp_search(mesh, d, pq, pt, v, r_opts, iters_local)
            hs.append(res.H.to(home))
            counts.append(res.inlier_count.to(home))
    return torch.stack(hs), torch.stack(counts)


# --- sharded matching --------------------------------------------------------


def match_descriptors_sharded(
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    max_ssd_thresh: float,
    mesh: Mesh,
    axis: str = "data",
    ratio_thresh: float = 0.0,
    cross_check: bool = False,
) -> match_ops.Matches:
    """Row-sharded brute-force matching: shard s takes K / n query rows
    against the whole train set (K3 per shard); the rows concatenate on
    the mesh's first device. The ratio test is row-local and shards
    exactly; the cross check needs every query row's argmin per train
    column, so it is refused."""
    if cross_check:
        raise ValueError(
            "cross_check needs a global train->query argmin across query "
            "shards; unsupported in the row-sharded matcher"
        )
    n = mesh.shape[axis]
    if desc_q.shape[0] % n != 0:
        raise ValueError(f"query rows {desc_q.shape[0]} not divisible by {n}")
    per = desc_q.shape[0] // n
    home = mesh.device()
    parts = []
    for s in range(n):
        dev = mesh.device(s, 0) if axis == "data" else mesh.device(0, s)
        parts.append(match_ops.match_descriptors(
            desc_q[s * per:(s + 1) * per].to(dev),
            valid_q[s * per:(s + 1) * per].to(dev), desc_t.to(dev),
            valid_t.to(dev), max_ssd_thresh, ratio_thresh))
    return match_ops.Matches(*(torch.cat([p[f].to(home) for p in parts])
                               for f in range(3)))


# --- batched warps and composites -------------------------------------------


def warp_windows_batched(
    imgs: Sequence[torch.Tensor],
    m_invs: Sequence[np.ndarray],
    windows: Sequence[Tuple[int, int, int, int]],
    mesh: Optional[Mesh] = None,
    has_alpha: bool = True,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Warp same-shape images, each through its canvas-to-source map onto
    its own exact window, as one batched K4b launch per data shard
    (``cuda_warp.warp_packed_batched``). Returns each image's (rgb (h, w,
    3) u8, weight (h, w) f32) on the mesh's first device."""
    mesh = _mesh_for(mesh)
    home = mesh.device()
    out: List[Optional[tuple]] = [None] * len(imgs)
    for dev, shard in _data_shards(mesh, len(imgs)):
        if not shard:
            continue
        got = cuda_warp.warp_packed_batched(
            [_to(imgs[k], dev) for k in shard], [m_invs[k] for k in shard],
            [windows[k] for k in shard], has_alpha)
        for k, (rgb, w) in zip(shard, got):
            if out[k] is None:
                out[k] = (rgb.to(home), w.to(home))
    return out


def composite_pairs_batched(
    lefts,
    rights,
    hs: np.ndarray,              # (B, 3, 3) float64, right -> left
    ok: np.ndarray,              # (B,) bool
    config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
) -> List[Optional[np.ndarray]]:
    """``PairStitcher.composite`` of each pair whose `ok` is set (None
    for the others), as host uint8 canvases. The staged geometry comes per
    pair from the host; pairs of equal (canvas, window) size form a group,
    warped by one batched K4b launch per data shard, then composed pair by
    pair as ``PairStitcher._compose_window`` does (the window context for
    multiband or gain, then K5), each canvas copied as it is composed into
    the group's host buffer (pinned on a card), which comes out in one
    fetch. Overlay without gain goes through K4b +
    K5 overlay too, which gives K4a's canvas bit for bit (the plain
    versions are one function, and each kernel is bit-identical to its
    plain version)."""
    with span("compose"):
        mesh = _mesh_for(mesh)
        st = config.stitch
        warp_ops._check_blend(st.blend)
        stitcher = pipeline.get_pair_stitcher(config, False, "", mesh.device(),
                                              None)
        shape_l = tuple(int(s) for s in lefts.shape[1:3])
        hr, wr = (int(s) for s in rights.shape[1:3])
        b_total = int(lefts.shape[0])
        geo: List[Optional[tuple]] = [None] * b_total
        groups: dict = {}
        for b in range(b_total):
            if not ok[b]:
                continue
            h = np.asarray(hs[b], np.float64)
            (ch, cw), t_mat, (min_x, min_y) = warp_ops.compute_canvas_geometry(
                h, shape_l, (hr, wr))
            m = t_mat @ h
            window = warp_ops.warp_window(warp_ops.warp_corners(m, hr, wr), ch,
                                          cw)
            geo[b] = (np.linalg.inv(m), int(-min_y), int(-min_x), window, ch,
                      cw)
            key = (ch, cw, window[2] - window[0], window[3] - window[1])
            groups.setdefault(key, []).append(b)

        has_alpha = st.blend != "overlay"
        emit_weight = has_alpha or st.gain_compensation
        out: List[Optional[np.ndarray]] = [None] * b_total
        pinned = mesh.device().type == "cuda"
        for idxs in groups.values():
            # Each canvas goes to one host buffer for the group as soon as it
            # is composed (non-blocking on a card), so that a card holds one
            # canvas at a time; the group comes out in one fetch, as the JAX
            # package fetches each group's batched dispatch.
            _, _, _, _, ch, cw = geo[idxs[0]]
            host = torch.empty((len(idxs), ch, cw, 3), dtype=torch.uint8,
                               pin_memory=pinned)
            copied, done = [], set()
            for dev, shard in _data_shards(mesh, len(idxs)):
                members = [idxs[k] for k in shard]
                if not members:
                    continue
                warped = cuda_warp.warp_packed_batched(
                    [_to(rights[b], dev) for b in members],
                    [geo[b][0] for b in members], [geo[b][3] for b in members],
                    has_alpha, emit_weight)
                for k, b, (rgb, w) in zip(shard, members, warped):
                    if k in done:
                        continue  # a padded repeat
                    done.add(k)
                    _, ty, tx, window, ch, cw = geo[b]
                    host[k].copy_(stitcher._compose_window(
                        _to(lefts[b], dev), rgb, w, ty, tx, window, ch, cw),
                        non_blocking=pinned)
                if dev.type == "cuda":
                    copied.append(torch.cuda.Event())
                    copied[-1].record(torch.cuda.current_stream(dev))
            if copied:
                with span("wait"):
                    for event in copied:
                        event.synchronize()
            fetched = pipeline._host_fetch(host)
            for k, b in enumerate(idxs):
                out[b] = fetched[k]
        return out


def stitch_pairs_batched(
    lefts, rights, config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
) -> List[Optional[np.ndarray]]:
    """Throughput mode: a batch of independent same-shape pairs, the
    estimates batched over the data axis with one host fetch
    (``fused_estimate_batched``), then ``composite_pairs_batched``.
    Returns host uint8 panoramas, None for failed pairs."""
    with span("mesh"):
        packed, _ = fused_estimate_batched(lefts, rights, config, mesh)
        v = pipeline._host_fetch(packed)
        hs = v[:, :9].astype(np.float64).reshape(-1, 3, 3)
        return composite_pairs_batched(lefts, rights, hs, v[:, 11] > 0.5,
                                       config, mesh)


def composite_global_sharded(
    images: List,
    devs: List[torch.Tensor],
    globals_h: List[Optional[np.ndarray]],
    config: PanoConfig,
    mesh: Optional[Mesh] = None,
    anchor: int = 0,
    _weights_out: Optional[list] = None,
) -> Optional[np.ndarray]:
    """``pipeline.composite_global`` with the placed images' warps
    batched: one K4b launch per mip level and data shard
    (``warp_windows_batched``), then the sequential blend in image order
    against the accumulated weight canvas (order is semantic), so the
    panorama and the weight canvas are composite_global's, byte for byte.
    Images of different shapes fall back to composite_global on the
    mesh's first device."""
    mesh = _mesh_for(mesh)
    devs = [_to(d, mesh.device()) for d in devs]
    placed = [i for i in range(len(images))
              if i != anchor and globals_h[i] is not None]
    if not placed or len({tuple(images[i].shape) for i in placed}) != 1:
        return pipeline.composite_global(images, devs, globals_h, config,
                                         anchor, _weights_out)
    warp_ops._check_blend(config.stitch.blend)
    with span("compose"):
        with span("geometry"):
            t_mat, canvas_h, canvas_w = pipeline.global_canvas_geometry(
                images, globals_h, anchor)
            plan = pipeline.global_warp_plan(devs, globals_h, anchor, t_mat,
                                             canvas_h, canvas_w)
        has_alpha = config.stitch.blend in ("feather", "multiband")
        warped = {}
        for lvl in sorted({p[3] for p in plan}):
            group = [p for p in plan if p[3] == lvl]
            got = warp_windows_batched(
                [pipeline.mip_source(devs[i], lvl) for i, _, _, _ in group],
                [m_inv for _, m_inv, _, _ in group],
                [window for _, _, window, _ in group], mesh, has_alpha)
            warped.update(zip([i for i, _, _, _ in group], got))
        return pipeline.blend_global(
            devs[anchor], t_mat, canvas_h, canvas_w,
            ((window, warped[i]) for i, _, window, _ in plan), config,
            _weights_out)


# --- the multi-image modes ---------------------------------------------------


def _device_stack(images, dev) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The images as one (n, H, W, 3) stack on `dev`, and its rows."""
    stack = torch.stack([pipeline._to_device(im, dev) for im in images])
    return stack, list(stack)


def stitch_all_images_chain_sharded(
    images: List,
    config: PanoConfig = DEFAULT_CONFIG,
    timing_tag: str = "Sharded",
    mesh: Optional[Mesh] = None,
    print_timing: bool = True,
) -> Optional[np.ndarray]:
    """Chain mode with every adjacent pair's estimate in one batched
    pass over the data axis (``fused_estimate_batched``) and one host
    fetch for all of them; the homographies compose into the first
    image's frame, and ``composite_global_sharded`` draws the panorama.
    After a failed pair the next image is re-estimated against the last
    image that chained (src/serial/main.cpp:404-407). Images of different
    shapes fall back to ``pipeline.stitch_all_images_chain``."""
    t = Timer()
    n = len(images)
    if n == 0:
        return None
    if mesh is None:
        mesh = make_mesh(n_hyp=1)
    home = mesh.device()
    if n < 2 or len({tuple(im.shape) for im in images}) != 1:
        return pipeline.stitch_all_images_chain(images, config, print_timing,
                                                timing_tag, home)
    stack, devs = _device_stack(images, home)
    packed, pts = fused_estimate_batched(stack[:-1], stack[1:], config, mesh)
    v = pipeline._host_fetch(packed)      # the one fetch for the batch

    stitcher = pipeline.get_pair_stitcher(config, False, "", home, None)
    globals_h: List[Optional[np.ndarray]] = [np.eye(3)]
    last_good = 0
    for i in range(1, n):
        if print_timing:
            print(f"Stitching image {i + 1} of {n}...", flush=True)
        if last_good != i - 1:
            h = stitcher.estimate_homography(devs[last_good], devs[i])
        else:
            k = i - 1
            h = stitcher.interpret_fused_row(
                v[k], lambda k=k: pipeline._to_host(*(p[k] for p in pts)))
        if h is None:
            print(f"Failed to stitch image {i}!", file=sys.stderr)
            globals_h.append(None)
            continue
        globals_h.append(globals_h[last_good] @ h)
        last_good = i

    result = composite_global_sharded(images, devs, globals_h, config,
                                      mesh=mesh, anchor=0)
    if print_timing:
        print_stage(pipeline._suffix("Total Stitching Process", timing_tag),
                    t.elapsed())
    return result


def _feat_to(feat, dev):
    kps, desc, bv = feat
    return (harris_ops.KeyPoints(*(x.to(dev) for x in kps)), desc.to(dev),
            bv.to(dev))


def stitch_all_images_auto_sharded(
    images: List,
    config: PanoConfig = DEFAULT_CONFIG,
    timing_tag: str = "Sharded",
    mesh: Optional[Mesh] = None,
    print_timing: bool = True,
    anchor: str = "auto",
) -> Optional[np.ndarray]:
    """Unordered stitching: keypoints of every image from one batched K1
    launch, descriptors per image, then the n(n-1)/2 pair estimates (K3
    and RANSAC) over the data axis with one host fetch for all their
    rows; the maximum spanning tree, the bundle gate and
    ``composite_global_sharded`` as in ``pipeline.stitch_all_images_auto``.
    Fewer than three images, or images of different shapes, fall back to
    that function."""
    t = Timer()
    n = len(images)
    if n == 0:
        return None
    if mesh is None:
        mesh = make_mesh(n_hyp=1)
    home = mesh.device()
    if n < 3 or len({tuple(im.shape) for im in images}) != 1:
        return pipeline.stitch_all_images_auto(images, config, print_timing,
                                               timing_tag, home, anchor)
    stack, devs = _device_stack(images, home)
    p = config.harris.patch_size
    feats = [(k, *match_ops.extract_patch_descriptors(d, k, p))
             for k, d in zip(harris_ops.harris_detect_batched(
                 stack, config.harris), devs)]
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    rows: List[Optional[torch.Tensor]] = [None] * len(pairs)
    for dev, shard in _data_shards(mesh, len(pairs)):
        for k in shard:
            if rows[k] is None:
                i, j = pairs[k]
                rows[k] = pipeline.auto_pair_row(
                    _feat_to(feats[j], dev), _feat_to(feats[i], dev),
                    config).to(home)
    packed = pipeline._host_fetch(torch.stack(rows))   # the one fetch
    graph = pipeline.auto_globals(packed, pairs, images, config, anchor)
    if graph is None:
        return None
    globals_h, root = graph
    result = composite_global_sharded(images, devs, globals_h, config,
                                      mesh=mesh, anchor=root)
    if print_timing:
        print_stage(pipeline._suffix("Total Stitching Process", timing_tag),
                    t.elapsed())
    return result


def stitch_all_images_sharded(
    images: List,
    config: PanoConfig = DEFAULT_CONFIG,
    timing_tag: str = "Sharded",
    mesh: Optional[Mesh] = None,
    mode: str = "fold",
    anchor: str = "auto",
) -> Optional[np.ndarray]:
    """Multi-image stitching over a mesh. mode='chain'
    (``stitch_all_images_chain_sharded``) and 'auto'
    (``stitch_all_images_auto_sharded``) batch their estimates over the
    data axis. mode='fold': the reference's left fold, each pair's RANSAC
    hypotheses split over the hyp axis of `mesh`'s first row
    (``_ShardedPairStitcher``); the fold itself stays sequential. On a
    mesh of one device, the default, it is ``pipeline.stitch_all_images``'
    staged fold under `timing_tag`. (The JAX package splits over every
    device of the process by default. Here the shards run one after
    another from the host, so the split gains nothing yet, and the
    default mesh is one device.)"""
    if mode == "chain":
        return stitch_all_images_chain_sharded(images, config,
                                               timing_tag=timing_tag,
                                               mesh=mesh)
    if mode == "auto":
        return stitch_all_images_auto_sharded(images, config,
                                              timing_tag=timing_tag,
                                              mesh=mesh, anchor=anchor)
    if mode != "fold":
        raise ValueError(f"unknown mode: {mode}")
    mesh = _mesh_for(mesh)
    if mesh.size <= 1 or len(images) < 2:
        return pipeline.stitch_all_images(images, config,
                                          timing_tag=timing_tag,
                                          device=mesh.device())
    t = Timer()
    return pipeline.fold_images(
        _ShardedPairStitcher(mesh, config, timing_tag=timing_tag), images,
        False, True, timing_tag, t)


class _ShardedPairStitcher(pipeline.PairStitcher):
    """The staged PairStitcher whose RANSAC splits its hypotheses over
    the mesh's hyp axis (data row 0); num_iterations is rounded up to a
    multiple of n_hyp. Everything else, the fallback ladder included, is
    PairStitcher's."""

    def __init__(self, mesh: Mesh, config: PanoConfig, timing_tag: str = ""):
        super().__init__(config, True, timing_tag, mesh.device())
        self.mesh = mesh
        n_hyp = mesh.shape["hyp"]
        r = config.ransac
        if r.num_iterations % n_hyp != 0:
            r = dataclasses.replace(
                r, num_iterations=-(-r.num_iterations // n_hyp) * n_hyp)
        self._r_opts = r

    def _sharded_search(self, pts_q, pts_t, valid) -> ransac_ops.RansacResult:
        r = self._r_opts
        return _hyp_search(self.mesh, 0, pts_q, pts_t, valid, r,
                           r.num_iterations // self.mesh.shape["hyp"])

    def ransac(self, pts_q, pts_t, valid) -> ransac_ops.RansacResult:
        t = Timer()
        res = self._sharded_search(pts_q, pts_t, valid)
        synchronize(res.H.device)
        self._print("RANSAC Homography Estimation", t)
        return res
