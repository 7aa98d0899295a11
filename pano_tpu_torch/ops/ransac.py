"""RANSAC homography estimation, all hypotheses at once.

Counterpart of ``pano_tpu/ops/ransac.py``: every hypothesis of the JAX
package's ``vmap`` is a row of a leading batch dimension here. The
search over the hypotheses is one kernel, K10 (``ops/cuda_ransac.py``:
each hypothesis's Hartley-normalized 4-point DLT, its inlier count over
all matches, the first maximum; its plain version on the CPU), then the
degeneracy guard and the masked least-squares refine through the
smallest eigenvector of a 9x9 normal matrix (kernel K7,
``ops/cuda_eigh.py``), and, where the options ask for it, the direct
alignment of that homography on the two images (``ops/align.py``, kernel
K11; only the fused estimate, ``pipeline.estimate_row``, hands them over,
and any other caller with the option on is refused). Everything is float32 (the
alignment's sums float64); the package turns TF32
off, so the refine's small matrix products are true fp32. Nothing here
reads a device value on the host: constants are made on the device,
gathers by a device index are ``index_select``, and the search and the
refine's eigenvector come from K10 and K7, so an estimate is enqueued
whole.

Sampling: ``ransac_best_hypothesis`` takes a ``sampler(n_valid) -> (N, 4)
int64`` table of indices into the compacted valid range. The default is
the JAX package's own draw, ``jax.random.randint(PRNGKey(seed), (N, 4), 0,
max(n_valid, 1))``, bit for bit: threefry2x32 and ``randint``'s two-word
reduction in integer torch (``default_sampler``). Its random bits depend
only on (seed, N, 4), so they are made once per device and kept; each call
reduces them modulo ``n_valid`` on the device, with no host sync. The
hypothesis-sharded search draws each shard's table from
``fold_in(PRNGKey(seed), shard)`` (``key_sampler``). Tests may inject
another table through ``sampler=``.

Launching: ``ransac_homography`` runs one function, ``_estimate`` (the
search, then ``finalize_ransac``). On a CUDA device with the default table
(``sampler=None``) every shape in it is fixed by the configuration, so it
is captured once per (device, stream, input shapes and dtypes, options)
as a CUDA graph and replayed: the inputs are copied into the graph's own
buffers (where the estimate aligns, the two images too: 2 x 37 MiB at
4156x3117), one graph launch runs the ~190 kernels and memsets the host
would otherwise enqueue one by one, and the outputs come back as copies. The same kernels
run on the same inputs in the same order, so the result is the eager
one's bit for bit. Anything else (the CPU, an injected table, the
hypothesis-sharded search, which calls the two halves itself) runs
``_estimate`` as it stands.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from pano_tpu_torch.config import RansacOptions
from pano_tpu_torch.ops import align as align_ops
from pano_tpu_torch.ops import cuda_align, cuda_eigh, cuda_ransac
from pano_tpu_torch.ops.cuda_ransac import inv3x3
from pano_tpu_torch.timer import span

Sampler = Callable[[torch.Tensor], torch.Tensor]


class RansacResult(NamedTuple):
    H: torch.Tensor             # (3, 3) float32, normalized so H[2,2] = 1
    inlier_count: torch.Tensor  # () int32
    num_matches: torch.Tensor   # () int32, valid matches scored
    inlier_mask: torch.Tensor   # (M,) bool, inliers of the final H
    ok: torch.Tensor            # () bool, inlier_count >= min_inliers


def _normalization_transform(
    pts: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Hartley similarity for masked points, batched over leading dims:
    pts (..., M, 2), mask (..., M) -> (..., 3, 3)."""
    m = mask.to(pts.dtype)
    cnt = torch.clamp(m.sum(-1), min=1.0)
    mean = (pts * m[..., None]).sum(-2) / cnt[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
    mean_d = (d * m).sum(-1) / cnt
    s = _sqrt2(pts.dtype, pts.device) / torch.clamp(mean_d, min=1e-8)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    rows = [
        torch.stack([s, zero, -s * mean[..., 0]], -1),
        torch.stack([zero, s, -s * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ]
    return torch.stack(rows, -2)


@functools.lru_cache(maxsize=16)
def _sqrt2(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """sqrt(2) as a () tensor on `device`, made there once (a tensor from
    a Python number would be a blocking upload at every call). A tensor
    numerator keeps the true division: `float / tensor` is a reciprocal
    times the number, which rounds differently."""
    return torch.full((), 2.0, dtype=dtype, device=device).sqrt()


def _apply_similarity(t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts @ t[:2, :2].T + t[:2, 2], batched."""
    return pts @ t[..., :2, :2].transpose(-1, -2) + t[..., None, :2, 2]


def project_points(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a homography to (M, 2) points."""
    w = h[2, 0] * pts[:, 0] + h[2, 1] * pts[:, 1] + h[2, 2]
    px = (h[0, 0] * pts[:, 0] + h[0, 1] * pts[:, 1] + h[0, 2]) / w
    py = (h[1, 0] * pts[:, 0] + h[1, 1] * pts[:, 1] + h[1, 2]) / w
    return torch.stack([px, py], -1)


def _inlier_mask(h, src, dst, valid, thresh: float) -> torch.Tensor:
    d2 = ((project_points(h, src) - dst) ** 2).sum(-1)
    return (d2 < thresh * thresh) & valid


def refine_homography(src, dst, mask) -> torch.Tensor:
    """Least-squares DLT over all masked correspondences: the eigenvector
    of A^T A (9x9) with the smallest eigenvalue, by K7's Jacobi sweeps
    (``cuda_eigh.smallest_eigvec9``; the JAX package's ``eigh`` is Jacobi
    on the TPU too), with no host sync."""
    t_src = _normalization_transform(src, mask)
    t_dst = _normalization_transform(dst, mask)
    sn = _apply_similarity(t_src, src)
    dn = _apply_similarity(t_dst, dst)
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    m = mask.to(src.dtype)[:, None]
    r1 = torch.stack(
        [-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], -1
    ) * m
    r2 = torch.stack(
        [zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], -1
    ) * m
    a = torch.cat([r1, r2], 0)                              # (2M, 9)
    h = cuda_eigh.smallest_eigvec9(a.T @ a).reshape(3, 3)   # K7
    h_full = inv3x3(t_dst) @ h @ t_src
    return h_full / h_full[2, 2]


# --- jax.random.randint, bit for bit ------------------------------------------
#
# JAX's threefry2x32 PRNG with the jax_threefry_partitionable counter
# layout (the default since jax 0.5): every uint32 lives in an int64 tensor
# masked to 32 bits, because torch's uint32 lacks most operations.

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0, x1), int64 tensors
    or Python integers, under the key (k0, k1): 20 rounds, a key injection
    after every 4 (jax._src.prng._threefry2x32_lowering)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _random_bits32(key: Tuple[int, int], n: int, device) -> torch.Tensor:
    """random_bits(key, 32, (n,)): the hash of the 64-bit counters 0..n-1
    (high word 0 below 2^32), its two words xor'ed."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(*key, torch.zeros_like(lo), lo)
    return b0 ^ b1


def _split(key: Tuple[int, int]):
    """split(key) into two keys: the hash of the counters 0 and 1 (in
    Python integers: a key never touches a device)."""
    return tuple(_threefry2x32(*key, 0, i) for i in range(2))


def prng_key(seed: int) -> Tuple[int, int]:
    """PRNGKey(seed) as two uint32 words: the seed is an int32, as in the
    JAX package (no x64), so the high word is 0 and the low word its two's
    complement."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"RANSAC seed {seed} is not an int32")
    return 0, seed & _M32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """jax.random.fold_in(key, data) for an int32 `data`: the hash of the
    counter pair (0, data) under the key."""
    return _threefry2x32(*key, 0, data & _M32)


@functools.lru_cache(maxsize=16)
def randint_bits_key(key: Tuple[int, int], n: int, s: int,
                     device: torch.device):
    """The two (n, s) bit planes of jax.random.randint(key, (n, s), ...)
    for an int32 result: random_bits of each half of the split key. They
    do not depend on the range, so they are kept."""
    k1, k2 = _split(key)
    return tuple(_random_bits32(k, n * s, device).reshape(n, s)
                 for k in (k1, k2))


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor,
                      span: torch.Tensor) -> torch.Tensor:
    """randint's reduction of its two bit planes into [0, span): (higher %
    span) * m + (lower % span), modulo span, in wrapping uint32
    arithmetic, with m = ((2^16 % span)^2 mod 2^32) % span
    (jax._src.random._randint). Up to span = 2^16 nothing wraps and m is
    2^32 % span; above it the square is 2^32, which wraps to m = 0. So it
    is ((higher % span) * m + lower) % span with those m, in int64 (a
    product below 2^32, a sum below 2^33). `span` is a () int64 tensor
    >= 1."""
    mult = (2**32 % span) * (span <= 2**16)
    return (higher % span * mult + lower) % span


def default_sampler(
    num_iterations: int, num_samples: int, seed: int, device
) -> Sampler:
    """The JAX package's table: jax.random.randint(PRNGKey(seed),
    (num_iterations, num_samples), 0, max(n_valid, 1)), on `device`."""
    return key_sampler(prng_key(seed), num_iterations, num_samples, device)


def key_sampler(
    key: Tuple[int, int], num_iterations: int, num_samples: int, device
) -> Sampler:
    """jax.random.randint(key, (num_iterations, num_samples), 0,
    max(n_valid, 1)) on `device`, for a key given as its two words (the
    hypothesis-sharded search draws from fold_in(PRNGKey(seed), shard)).
    The bit planes are made once per (key, shape, device); a call reduces
    them by the device tensor n_valid, with no host sync."""
    higher, lower = randint_bits_key(tuple(key), num_iterations,
                                     num_samples, torch.device(device))

    def sample(n_valid: torch.Tensor) -> torch.Tensor:
        span = torch.clamp(n_valid.to(device=higher.device,
                                      dtype=torch.int64), min=1)
        return randint_from_bits(higher, lower, span)

    return sample


def ransac_best_hypothesis(
    pts_src: torch.Tensor,
    pts_dst: torch.Tensor,
    valid: torch.Tensor,
    num_iterations: int,
    num_samples: int,
    distance_threshold: float,
    sampler: Sampler,
):
    """Score `num_iterations` hypotheses; return (best_H (3,3), count ()):
    the sampler's table, then K10 (``cuda_ransac.search``: the DLTs, the
    scores and the first maximum)."""
    with span("ransac.search"):
        n_valid = valid.sum(dtype=torch.int32)
        idx = sampler(n_valid).to(device=pts_src.device, dtype=torch.int64)
        if idx.shape != (num_iterations, num_samples):
            raise ValueError(
                f"sampler returned {tuple(idx.shape)}, want "
                f"{(num_iterations, num_samples)}"
            )
        _, _, best_h, best_count = cuda_ransac.search(
            pts_src, pts_dst, valid, idx, distance_threshold)
        return best_h, best_count


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a () index tensor, on the device: indexing by a 0-d
    tensor reads it on the host (`.item()`)."""
    return x.index_select(0, i.reshape(1))[0]


def ransac_homography(
    pts_src: torch.Tensor,     # (M, 2) f32, valid rows first
    pts_dst: torch.Tensor,     # (M, 2) f32
    valid: torch.Tensor,       # (M,) bool
    opts: RansacOptions,
    sampler: Optional[Sampler] = None,
    images: Tuple[torch.Tensor, ...] = (),
) -> RansacResult:
    """Estimate H mapping src -> dst: RANSAC, then optional refine, then
    the optional direct alignment (``opts.align_iterations``) on
    `images`, (left, right): the (h, w, 3) uint8 images that `pts_dst`
    and `pts_src` lie in, which the option requires. On the card
    with the default table, as a replay of the estimate's CUDA graph
    (see the module's docstring)."""
    images = tuple(images) if opts.align_iterations else ()
    with span("ransac"):
        if sampler is None and pts_src.device.type == "cuda":
            return _graphed_estimate(pts_src, pts_dst, valid, opts, images)
        return _estimate(pts_src, pts_dst, valid, opts, sampler, images)


def _estimate(pts_src, pts_dst, valid, opts: RansacOptions,
              sampler: Optional[Sampler] = None,
              images: Tuple[torch.Tensor, ...] = ()) -> RansacResult:
    """The whole estimate, launch by launch: the hypotheses' search, then
    the guard, masks, refine and alignment."""
    if sampler is None:
        sampler = default_sampler(
            opts.num_iterations, opts.num_samples, opts.seed, pts_src.device
        )
    best_h, best_count = ransac_best_hypothesis(
        pts_src, pts_dst, valid, opts.num_iterations, opts.num_samples,
        opts.distance_threshold, sampler,
    )
    return finalize_ransac(best_h, best_count, pts_src, pts_dst, valid, opts,
                           images)


def finalize_ransac(
    best_h: torch.Tensor,
    best_count: torch.Tensor,
    pts_src: torch.Tensor,
    pts_dst: torch.Tensor,
    valid: torch.Tensor,
    opts: RansacOptions,
    images: Tuple[torch.Tensor, ...] = (),
) -> RansacResult:
    """Degeneracy guard + inlier mask + optional least-squares refine +
    optional direct alignment on `images` (left, right). The count, the
    mask and the gate stay the matches' support of the refined H: the
    alignment moves H by tenths of a pixel."""
    if opts.align_iterations and not images:
        raise ValueError("ransac.align_iterations needs the two images: "
                         "only the fused estimate (estimate_row) aligns")
    with span("ransac.finalize"):
        n_valid = valid.sum(dtype=torch.int32)
        enough = n_valid >= opts.num_samples
        eye = torch.eye(3, dtype=pts_src.dtype, device=pts_src.device)
        best_h = torch.where(torch.isfinite(best_h).all() & enough, best_h,
                             eye)
        best_count = best_count.to(torch.int32)
        mask0 = _inlier_mask(
            best_h, pts_src, pts_dst, valid, opts.distance_threshold
        )
        if opts.refine:
            refined = refine_homography(pts_src, pts_dst, mask0)
            mask_r = _inlier_mask(
                refined, pts_src, pts_dst, valid, opts.distance_threshold
            )
            count_r = mask_r.sum(dtype=torch.int32)
            use_refined = (torch.isfinite(refined).all()
                           & (count_r >= best_count))
            best_h = torch.where(use_refined, refined, best_h)
            mask0 = torch.where(use_refined, mask_r, mask0)
            best_count = torch.where(use_refined, count_r, best_count)
        if opts.align_iterations:
            best_h = align_ops.align_homography(best_h, *images,
                                                opts.align_iterations)
        ok = (best_count >= opts.min_inliers) & enough
        return RansacResult(
            H=best_h, inlier_count=best_count, num_matches=n_valid,
            inlier_mask=mask0, ok=ok,
        )


# --- the estimate as a CUDA graph --------------------------------------------

# Engagement of the graph since the last reset: tests and chip_smoke.py
# read them. It is not tracing; the profiler's pano.ransac.replay is.
graph_captures = 0
graph_replays = 0

# Graphs kept, the least recently used dropped first. Each holds a private
# memory pool with the estimate's temporaries: the search's table and
# K10's outputs, the finalize's (M,) and (2M, 9) planes (the (N, M)
# scoring planes of the search in plain torch reserved 230 MiB at K =
# 8192 and 1000 hypotheses on an H100).
GRAPH_CACHE_SIZE = 4

# The hand-written kernels an estimate launches, whose launch counters a
# replay advances by the launches its graph holds: K7, K10 and K11.
_COUNTED = (cuda_eigh, cuda_ransac, cuda_align)

_graphs: "collections.OrderedDict[tuple, _GraphedEstimate]" = \
    collections.OrderedDict()
_graphs_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every capture on `device` warms up and captures on,
    one per device, so that cuBLAS's workspace for it is made once, before
    any capture."""
    return torch.cuda.Stream(device)


class _GraphedEstimate:
    """``_estimate`` captured for one key: the graph, its input buffers
    (the match points and flags, and the two images where the estimate
    aligns) and captured outputs, and every tensor the graph reads that it did not
    allocate (the default table's bit planes and sqrt(2), which the lru
    caches may drop: a freed, reused address would corrupt later replays).
    Dropping the entry drops the graph and its pool."""

    def __init__(self, inputs, opts: RansacOptions):
        """Make the buffers and the held tensors on the caller's stream."""
        device = inputs[0].device
        self.held = (
            randint_bits_key(prng_key(opts.seed), opts.num_iterations,
                             opts.num_samples, device),
            _sqrt2(inputs[0].dtype, device),
        )
        self.inputs = tuple(t.clone(memory_format=torch.contiguous_format)
                            for t in inputs)
        self.opts = opts
        self.graph = torch.cuda.CUDAGraph()

    def capture(self) -> RansacResult:
        """Warm up (cuBLAS on the side stream, the kernels' library, the
        tables) and capture, both on the side stream; returns the warm-up's
        result, which is the first call's."""
        global graph_captures
        device = self.inputs[0].device
        stream = torch.cuda.current_stream(device)
        side = _capture_stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            first = _estimate(*self.inputs[:3], self.opts, None,
                              self.inputs[3:])
        for t in first:
            t.record_stream(stream)
        before = [mod.launches for mod in _COUNTED]
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.outputs = _estimate(*self.inputs[:3], self.opts, None,
                                     self.inputs[3:])
        # A capture runs nothing; each replay runs the kernel launches it
        # holds.
        self.held_launches = [mod.launches - n
                              for mod, n in zip(_COUNTED, before)]
        for mod, n in zip(_COUNTED, before):
            mod.launches = n
        stream.wait_stream(side)
        graph_captures += 1
        return first

    def replay(self, inputs) -> RansacResult:
        """Copy `inputs` in, replay, and return copies of the outputs (a
        later replay overwrites the captured ones), all on the current
        stream with no host sync."""
        global graph_replays
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        with span("ransac.replay"):
            self.graph.replay()
        for mod, n in zip(_COUNTED, self.held_launches):
            mod.launches += n
        graph_replays += 1
        return RansacResult(*(t.clone() for t in self.outputs))


def _graphed_estimate(pts_src, pts_dst, valid, opts: RansacOptions,
                      images: Tuple[torch.Tensor, ...] = ()) -> RansacResult:
    """``_estimate`` with the default table on the card: the first call
    of a key captures (its result is the warm-up's), later calls replay."""
    inputs = (pts_src, pts_dst, valid, *images)
    device = pts_src.device
    key = (device, torch.cuda.current_stream(device).cuda_stream, opts,
           tuple((t.shape, t.dtype) for t in inputs))
    with _graphs_lock:
        entry = _graphs.get(key)
        if entry is not None:
            _graphs.move_to_end(key)
            return entry.replay(inputs)
        entry = _GraphedEstimate(inputs, opts)
        first = entry.capture()
        _graphs[key] = entry
        if len(_graphs) > GRAPH_CACHE_SIZE:
            _graphs.popitem(last=False)
        return first
