"""pano_tpu_torch Harris detection (K1's plain version, top-K, decode) vs
the JAX package's XLA chain on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from pano_tpu.config import HarrisOptions as JaxHarrisOptions  # noqa: E402
from pano_tpu.ops import harris as JH  # noqa: E402
from pano_tpu_torch.config import HarrisOptions  # noqa: E402
from pano_tpu_torch.ops import cuda_harris  # noqa: E402
from pano_tpu_torch.ops import harris as TH  # noqa: E402


def xla_scores(img, opts):
    """The JAX XLA chain's NMS'd scores (tests/test_pallas_harris.py)."""
    h, w = img.shape[:2]
    gray = JH.bgr_to_gray_f32(jnp.asarray(img))
    resp = JH.harris_response(gray, opts.k)
    nmax = JH._neighbor_max(resp, 3)
    ys = lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = lax.broadcasted_iota(jnp.int32, (h, w), 1)
    border = (ys >= 1) & (ys < h - 1) & (xs >= 1) & (xs < w - 1)
    return np.asarray(
        jnp.where(
            (resp > opts.nms_thresh) & (resp > nmax) & border, resp, -jnp.inf
        )
    )


def blockfold(scores):
    pr, pc = scores.shape[0] % 2, scores.shape[1] % 2
    if pr or pc:
        scores = np.pad(scores, ((0, pr), (0, pc)), constant_values=-np.inf)
    rf = np.maximum(scores[0::2], scores[1::2])
    return np.maximum(rf[:, 0::2], rf[:, 1::2])


@pytest.mark.parametrize("shape", [(150, 600), (37, 61)])
def test_plain_scores_match_xla_chain(shape):
    """The bar of tests/test_pallas_harris.py:61-76: peak classification
    agrees on > 99.95% of block slots; on shared peaks rel > 2e-4 on
    < 0.5% of them and rel < 0.02 everywhere (the offset bits in the two
    mantissa LSBs are a <= 3 ulp difference)."""
    img = np.random.default_rng(11).integers(
        0, 256, shape + (3,), dtype=np.uint8
    )
    opts = HarrisOptions()
    want = blockfold(xla_scores(img, opts))
    got = cuda_harris.harris_scores(
        torch.from_numpy(img), opts.k, opts.nms_thresh
    ).numpy()
    assert got.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    assert got.shape == want.shape
    same_peaks = np.isneginf(got) == np.isneginf(want)
    assert same_peaks.mean() > 0.9995, same_peaks.mean()
    both = ~np.isneginf(got) & ~np.isneginf(want)
    assert both.any()
    rel = np.abs(got[both] - want[both]) / np.maximum(np.abs(want[both]), 1.0)
    assert (rel > 2e-4).mean() < 0.005, (rel > 2e-4).mean()
    assert rel.max() < 0.02, rel.max()


def test_harris_response_bitwise_on_cpu():
    """Same f32 operations in the same order: the response planes agree
    bit for bit with the XLA chain on the CPU (tolerance: none)."""
    img = np.random.default_rng(12).integers(0, 256, (64, 96, 3), np.uint8)
    want = np.asarray(
        JH.harris_response(JH.bgr_to_gray_f32(jnp.asarray(img)), 0.04)
    )
    got = TH.harris_response(
        TH.bgr_to_gray_f32(torch.from_numpy(img)), 0.04
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nms", [3, 5])
def test_harris_detect_keypoints_match_jax(nms):
    """Keypoint (x, y) sets agree on >= 99.5% of the valid keypoints, with
    K = 512 (the JAX package's approximate top-K is exact off the TPU)."""
    img = np.random.default_rng(13).integers(0, 256, (150, 600, 3), np.uint8)
    kj = JH.harris_detect(
        jnp.asarray(img),
        JaxHarrisOptions(max_keypoints=512, nms_neighborhood=nms),
    )
    kt = TH.harris_detect(
        torch.from_numpy(img),
        HarrisOptions(max_keypoints=512, nms_neighborhood=nms),
    )
    assert kt.xy.dtype == torch.int32 and kt.xy.shape == (512, 2)
    assert kt.response.dtype == torch.float32 and kt.valid.dtype == torch.bool
    vj = np.asarray(kj.valid)
    vt = kt.valid.numpy()
    assert vj.sum() == vt.sum()
    sj = {tuple(p) for p in np.asarray(kj.xy)[vj]}
    st = {tuple(p) for p in kt.xy.numpy()[vt]}
    assert len(sj & st) >= 0.995 * len(sj), (len(sj & st), len(sj))


def test_harris_detect_pads_tiny_images():
    img = np.random.default_rng(14).integers(0, 256, (20, 24, 3), np.uint8)
    kt = TH.harris_detect(torch.from_numpy(img), HarrisOptions())
    kj = JH.harris_detect(jnp.asarray(img), JaxHarrisOptions())
    assert kt.xy.shape == (8192, 2)
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
    np.testing.assert_array_equal(
        kt.response.numpy(), np.asarray(kj.response)
    )


def test_topk_tie_order_lowest_index_first():
    """Planted equal scores come out lowest flat index first, as
    lax.top_k orders them."""
    flat = torch.tensor(
        [1.0, 3.0, -np.inf, 3.0, 2.0, 3.0, 3.0, 2.0], dtype=torch.float32
    )
    vals, idx = TH._topk_stable(flat, 5)
    assert idx.tolist() == [1, 3, 5, 6, 4]
    assert vals.tolist() == [3.0, 3.0, 3.0, 3.0, 2.0]


def test_detect_ties_on_repeated_corners():
    """Identical squares at positions of equal parity give bit-equal
    scores; with K below the number of tied peaks, the kept keypoints are
    those of the lowest block indices, the same as the JAX package's."""
    img = np.full((64, 160, 3), 20, np.uint8)
    for y in range(8, 56, 16):
        for x in range(8, 152, 16):
            img[y:y + 6, x:x + 6] = (200, 120, 40)
    scores = cuda_harris.harris_scores(
        torch.from_numpy(img), 0.04, 1e6
    ).numpy().reshape(-1)
    finite = scores[np.isfinite(scores)]
    assert len(finite) > len(np.unique(finite)), "no tied scores planted"
    k = 7
    order = np.argsort(-scores, kind="stable")[:k]
    kt = TH.harris_detect(
        torch.from_numpy(img), HarrisOptions(max_keypoints=k)
    )
    w2 = scores.size // 32
    got_blocks = (kt.xy[:, 1] // 2 * w2 + kt.xy[:, 0] // 2).numpy()
    np.testing.assert_array_equal(got_blocks, order)
    kj = JH.harris_detect(
        jnp.asarray(img), JaxHarrisOptions(max_keypoints=k, topk_method="exact")
    )
    np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))


def test_wrapper_rejects_unsupported_device_and_dtype():
    with pytest.raises(ValueError):
        cuda_harris.harris_scores(torch.zeros((8, 8, 3)), 0.04, 1e6)
    meta = torch.empty((8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_harris.harris_scores(meta, 0.04, 1e6)
