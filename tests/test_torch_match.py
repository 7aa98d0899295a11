"""pano_tpu_torch descriptors (K2's plain version), matcher cores (K3's
plain version) and the match epilogue vs the JAX package's XLA paths on
the CPU. Tolerance: none, every output is bit-identical (descriptor
entries are u8 values, so every SSD is an exact f32 integer)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pano_tpu.ops import harris as JH  # noqa: E402
from pano_tpu.ops import match as JM  # noqa: E402
from pano_tpu_torch.ops import cuda_gather, cuda_match  # noqa: E402
from pano_tpu_torch.ops import harris as TH  # noqa: E402
from pano_tpu_torch.ops import match as TM  # noqa: E402


def _keypoints(rng, h, w, k):
    """Random keypoints plus every kind of border case, some invalid."""
    xs = rng.integers(0, w, k).astype(np.int32)
    ys = rng.integers(0, h, k).astype(np.int32)
    edge = [(0, 0), (1, 1), (2, 2), (w - 1, h - 1), (w - 3, h - 3),
            (w - 2, 5), (5, h - 2), (2, h - 3), (w - 3, 2)]
    for i, (x, y) in enumerate(edge):
        xs[i], ys[i] = x, y
    valid = rng.random(k) > 0.1
    xy = np.stack([xs, ys], -1)
    resp = np.ones(k, np.float32)
    return (
        JH.KeyPoints(jnp.asarray(xy), jnp.asarray(resp), jnp.asarray(valid)),
        TH.KeyPoints(torch.from_numpy(xy), torch.from_numpy(resp),
                     torch.from_numpy(valid)),
    )


@pytest.mark.parametrize("patch", [5, 7])
def test_descriptors_bit_identical(patch):
    rng = np.random.default_rng(21)
    h, w = 40, 70
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    kj, kt = _keypoints(rng, h, w, 200)
    dj, bj = JM.extract_patch_descriptors(
        jnp.asarray(img), kj, patch, use_pallas=False
    )
    dt, bt = TM.extract_patch_descriptors(torch.from_numpy(img), kt, patch)
    d_pad = 128 if patch == 5 else 256  # p*p*3 rounded up to 128
    assert dt.shape == (200, d_pad) and dt.dtype == torch.float32
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert not bt[:9].all()  # the planted border cases are excluded
    np.testing.assert_array_equal(
        cuda_gather.gather_patches_plain(
            torch.from_numpy(img), kt.xy, bt, patch
        ).numpy(),
        dt.numpy(),
    )


def _random_descs(rng, k, d_used=75, d_pad=128, dup_frac=0.3):
    """u8-valued descriptors with duplicated rows (exact SSD ties)."""
    desc = rng.integers(0, 256, (k, d_pad)).astype(np.float32)
    desc[:, d_used:] = 0.0
    n_dup = int(k * dup_frac)
    desc[rng.integers(0, k, n_dup)] = desc[rng.integers(0, k, n_dup)]
    valid = rng.random(k) > 0.15
    return desc, valid


@pytest.mark.parametrize(
    "ratio,cross", [(0.0, False), (0.85, False), (0.0, True), (0.85, True)]
)
def test_match_descriptors_bit_identical(ratio, cross):
    rng = np.random.default_rng(22)
    dq, vq = _random_descs(rng, 300)
    dt, vt = _random_descs(rng, 437)
    dt[:40] = dq[:40]                 # exact matches for the ratio test
    dt[40:50] = dq[:10]               # duplicated train rows: best == second
    thresh = 1.2e6
    mj = JM.match_descriptors(
        jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt),
        thresh, ratio_thresh=ratio, cross_check=cross, block_size=0,
        use_pallas=False,
    )
    mt = TM.match_descriptors(
        torch.from_numpy(dq), torch.from_numpy(vq), torch.from_numpy(dt),
        torch.from_numpy(vt), thresh, ratio_thresh=ratio, cross_check=cross,
    )
    assert mt.train_idx.dtype == torch.int32 and mt.valid.dtype == torch.bool
    for name, a, b in (
        ("valid", mj.valid, mt.valid),
        ("idx", mj.train_idx, mt.train_idx),
        ("ssd", mj.ssd, mt.ssd),
    ):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert int(mt.count()) > 0


def test_match_cores_match_jax_streaming_cores():
    """The four cores against the JAX package's dense cores, including
    invalid columns (col_best row 0) and duplicate rows."""
    from pano_tpu.ops import pallas_match as PM

    rng = np.random.default_rng(23)
    dq, vq = _random_descs(rng, 200)
    dt, vt = _random_descs(rng, 150)
    vt[:20] = False
    want = PM._cores_xla(
        jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt)
    )
    got = cuda_match.match_cores(
        torch.from_numpy(dq), torch.from_numpy(vq), torch.from_numpy(dt),
        torch.from_numpy(vt),
    )
    for name, a, b in zip(("best", "idx", "second", "col_best"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert (got[3][:20] == 0).all()


def test_match_all_invalid_train():
    rng = np.random.default_rng(24)
    dq, vq = _random_descs(rng, 64)
    dt, _ = _random_descs(rng, 96)
    vt = np.zeros(96, bool)
    mj = JM.match_descriptors(
        jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt),
        1e9, use_pallas=False,
    )
    mt = TM.match_descriptors(
        torch.from_numpy(dq), torch.from_numpy(vq), torch.from_numpy(dt),
        torch.from_numpy(vt), 1e9,
    )
    assert int(mt.count()) == 0
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_array_equal(
        mt.train_idx.numpy(), np.asarray(mj.train_idx)
    )


def test_gather_match_points_identical():
    rng = np.random.default_rng(25)
    k = 128
    xy_q = rng.integers(0, 500, (k, 2)).astype(np.int32)
    xy_t = rng.integers(0, 500, (k, 2)).astype(np.int32)
    idx = rng.integers(0, k, k).astype(np.int32)
    valid = rng.random(k) > 0.4
    ssd = rng.random(k).astype(np.float32)
    ones = np.ones(k, np.float32)
    kv = np.ones(k, bool)
    mj = JM.Matches(jnp.asarray(idx), jnp.asarray(ssd), jnp.asarray(valid))
    mt = TM.Matches(torch.from_numpy(idx), torch.from_numpy(ssd),
                    torch.from_numpy(valid))
    want = JM.gather_match_points(
        JH.KeyPoints(jnp.asarray(xy_q), jnp.asarray(ones), jnp.asarray(kv)),
        JH.KeyPoints(jnp.asarray(xy_t), jnp.asarray(ones), jnp.asarray(kv)),
        mj,
    )
    got = TM.gather_match_points(
        TH.KeyPoints(torch.from_numpy(xy_q), torch.from_numpy(ones),
                     torch.from_numpy(kv)),
        TH.KeyPoints(torch.from_numpy(xy_t), torch.from_numpy(ones),
                     torch.from_numpy(kv)),
        mt,
    )
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_wrappers_reject_unsupported_device():
    meta = dict(device="meta")
    img = torch.empty((8, 8, 3), dtype=torch.uint8, **meta)
    xy = torch.empty((4, 2), dtype=torch.int32, **meta)
    bv = torch.empty((4,), dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gather.gather_patches(img, xy, bv, 5)
    d = torch.empty((4, 128), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_match.match_cores(d, bv, d, bv)
    with pytest.raises(ValueError):
        cuda_gather.gather_patches(
            torch.zeros((8, 8, 3), dtype=torch.uint8),
            torch.zeros((4, 2), dtype=torch.int64),
            torch.zeros(4, dtype=torch.bool), 5,
        )
