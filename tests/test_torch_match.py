"""pano_tpu_torch descriptors and border flags (K2's plain version),
matcher cores (K3's plain version) and the match epilogue vs the JAX
package's XLA paths (and K2's interior rows vs the Pallas gather in
interpret mode) on the CPU. Tolerance: none, every output is
bit-identical (descriptor entries are u8 values, so every SSD is an exact
f32 integer)."""

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
    assert bt.dtype == torch.bool
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert not bt[:9].all()  # the planted border cases are excluded
    dp, bp = cuda_gather.gather_patches_plain(
        torch.from_numpy(img), kt.xy, kt.valid, patch
    )
    np.testing.assert_array_equal(dp.numpy(), dt.numpy())
    np.testing.assert_array_equal(bp.numpy(), bt.numpy())


def _border_lines(rng, h, w, b):
    """Keypoints on each border line of a p = 2b + 1 patch: inside
    (x = b, x = w - b - 1) and just outside (x = b - 1, x = w - b), the
    same for y, each beside a random interior coordinate, and the four
    corners of the valid region and of the image."""
    xy = []
    for x in (b, w - b - 1, b - 1, w - b):
        xy.append((x, int(rng.integers(b, h - b))))
    for y in (b, h - b - 1, b - 1, h - b):
        xy.append((int(rng.integers(b, w - b)), y))
    for x in (b, w - b - 1, b - 1, w - b, 0, w - 1):
        for y in (b, h - b - 1, b - 1, h - b, 0, h - 1):
            xy.append((x, y))
    return np.asarray(xy, np.int32)


def _edge_case(case, p, rng):
    """(image, xy, valid) of one descriptor edge case at patch size p."""
    b = p // 2
    h, w = 3 * p + 4, 4 * p + 3
    if case == "smaller_than_p":
        h, w = p - 1, p + 3
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if case == "border_lines":
        xy = _border_lines(rng, h, w, b)
        valid = rng.random(len(xy)) > 0.1
        valid[:8] = True
    elif case == "smaller_than_p":
        xy = np.stack([rng.integers(0, w, 40), rng.integers(0, h, 40)], -1)
        valid = np.ones(40, bool)
    elif case == "all_invalid":
        xy = np.stack([rng.integers(b, w - b, 40),
                       rng.integers(b, h - b, 40)], -1)
        valid = np.zeros(40, bool)
    elif case == "k1":
        xy = np.asarray([[w // 2, h // 2]])
        valid = np.ones(1, bool)
    else:  # "wild_invalid": invalid rows far outside the image
        wild = [(-10**6, 10**6), (10**6, -10**6), (-10**6, -10**6),
                (10**6, 10**6), (2**30, 5), (5, -2**30), (-1, -1)]
        inner = np.stack([rng.integers(b, w - b, 20),
                          rng.integers(b, h - b, 20)], -1)
        xy = np.concatenate([np.asarray(wild), inner])
        valid = np.concatenate([np.zeros(len(wild), bool),
                                rng.random(20) > 0.2])
    return img, xy.astype(np.int32), valid


@pytest.mark.parametrize("case", ["border_lines", "smaller_than_p",
                                  "all_invalid", "k1", "wild_invalid"])
@pytest.mark.parametrize("patch", [3, 5, 7, 9])
def test_descriptor_edge_cases_match_jax(patch, case):
    """gather_patches_plain and extract_patch_descriptors against JAX's
    extract_patch_descriptors(use_pallas=False), exact: border lines,
    images smaller than the patch (every row border-invalid, all zeros),
    all rows invalid, one keypoint, invalid rows far outside the image."""
    rng = np.random.default_rng(31 + patch)
    img, xy, valid = _edge_case(case, patch, rng)
    k = len(xy)
    dj, bj = JM.extract_patch_descriptors(
        jnp.asarray(img),
        JH.KeyPoints(jnp.asarray(xy), jnp.ones(k, jnp.float32),
                     jnp.asarray(valid)),
        patch, use_pallas=False,
    )
    kt = TH.KeyPoints(torch.from_numpy(xy), torch.ones(k),
                      torch.from_numpy(valid))
    d_pad = cuda_gather.descriptor_width(patch)
    for dt, bt in (
        cuda_gather.gather_patches_plain(torch.from_numpy(img), kt.xy,
                                         kt.valid, patch),
        TM.extract_patch_descriptors(torch.from_numpy(img), kt, patch),
    ):
        assert dt.shape == (k, d_pad) and bt.shape == (k,)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        assert not dt[~bt].any() and not dt[:, patch * patch * 3:].any()
    n_valid = int(np.asarray(bj).sum())
    if case in ("smaller_than_p", "all_invalid"):
        assert n_valid == 0
    elif case == "border_lines":
        # Per line: inside, inside, outside, outside.
        assert np.asarray(bj)[:8].tolist() == [True, True, False, False] * 2
    else:
        assert n_valid > 0


@pytest.mark.parametrize("patch", [3, 5, 7])
def test_descriptors_interior_match_pallas_gather(patch):
    """Interior rows against the TPU kernel itself
    (pano_tpu/ops/pallas_gather.gather_patches in interpret mode), its
    packed b | g << 8 | r << 16 patches unpacked to channel order."""
    from jax.experimental.pallas import tpu as pltpu

    from pano_tpu.ops import pallas_gather as PG

    rng = np.random.default_rng(41 + patch)
    h, w, k = 60, 300, 48
    b = patch // 2
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    plane = np.zeros((64, 384), np.int32)
    p32 = img.astype(np.int32)
    plane[:h, :w] = p32[..., 0] | (p32[..., 1] << 8) | (p32[..., 2] << 16)
    xs = rng.integers(b, w - b, k).astype(np.int32)
    ys = rng.integers(b, h - b, k).astype(np.int32)
    xs[:2], ys[:2] = (b, w - b - 1), (h - b - 1, b)  # interior corners
    with pltpu.force_tpu_interpret_mode():
        g = np.asarray(PG.gather_patches(
            jnp.asarray(plane), jnp.asarray(ys), jnp.asarray(xs), h=h, w=w,
            p=patch))                                      # (K, p*p)
    want = np.stack([g & 0xFF, (g >> 8) & 0xFF, (g >> 16) & 0xFF], -1)
    want = want.reshape(k, -1).astype(np.float32)
    xy = torch.from_numpy(np.stack([xs, ys], -1))
    desc, bv = cuda_gather.gather_patches(
        torch.from_numpy(img), xy, torch.ones(k, dtype=torch.bool), patch)
    assert bv.all()
    np.testing.assert_array_equal(desc[:, :patch * patch * 3].numpy(), want)


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


@pytest.mark.parametrize("seed", [26, 27])
def test_match_cores_plain_exact_over_full_u8_range(seed):
    """The exactness K3's integer tensor-core route relies on: with u8
    entries in all 128 columns (rows at 255 and at 0 included), every
    dot product, norm sum and SSD is an integer below 2^24, so the f32
    plain cores equal the same cores computed in int64."""
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 256, (300, 128))
    dt = rng.integers(0, 256, (437, 128))
    dq[:8], dt[:6] = 255, 255
    dq[8:12], dt[6:10] = 0, 0
    dt[10:20] = dq[20:30]             # exact matches
    dt[20:25] = dt[10:15]             # duplicated train rows: ties
    vq, vt = rng.random(300) > 0.1, rng.random(437) > 0.1
    vt[:6] = True
    got = cuda_match.match_cores_plain(
        torch.from_numpy(dq.astype(np.float32)), torch.from_numpy(vq),
        torch.from_numpy(dt.astype(np.float32)), torch.from_numpy(vt),
    )

    big = np.iinfo(np.int64).max
    ssd = (dq * dq).sum(1)[:, None] + (dt * dt).sum(1)[None, :] \
        - 2 * dq @ dt.T
    assert ssd.max() < 2**24 and (dq * dq).sum(1).max() == 128 * 255**2
    ssd = np.where(vt[None, :], ssd, big)
    rows = np.arange(300)
    idx = ssd.argmin(1)
    best = ssd[rows, idx]
    second = np.where(np.arange(437)[None, :] == idx[:, None], big,
                      ssd).min(1)
    col_best = np.where(vq[:, None], ssd, big).argmin(0)

    def as_f32(x):
        return np.where(x == big, np.inf, x).astype(np.float32)

    np.testing.assert_array_equal(got[0].numpy(), as_f32(best))
    np.testing.assert_array_equal(got[1].numpy(), idx.astype(np.int32))
    np.testing.assert_array_equal(got[2].numpy(), as_f32(second))
    np.testing.assert_array_equal(got[3].numpy(), col_best.astype(np.int32))


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
    kv = torch.empty((4,), dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gather.gather_patches(img, xy, kv, 5)
    d = torch.empty((4, 128), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_match.match_cores(d, kv, d, kv)
    cpu = (torch.zeros((8, 8, 3), dtype=torch.uint8),
           torch.zeros((4, 2), dtype=torch.int32),
           torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        cuda_gather.gather_patches(cpu[0], cpu[1].long(), cpu[2], 5)
    with pytest.raises(ValueError, match="odd"):
        cuda_gather.gather_patches(*cpu, 4)
    with pytest.raises(ValueError, match="validity"):
        cuda_gather.gather_patches(cpu[0], cpu[1], cpu[2][:3], 5)
