"""pano_tpu_torch RANSAC vs the JAX package's on the CPU: the default
sample table against jax.random.randint, and the estimate with the JAX
table injected so both sides score the same hypotheses."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano_tpu.config import RansacOptions as JaxRansacOptions  # noqa: E402
from pano_tpu.ops import ransac as JR  # noqa: E402
from pano_tpu_torch.config import RansacOptions  # noqa: E402
from pano_tpu_torch.ops import cuda_ransac as CR  # noqa: E402
from pano_tpu_torch.ops import ransac as TR  # noqa: E402


def jax_sampler(seed, n, s=4):
    """The JAX package's table (ransac.py:269-274), as the port's sampler."""

    def sample(n_valid):
        idx = jax.random.randint(
            jax.random.PRNGKey(seed), (n, s), 0, max(int(n_valid), 1)
        )
        return torch.from_numpy(np.array(idx)).long()

    return sample


def test_solve8_matches_jax():
    """rel 1e-5: the same pivots and elimination order in f32."""
    rng = np.random.default_rng(31)
    a = rng.standard_normal((64, 8, 8)).astype(np.float32)
    a += 4.0 * np.eye(8, dtype=np.float32)
    b = rng.standard_normal((64, 8)).astype(np.float32)
    want = np.asarray(jax.vmap(JR._solve8)(jnp.asarray(a), jnp.asarray(b)))
    got = CR._solve8(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, np.linalg.solve(a.astype(np.float64), b[..., None])[..., 0],
        rtol=1e-3, atol=1e-4,
    )


def test_inv3x3_matches_jax():
    """rel 1e-5 on random well-conditioned matrices."""
    rng = np.random.default_rng(32)
    m = rng.standard_normal((100, 3, 3)).astype(np.float32)
    m += 3.0 * np.eye(3, dtype=np.float32)
    want = np.asarray(JR.inv3x3(jnp.asarray(m)))
    got = CR.inv3x3(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _correspondences(rng, m=300, n_valid=250, outliers=60):
    h_true = np.array(
        [[1.02, 0.03, -40.0], [-0.01, 0.99, 7.0], [2e-5, -1e-5, 1.0]]
    )
    src = rng.uniform(0, 400, (m, 2))
    p = np.c_[src, np.ones(m)] @ h_true.T
    dst = p[:, :2] / p[:, 2:3] + rng.normal(0, 0.3, (m, 2))
    dst[:outliers] = rng.uniform(0, 400, (outliers, 2))
    valid = np.arange(m) < n_valid
    return src.astype(np.float32), dst.astype(np.float32), valid, h_true


def test_ransac_homography_matches_jax_with_injected_samples():
    """Same inlier count; H within rel 1e-4 (entries below 1e-3 in
    magnitude, the perspective terms, within abs 1e-7)."""
    rng = np.random.default_rng(33)
    src, dst, valid, h_true = _correspondences(rng)
    jopts = JaxRansacOptions(num_iterations=300, seed=5)
    topts = RansacOptions(num_iterations=300, seed=5)
    rj = JR.ransac_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jopts
    )
    rt = TR.ransac_homography(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(valid), topts, sampler=jax_sampler(5, 300),
    )
    assert bool(rt.ok) and bool(rj.ok)
    assert int(rt.inlier_count) == int(rj.inlier_count)
    assert int(rt.num_matches) == int(rj.num_matches) == 250
    hj, ht = np.asarray(rj.H), rt.H.numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(
        rt.inlier_mask.numpy(), np.asarray(rj.inlier_mask)
    )
    np.testing.assert_allclose(ht / ht[2, 2], h_true, rtol=0.02, atol=0.5)


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("table", ["default", "injected"])
def test_estimate_off_the_card_is_eager_and_never_captures(table, refine):
    """Off the card, with the default table or an injected one,
    ransac_homography is the eager estimate: no CUDA graph is captured or
    replayed, the result is _estimate's with the explicit table, field by
    field, and the JAX package's (the default table is JAX's own draw)."""
    rng = np.random.default_rng(36)
    src, dst, valid, _ = _correspondences(rng)
    jopts = JaxRansacOptions(num_iterations=300, seed=11, refine=refine)
    topts = RansacOptions(num_iterations=300, seed=11, refine=refine)
    pts = tuple(torch.from_numpy(x) for x in (src, dst, valid))
    explicit = TR.default_sampler(300, 4, 11, "cpu")
    rt = TR.ransac_homography(
        *pts, topts, sampler=None if table == "default" else explicit)
    assert (TR.graph_captures, TR.graph_replays, len(TR._graphs)) == (0, 0, 0)
    for got, want in zip(rt, TR._estimate(*pts, topts, explicit)):
        assert torch.equal(got, want)
    rj = JR.ransac_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jopts
    )
    assert bool(rt.ok) and bool(rj.ok)
    assert int(rt.inlier_count) == int(rj.inlier_count)
    assert int(rt.num_matches) == int(rj.num_matches) == 250
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_array_equal(
        rt.inlier_mask.numpy(), np.asarray(rj.inlier_mask)
    )


def test_best_hypothesis_matches_jax():
    """The core alone (no refine): the same winning hypothesis."""
    rng = np.random.default_rng(34)
    src, dst, valid, _ = _correspondences(rng)
    key = jax.random.PRNGKey(9)
    hj, cj = JR.ransac_best_hypothesis(
        key, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
        200, 4, 3.0,
    )
    ht, ct = TR.ransac_best_hypothesis(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(valid), 200, 4, 3.0, jax_sampler(9, 200),
    )
    assert int(ct) == int(cj)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4,
                               atol=1e-7)


def test_homography_from_4pts_matches_jax():
    """The fixed-order DLT (every sum and 3x3 product written out, as K10
    repeats it) against the JAX package's vmapped one on random samples of
    the correspondences: the same degenerate samples, and each H sends the
    data's corners within 0.01 px of where JAX's does (a random sample's
    system can be ill-conditioned, so entries differ by more than the
    estimate's rel 1e-4)."""
    rng = np.random.default_rng(41)
    src, dst, _, _ = _correspondences(rng, m=400, n_valid=400, outliers=0)
    idx = rng.integers(0, 400, (256, 4))
    idx[:3] = 9                                     # degenerate samples
    s4, d4 = src[idx], dst[idx]
    want = np.asarray(jax.vmap(JR.homography_from_4pts)(jnp.asarray(s4),
                                                        jnp.asarray(d4)))
    got = CR.homography_from_4pts(torch.from_numpy(s4),
                                  torch.from_numpy(d4)).numpy()
    ok = np.isfinite(want).all((1, 2))
    assert not ok[:3].any() and ok.sum() > 250 * 0.9
    np.testing.assert_array_equal(np.isfinite(got).all((1, 2)), ok)
    corners = np.array([[0, 0, 1], [400, 0, 1], [400, 400, 1], [0, 400, 1]],
                       np.float64)
    pa = corners @ got[ok].astype(np.float64).transpose(0, 2, 1)
    pb = corners @ want[ok].astype(np.float64).transpose(0, 2, 1)
    err = np.abs(pa[..., :2] / pa[..., 2:] - pb[..., :2] / pb[..., 2:])
    assert err.max() < 0.01


def test_search_first_maximum_wins_ties():
    """Exact integer translations: most hypotheses tie at the top count.
    The search returns the first of them, H and count, and its counts are
    the JAX package's hypothesis for hypothesis, so its winner is JAX's
    (argmax's first maximum on both sides)."""
    rng = np.random.default_rng(42)
    src = rng.integers(0, 400, (300, 2)).astype(np.float32)
    dst = src + np.float32([37.0, -5.0])
    valid = np.ones(300, bool)
    idx = jax_sampler(3, 200)(torch.tensor(300))
    hs, counts, best_h, best_count = CR.search(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
        idx, 3.0)
    top = counts == counts.max()
    first = int(top.nonzero()[0])
    assert int(top.sum()) > 100
    assert int(best_count) == int(counts.max()) == 300
    assert torch.equal(best_h, hs[first])
    hj = jax.vmap(JR.homography_from_4pts)(jnp.asarray(src[idx.numpy()]),
                                           jnp.asarray(dst[idx.numpy()]))
    cj = JR._score_hypotheses(hj, jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(valid), 3.0)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cj))
    bh, bc = JR.ransac_best_hypothesis(
        jax.random.PRNGKey(3), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(valid), 200, 4, 3.0)
    assert int(bc) == int(best_count)
    np.testing.assert_allclose(best_h.numpy(), np.asarray(bh), rtol=1e-4,
                               atol=1e-6)


def test_search_nan_hypotheses_score_zero():
    """A sample of one point repeated, or of two, is degenerate: its H is
    NaN throughout and it scores 0 (NaN compares False), as in the JAX
    package. With only such samples every count is 0, the first (index
    0) wins, and the finalize's guard returns the identity."""
    rng = np.random.default_rng(43)
    src, dst, valid, _ = _correspondences(rng, m=60, n_valid=50, outliers=5)
    pts = [torch.from_numpy(x) for x in (src, dst, valid)]
    idx = torch.tensor([[3, 3, 3, 3], [0, 1, 0, 1], [7, 8, 9, 10],
                        [4, 4, 5, 5]])
    hs, counts, best_h, best_count = CR.search(*pts, idx, 3.0)
    nan = torch.isnan(hs).flatten(1).all(-1)
    assert nan.tolist() == [True, True, False, True]
    assert counts.tolist()[:2] == [0, 0] and counts[3] == 0 and counts[2] > 30
    hj = jax.vmap(JR.homography_from_4pts)(jnp.asarray(src[idx.numpy()]),
                                           jnp.asarray(dst[idx.numpy()]))
    assert np.isnan(np.asarray(hj)[[0, 1, 3]]).all()
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(JR._score_hypotheses(
            hj, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), 3.0)))
    degenerate = idx[[0, 1, 3]]
    hs, counts, best_h, best_count = CR.search(*pts, degenerate, 3.0)
    assert counts.tolist() == [0, 0, 0] and int(best_count) == 0
    assert bool(torch.isnan(best_h).all())
    res = TR.finalize_ransac(best_h, best_count, *pts,
                             RansacOptions(refine=False))
    assert torch.equal(res.H, torch.eye(3)) and not bool(res.ok)


@pytest.mark.parametrize("bad", ["src_dtype", "valid_dtype", "idx_dtype",
                                 "idx_shape", "no_hypotheses", "device"])
def test_search_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper checks types, shapes and the device before any
    launch."""
    src = torch.zeros((10, 2))
    dst = torch.zeros((10, 2))
    valid = torch.ones(10, dtype=torch.bool)
    idx = torch.zeros((5, 4), dtype=torch.int64)
    if bad == "src_dtype":
        src = src.double()
    elif bad == "valid_dtype":
        valid = valid.int()
    elif bad == "idx_dtype":
        idx = idx.int()
    elif bad == "idx_shape":
        idx = idx[:, :3]
    elif bad == "no_hypotheses":
        idx = idx[:0]
    else:
        src, dst, valid, idx = (t.to("meta") for t in (src, dst, valid, idx))
    with pytest.raises(ValueError):
        CR.search(src, dst, valid, idx, 3.0)


@pytest.mark.parametrize("n_valid,outliers", [(3, 0), (8, 8)])
def test_finalize_gates(n_valid, outliers):
    """Fewer than 4 matches -> identity H, ok False; too few inliers
    (8 matches, all outliers) -> ok False. Both as the JAX package."""
    rng = np.random.default_rng(35)
    src, dst, valid, _ = _correspondences(
        rng, m=40, n_valid=n_valid, outliers=outliers
    )
    jopts = JaxRansacOptions(num_iterations=50)
    topts = RansacOptions(num_iterations=50)
    rj = JR.ransac_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jopts
    )
    rt = TR.ransac_homography(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(valid), topts, sampler=jax_sampler(0, 50),
    )
    assert not bool(rt.ok) and not bool(rj.ok)
    assert int(rt.num_matches) == int(rj.num_matches) == n_valid
    assert int(rt.inlier_count) == int(rj.inlier_count)
    if n_valid < 4:
        np.testing.assert_array_equal(rt.H.numpy(), np.eye(3))
        np.testing.assert_array_equal(np.asarray(rj.H), np.eye(3))


@pytest.mark.parametrize("shape", [(1000, 4), (37, 4), (5, 3)],
                         ids=["1000x4", "37x4", "5x3"])
@pytest.mark.parametrize("n_valid", [0, 1, 2, 3, 7, 100, 1000, 4097, 8191,
                                     8192])
@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_default_sampler_is_jax_randint(seed, n_valid, shape):
    """The default table is jax.random.randint(PRNGKey(seed), shape, 0,
    max(n_valid, 1)) exactly (this jax's threefry counter layout), with
    n_valid given as a device tensor."""
    want = jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                              max(n_valid, 1))
    got = TR.default_sampler(*shape, seed=seed, device="cpu")(
        torch.tensor(n_valid, dtype=torch.int32))
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.from_numpy(np.array(want)).long())


def test_default_sampler_layout_is_jax_default():
    """The port draws with the partitionable threefry counter layout, which
    this jax uses by default; a table for a span above 2^16 (whose 2^32 %
    span wraps) matches too."""
    assert jax.config.jax_threefry_partitionable
    span = 65537 * 3
    want = jax.random.randint(jax.random.PRNGKey(3), (64, 4), 0, span)
    got = TR.default_sampler(64, 4, seed=3, device="cpu")(
        torch.tensor(span, dtype=torch.int32))
    assert torch.equal(got, torch.from_numpy(np.array(want)).long())


def test_default_sampler_is_seeded_and_in_range():
    s1 = TR.default_sampler(100, 4, seed=3, device="cpu")
    s2 = TR.default_sampler(100, 4, seed=3, device="cpu")
    n = torch.tensor(17, dtype=torch.int32)
    a, b = s1(n), s1(n)
    assert a.shape == (100, 4) and a.dtype == torch.int64
    assert torch.equal(a, b) and torch.equal(a, s2(n))
    assert int(a.min()) >= 0 and int(a.max()) < 17
    z = s1(torch.tensor(0, dtype=torch.int32))
    assert int(z.max()) == 0


@pytest.mark.parametrize("seed,m,n_valid,outliers",
                         [(36, 300, 250, 60), (37, 800, 700, 200),
                          (38, 60, 40, 0)])
def test_refine_homography_matches_jax(seed, m, n_valid, outliers):
    """The refine alone (K7's plain version in place of eigh) on the
    inliers of the true H: test_ransac_homography_matches_jax's bar."""
    rng = np.random.default_rng(seed)
    src, dst, valid, h_true = _correspondences(rng, m, n_valid, outliers)
    mask = valid & (np.arange(m) >= outliers)
    hj = np.asarray(JR.refine_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask)))
    ht = TR.refine_homography(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(ht, h_true, rtol=0.02, atol=0.5)


def _host_reads(fn):
    """The operations of fn() that bring a device value to the host
    (`.item()`, a 0-d tensor index, int() or bool() of a tensor) or that
    need one (torch.linalg.eigh's error check). A blocking upload shows
    only on the card (tests/test_torch_cuda.py counts those)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if "_local_scalar_dense" in name or "_linalg_eigh" in name:
                seen.append(name)
            return func(*args, **(kwargs or {}))

    fn()   # tables made once per device (the sampler's bits, K7's frames)
    with Spy():
        out = fn()
    return seen, out


def _estimate_inputs():
    """A small config and tests/test_torch_pipeline.py's translated pair:
    noise with bright 6x6 squares, the right image 48 px along."""
    from pano_tpu_torch import config as TC

    r = np.random.default_rng(0)
    base = r.integers(0, 60, (128, 208, 3)).astype(np.uint8)
    for _ in range(max(60, 128 * 208 // 150)):
        y, x = r.integers(2, 128 - 10), r.integers(2, 208 - 10)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    cfg = TC.DEFAULT_CONFIG.replace(
        harris=TC.HarrisOptions(max_keypoints=512),
        ransac=TC.RansacOptions(num_iterations=500))
    return (cfg, torch.from_numpy(base[:, 48:].copy()),
            torch.from_numpy(base[:, :160].copy()))


@pytest.mark.parametrize("path", ["fused_estimate", "hyp_search",
                                  "auto_pair_row", "batched"])
def test_estimate_paths_read_nothing_on_the_host(path):
    """Every estimate path runs from its inputs to its row with no value
    read on the host: on the card, nothing waits before the row's one
    fetch."""
    from pano_tpu_torch import pipeline
    from pano_tpu_torch.parallel import shard

    cfg, left, right = _estimate_inputs()
    st = pipeline.PairStitcher(cfg, print_timing=False, device="cpu")
    if path == "fused_estimate":
        def fn():
            return st._fused_estimate_impl(left, right)[0]
    elif path == "hyp_search":
        mesh = shard.make_mesh(1, 2, devices=["cpu"] * 2)
        _, (pq, pt, v) = st._fused_estimate_impl(left, right)

        def fn():
            return shard._hyp_search(mesh, 0, pq, pt, v, cfg.ransac,
                                     cfg.ransac.num_iterations // 2).H
    elif path == "auto_pair_row":
        feats = [pipeline.auto_detect(img, cfg.harris)
                 for img in (left, right)]

        def fn():
            return pipeline.auto_pair_row(feats[1], feats[0], cfg)
    else:
        mesh = shard.make_mesh(1, 1, devices=["cpu"])

        def fn():
            return shard.fused_estimate_batched(left[None], right[None], cfg,
                                                mesh)[0][0]
    seen, row = _host_reads(fn)
    assert seen == []
    assert bool(torch.isfinite(row).all())
    if path != "hyp_search":
        assert float(row[10 if path == "auto_pair_row" else 11]) == 1.0  # ok
