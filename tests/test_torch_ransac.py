"""pano_tpu_torch RANSAC vs the JAX package's on the CPU, with the JAX
sample table injected so both sides score the same hypotheses."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano_tpu.config import RansacOptions as JaxRansacOptions  # noqa: E402
from pano_tpu.ops import ransac as JR  # noqa: E402
from pano_tpu_torch.config import RansacOptions  # noqa: E402
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
    got = TR._solve8(torch.from_numpy(a), torch.from_numpy(b)).numpy()
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
    got = TR.inv3x3(torch.from_numpy(m)).numpy()
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
