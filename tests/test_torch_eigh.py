"""K7's plain version (pano_tpu_torch/ops/cuda_eigh.py) against
jnp.linalg.eigh on the CPU: the eigenvector of a symmetric 9x9 matrix at
its smallest eigenvalue, on random SPD matrices, a diagonal one, one with
a tied smallest pair, a graded one and the refine's own normal matrix."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pano_tpu_torch.ops import cuda_eigh  # noqa: E402
from pano_tpu_torch.ops import ransac as TR  # noqa: E402


def refine_normal_matrix(seed, m=300, n_valid=250, outliers=60):
    """refine_homography's A^T A on tests/test_torch_ransac.py's
    _correspondences data, the outliers masked out."""
    rng = np.random.default_rng(seed)
    h_true = np.array(
        [[1.02, 0.03, -40.0], [-0.01, 0.99, 7.0], [2e-5, -1e-5, 1.0]]
    )
    src = rng.uniform(0, 400, (m, 2))
    p = np.c_[src, np.ones(m)] @ h_true.T
    dst = p[:, :2] / p[:, 2:3] + rng.normal(0, 0.3, (m, 2))
    dst[:outliers] = rng.uniform(0, 400, (outliers, 2))
    mask = (np.arange(m) < n_valid) & (np.arange(m) >= outliers)
    src, dst, mask = (torch.from_numpy(x) for x in (
        src.astype(np.float32), dst.astype(np.float32), mask))
    t_src = TR._normalization_transform(src, mask)
    t_dst = TR._normalization_transform(dst, mask)
    sn = TR._apply_similarity(t_src, src)
    dn = TR._apply_similarity(t_dst, dst)
    x, y, u, v = sn[:, 0], sn[:, 1], dn[:, 0], dn[:, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    w = mask.float()[:, None]
    a = torch.cat([
        torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1) * w,
        torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1) * w,
    ])
    return (a.T @ a).numpy()


def random_spd(seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal((9, 9)) * scale
    return (a @ a.T).astype(np.float32)


def graded_spd(seed):
    """Eigenvalues 1e-4 and 0.1 to 1e3 under a random rotation: the spread
    of a refine's normal matrix (a smallest eigenvalue near 0, the next
    ~1e-4 of the largest: its f32 entries still fix the vector)."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((9, 9)))
    lam = np.r_[1e-4, np.logspace(-1, 3, 8)]
    return ((q * lam) @ q.T).astype(np.float32)


CASES = {
    **{f"spd{s}": (lambda s=s: random_spd(s)) for s in range(6)},
    "spd_small": lambda: random_spd(11, 1e-3),
    "spd_large": lambda: random_spd(12, 1e3),
    "graded0": lambda: graded_spd(20),
    "graded1": lambda: graded_spd(21),
    "diagonal": lambda: np.diag(
        np.random.default_rng(30).uniform(0.5, 5.0, 9)).astype(np.float32),
    "refine0": lambda: refine_normal_matrix(33),
    "refine1": lambda: refine_normal_matrix(34, m=800, n_valid=700,
                                           outliers=200),
}


def _jax_smallest(a):
    w, v = jnp.linalg.eigh(jnp.asarray(a))
    return float(w[0]), np.asarray(v[:, 0], np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_eigh(name):
    """1 - |v . v_jax| <= 1e-5 (the sign is free) and ||A v - lambda v|| <=
    1e-5 ||A||, lambda JAX's smallest eigenvalue."""
    a = CASES[name]()
    got = cuda_eigh.smallest_eigvec9_plain(torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == (9,)
    v = got.double().numpy()
    lam, want = _jax_smallest(a)
    assert abs(np.linalg.norm(v) - 1.0) <= 1e-6
    assert 1.0 - abs(v @ want) <= 1e-5, 1.0 - abs(v @ want)
    a64 = a.astype(np.float64)
    res = np.linalg.norm(a64 @ v - lam * v)
    assert res <= 1e-5 * np.linalg.norm(a64, 2), res


def test_plain_tied_smallest_pair():
    """Two equal smallest eigenvalues: any vector of their plane is right,
    so only the residual is checked."""
    q, _ = np.linalg.qr(np.random.default_rng(40).standard_normal((9, 9)))
    lam = np.array([0.25, 0.25, 1, 2, 3, 4, 5, 6, 7])
    a = ((q * lam) @ q.T).astype(np.float32)
    v = cuda_eigh.smallest_eigvec9_plain(torch.from_numpy(a)).double().numpy()
    w, _ = _jax_smallest(a)
    a64 = a.astype(np.float64)
    assert abs(np.linalg.norm(v) - 1.0) <= 1e-6
    assert np.linalg.norm(a64 @ v - w * v) <= 1e-5 * np.linalg.norm(a64, 2)


def test_plain_ties_and_nan_follow_argmin():
    """The column at the smallest diagonal entry: the first of equal ones,
    and the first NaN where there is one (torch.argmin's rule, which the
    kernel follows)."""
    d = np.array([3, 1, 2, 1, 5, 6, 7, 8, 9], np.float32)
    got = cuda_eigh.smallest_eigvec9_plain(torch.from_numpy(np.diag(d)))
    assert torch.equal(got, torch.eye(9)[1])
    d[6] = np.nan
    got = cuda_eigh.smallest_eigvec9_plain(torch.from_numpy(np.diag(d)))
    assert torch.equal(got, torch.eye(9)[6])


@pytest.mark.parametrize("name", ["spd0", "graded0", "refine0", "refine1"])
def test_plain_has_converged_before_its_last_sweeps(name):
    """SWEEPS leaves a margin: two sweeps fewer give the same f32 vector
    to 1e-7."""
    a = torch.from_numpy(CASES[name]())
    full = cuda_eigh.smallest_eigvec9_plain(a)
    fewer = cuda_eigh.smallest_eigvec9_plain(a, cuda_eigh.SWEEPS - 2)
    np.testing.assert_allclose(full.numpy(), fewer.numpy(), rtol=0, atol=1e-7)


def test_round_robin_schedule_covers_every_pair_once():
    """A sweep's 9 rounds of 5 disjoint pairs are the 45 pairs of 0..9."""
    rounds = cuda_eigh.rounds()
    assert len(rounds) == 9 and all(len(r) == 5 for r in rounds)
    for r in rounds:
        assert sorted(i for pair in r for i in pair) == list(range(10))
    pairs = sorted(tuple(sorted(p)) for r in rounds for p in r)
    assert pairs == list(itertools.combinations(range(10), 2))


def test_wrapper_runs_the_plain_version_on_the_cpu():
    a = torch.from_numpy(random_spd(3))
    before = cuda_eigh.launches
    got = cuda_eigh.smallest_eigvec9(a)
    assert cuda_eigh.launches == before
    assert torch.equal(got, cuda_eigh.smallest_eigvec9_plain(a))


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_wrapper_refuses(bad):
    a = torch.from_numpy(random_spd(4))
    if bad == "shape":
        a = a[:8, :8]
    elif bad == "dtype":
        a = a.double()
    else:
        a = a.to("meta")
    with pytest.raises(ValueError):
        cuda_eigh.smallest_eigvec9(a)


def test_plain_reads_nothing_on_the_host():
    """No operation of the plain version brings a value to the host, so on
    the card it enqueues without waiting either."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    a = torch.from_numpy(random_spd(5))
    cuda_eigh._frames(a.device)   # the index tables, made once per device
    with Spy():
        cuda_eigh.smallest_eigvec9_plain(a)
    assert seen and not [op for op in seen
                         if "_local_scalar_dense" in op or "eigh" in op]
