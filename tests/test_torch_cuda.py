"""pano_tpu_torch kernels against their plain versions on an NVIDIA GPU.

These tests need the card and skip elsewhere. They import no JAX, so on
a machine without it they run without the JAX tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA GPU (python -m pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py)")


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,),
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape", [(300, 700), (151, 333), (5, 9)])
def test_harris_kernel_vs_plain(shape):
    """tests/test_pallas_harris.py's bar (the kernel is built with
    -fmad=false and matches bit for bit in practice)."""
    from pano_tpu_torch.ops import cuda_harris

    img = torch.from_numpy(_img(shape, 51)).cuda()
    got = cuda_harris.harris_scores(img, 0.04, 1e6).cpu().numpy()
    want = cuda_harris.harris_scores_plain(img, 0.04, 1e6).cpu().numpy()
    assert got.shape == want.shape
    assert (np.isneginf(got) == np.isneginf(want)).mean() > 0.9995
    both = ~np.isneginf(got) & ~np.isneginf(want)
    rel = np.abs(got[both] - want[both]) / np.maximum(np.abs(want[both]), 1)
    assert rel.size == 0 or ((rel > 2e-4).mean() < 0.005 and rel.max() < 0.02)


def test_harris_detect_same_keypoints_on_gpu_and_cpu():
    from pano_tpu_torch.config import HarrisOptions
    from pano_tpu_torch.ops import harris

    img = _img((240, 320), 52)
    opts = HarrisOptions(max_keypoints=700)
    kc = harris.harris_detect(torch.from_numpy(img), opts)
    kg = harris.harris_detect(torch.from_numpy(img).cuda(), opts)
    for a, b in zip(kc, kg):
        assert torch.equal(a, b.cpu())


def test_gather_kernel_vs_plain():
    """Bit-identical, border keypoints and invalid rows included."""
    from pano_tpu_torch.ops import cuda_gather

    img = torch.from_numpy(_img((60, 90), 53)).cuda()
    rng = np.random.default_rng(53)
    xy = np.stack([rng.integers(0, 90, 300), rng.integers(0, 60, 300)], -1)
    xy[:4] = [[0, 0], [89, 59], [2, 57], [1, 30]]
    xy = torch.from_numpy(xy.astype(np.int32)).cuda()
    bv = torch.from_numpy(rng.random(300) > 0.2).cuda()
    for p in (5, 7):
        got = cuda_gather.gather_patches(img, xy, bv, p)
        want = cuda_gather.gather_patches_plain(img, xy, bv, p)
        assert torch.equal(got, want)


@pytest.mark.parametrize("kq,kt", [(300, 437), (64, 64), (1, 700)])
def test_match_kernel_vs_plain(kq, kt):
    """Bit-identical cores, with duplicated rows (ties) and invalid rows
    and columns."""
    from pano_tpu_torch.ops import cuda_match

    rng = np.random.default_rng(54)

    def descs(k):
        d = rng.integers(0, 256, (k, 128)).astype(np.float32)
        d[:, 75:] = 0
        n = k // 3
        d[rng.integers(0, k, n)] = d[rng.integers(0, k, n)]
        return (torch.from_numpy(d).cuda(),
                torch.from_numpy(rng.random(k) > 0.15).cuda())

    dq, vq = descs(kq)
    dt, vt = descs(kt)
    dt[: min(kq, kt) // 2] = dq[: min(kq, kt) // 2]
    got = cuda_match.match_cores(dq, vq, dt, vt)
    want = cuda_match.match_cores_plain(dq, vq, dt, vt)
    for name, a, b in zip(("best", "idx", "second", "col_best"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("proj", [False, True])
def test_warp_kernel_vs_plain(proj):
    """max |d| <= 1, d != 0 on < 0.1% of the window's pixels."""
    from pano_tpu_torch.ops import cuda_warp

    right = torch.from_numpy(_img((200, 300), 55)).cuda()
    left = torch.from_numpy(_img((180, 220), 56)).cuda()
    m = np.array([[1.0, 0.0, 17.5], [0.0, 1.0, 6.25], [0.0, 0.0, 1.0]])
    if proj:
        m = np.array([[0.97, 0.02, 12.0], [-0.015, 1.02, 4.0],
                      [2e-5, -1e-5, 1.0]])
    args = (right, np.linalg.inv(m), left, 30, 190, (3, 5, 240, 400),
            260, 420)
    got = cuda_warp.warp_compose_overlay(*args)
    want = cuda_warp.warp_compose_overlay_plain(*args)
    d = (got.int() - want.int()).abs().amax(-1)
    assert int(d.max()) <= 1
    assert int((d != 0).sum()) < 1e-3 * 237 * 395


def test_stitch_pair_fast_on_gpu_matches_cpu():
    """The whole pair on the card against the plain versions on the CPU,
    with one injected sample table: each kernel launched by the GPU call,
    the canvas within one row and column (the refine's 9x9 normal matrix
    and eigh round differently on the two devices, and the canvas is
    ceil() of the warped extent), and (d > 3) on < 1% of the shared
    pixels."""
    from pano_tpu_torch import PanoConfig, PairStitcher
    from pano_tpu_torch.config import HarrisOptions, RansacOptions
    from pano_tpu_torch.ops import cuda_gather, cuda_harris, cuda_match
    from pano_tpu_torch.ops import cuda_warp

    r = np.random.default_rng(57)
    base = r.integers(0, 60, (128, 208, 3)).astype(np.uint8)
    for _ in range(180):
        y, x = r.integers(2, 118), r.integers(2, 198)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    left, right = base[:, 48:].copy(), base[:, :160].copy()
    table = torch.from_numpy(r.integers(0, 2**31, (500, 4)))
    cfg = PanoConfig(harris=HarrisOptions(max_keypoints=512),
                     ransac=RansacOptions(num_iterations=500))

    def sampler(n_valid):
        return table.to(n_valid.device) % torch.clamp(n_valid.long(), min=1)

    want = PairStitcher(cfg, device="cpu", sampler=sampler).stitch_pair_fast(
        left, right)
    mods = (cuda_harris, cuda_gather, cuda_match, cuda_warp)
    for mod in mods:
        mod.launches = 0
    got = PairStitcher(cfg, device="cuda", sampler=sampler).stitch_pair_fast(
        left, right)
    assert [mod.launches for mod in mods] == [2, 2, 1, 1]
    assert got.is_cuda and got.dtype == torch.uint8
    assert all(abs(a - b) <= 1 for a, b in zip(got.shape, want.shape))
    h, w = min(got.shape[0], want.shape[0]), min(got.shape[1], want.shape[1])
    d = (got.cpu()[:h, :w].int() - want[:h, :w].int()).abs().amax(-1)
    assert float((d > 3).float().mean()) < 0.01
