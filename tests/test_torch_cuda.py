"""pano_tpu_torch kernels against their plain versions on an NVIDIA GPU.

These tests need the card and skip elsewhere. They import no JAX, so on
a machine without it they run without the JAX tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os

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


@pytest.mark.parametrize("shape", [(300, 700), (151, 333), (5, 9),
                                   (3117, 4156), (64, 241), (97, 121)])
def test_harris_kernel_vs_plain(shape):
    """Bit-identical (the kernel keeps the plain version's rounding order
    under -fmad=false): at the main path's size, at widths that are not
    a multiple of a warp's 120-column strip, odd sizes and the smallest
    image."""
    from pano_tpu_torch.ops import cuda_harris

    img = torch.from_numpy(_img(shape, 51)).cuda()
    got = cuda_harris.harris_scores(img, 0.04, 1e6)
    want = cuda_harris.harris_scores_plain(img, 0.04, 1e6)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(want).any()) or shape == (5, 9)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_harris_kernel_unaligned_image(offset):
    """An image whose data starts 1-3 bytes past a 4-byte boundary (the
    kernel reads aligned words and shifts the bytes into place), on a
    textured image with a threshold of 0 so that most blocks hold a
    peak."""
    from pano_tpu_torch.ops import cuda_harris

    h, w = 130, 251
    buf = torch.zeros(h * w * 3 + 8, dtype=torch.uint8)
    buf[offset:offset + h * w * 3] = torch.from_numpy(_img((h, w), 50)).flatten()
    img = buf.cuda()[offset:offset + h * w * 3].view(h, w, 3)
    assert img.is_contiguous() and img.data_ptr() % 4 == offset
    got = cuda_harris.harris_scores(img, 0.04, 0.0)
    want = cuda_harris.harris_scores_plain(img, 0.04, 0.0)
    assert torch.equal(got, want)


def test_harris_detect_same_keypoints_on_gpu_and_cpu():
    from pano_tpu_torch.config import HarrisOptions
    from pano_tpu_torch.ops import harris

    img = _img((240, 320), 52)
    opts = HarrisOptions(max_keypoints=700)
    kc = harris.harris_detect(torch.from_numpy(img), opts)
    kg = harris.harris_detect(torch.from_numpy(img).cuda(), opts)
    for a, b in zip(kc, kg):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("shape", [(151, 333), (64, 241), (5, 9)])
@pytest.mark.parametrize("nms", [3, 5, 7, 9, 11, 15])
def test_harris_kernel_refuses_other_nms_windows(nms, shape):
    """Every odd NMS window runs on the card (the test keeps its old name;
    the kernel no longer refuses any): bit-identical to the plain version
    with a low threshold (most blocks hold a candidate) and a high one,
    through the one-launch stencil up to 9 and the R plane and fold
    kernel above; harris_detect gives the CPU's keypoints."""
    from pano_tpu_torch.config import HarrisOptions
    from pano_tpu_torch.ops import cuda_harris, harris

    host = torch.from_numpy(_img(shape, 53))
    img = host.cuda()
    for thresh in (0.0, 1e6):
        got = cuda_harris.harris_scores(img, 0.04, thresh, nms)
        want = cuda_harris.harris_scores_plain(img, 0.04, thresh, nms)
        assert torch.equal(got, want)
    opts = HarrisOptions(max_keypoints=300, nms_neighborhood=nms)
    kg = harris.harris_detect(img, opts)
    kc = harris.harris_detect(host, opts)
    for a, b in zip(kg, kc):
        assert torch.equal(a.cpu(), b)
    assert int(kg.count()) > 0 or shape == (5, 9)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_default_sampler_cuda_table_equals_cpu(seed):
    """RANSAC's default table (JAX's randint) is made on the card from a
    device n_valid, and equals the CPU's."""
    from pano_tpu_torch.ops import ransac

    cpu = ransac.default_sampler(1000, 4, seed, "cpu")
    gpu = ransac.default_sampler(1000, 4, seed, "cuda")
    for n_valid in (0, 1, 3, 100, 4097, 8192, 65537 * 3):
        got = gpu(torch.tensor(n_valid, dtype=torch.int32, device="cuda"))
        assert got.is_cuda
        assert torch.equal(got.cpu(), cpu(torch.tensor(n_valid)))


# K2 cases: image shape and data offset in bytes, for a patch size p.
GATHER_IMAGES = {
    "3w_odd": lambda p: ((61, 91), 1),       # row of 273 bytes, unaligned
    "3w_mult16": lambda p: ((57, 112), 0),   # row of 336 = 21 * 16 bytes
    "narrow": lambda p: ((40, p - 1), 0),    # every row border-invalid
    "short": lambda p: ((p - 1, 45), 3),
    "4156x3117": lambda p: ((3117, 4156), 0),
}


def _gather_inputs(shape, offset, k, rng):
    """An (h, w, 3) image `offset` bytes past an allocation's start, and
    k keypoints: random ones around the image (border lines crossed), a
    tenth invalid far outside it, 15 % of the rest invalid."""
    h, w = shape
    buf = torch.zeros(h * w * 3 + offset, dtype=torch.uint8)
    buf[offset:] = torch.from_numpy(_img(shape, 54)).flatten()
    img = buf.cuda()[offset:].view(h, w, 3)
    xs = rng.integers(-3, w + 3, k)
    ys = rng.integers(-3, h + 3, k)
    kv = rng.random(k) > 0.15
    wild = rng.random(k) < 0.1
    far = [-10**6, 10**6, 2**30, -2**31 + 5]
    xs[wild] = rng.choice(far, int(wild.sum()))
    ys[wild] = rng.choice(far, int(wild.sum()))
    kv[wild] = False
    xy = torch.from_numpy(np.stack([xs, ys], -1).astype(np.int32)).cuda()
    return img, xy, torch.from_numpy(kv).cuda()


@pytest.mark.parametrize("image", list(GATHER_IMAGES))
@pytest.mark.parametrize("p", [3, 5, 7, 9, 11])
def test_gather_kernel_vs_plain(p, image):
    """Descriptors and border flags bit-identical to the plain version
    (the flags exactly 0 or 1 a byte) for p = 3, 5, 7 (compile-time) and
    9, 11 (runtime p), K = 0 to 8197 (a block's 8 keypoints cut at the
    tail), rows of 3W bytes odd and a multiple of 16, an unaligned
    image, images narrower or shorter than p, and invalid rows far
    outside the image; at 4156x3117 also the default config's keypoints
    from harris_detect."""
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import cuda_gather, harris

    shape, offset = GATHER_IMAGES[image](p)
    rng = np.random.default_rng(55 + p)
    cases = []
    for k in (0, 1, 31, 32, 33, 1000, 8197):
        cases.append(_gather_inputs(shape, offset, k, rng))
    if image == "4156x3117":
        img = cases[0][0]
        kps = harris.harris_detect(img, DEFAULT_CONFIG.harris)
        assert int(kps.count()) > 1000
        cases.append((img, kps.xy.contiguous(), kps.valid))
    for img, xy, kv in cases:
        assert img.is_contiguous()
        before = cuda_gather.launches
        desc, bv = cuda_gather.gather_patches(img, xy, kv, p)
        assert cuda_gather.launches == before + (xy.shape[0] > 0)
        want_d, want_b = cuda_gather.gather_patches_plain(img, xy, kv, p)
        assert desc.shape == want_d.shape and bv.dtype == torch.bool
        assert torch.equal(bv, want_b)
        assert bv.numel() == 0 or int(bv.view(torch.uint8).max()) <= 1
        assert torch.equal(desc, want_d)
        if image in ("narrow", "short"):
            assert not bool(bv.any()) and not bool(desc.any())


@pytest.mark.parametrize("image", ["3w_odd", "3w_mult16"])
@pytest.mark.parametrize("p", [1, 13, 31])
def test_gather_kernel_other_patch_sizes(p, image):
    """The runtime-p path (tap / p by the host's reciprocal, which wraps
    to 0 at p = 1; several 128-column chunks a row at 13 and 31):
    bit-identical to the plain version."""
    from pano_tpu_torch.ops import cuda_gather

    shape, offset = GATHER_IMAGES[image](p)
    shape = (max(shape[0], p + 9), max(shape[1], p + 9))
    rng = np.random.default_rng(56 + p)
    for k in (1, 33, 1000):
        img, xy, kv = _gather_inputs(shape, offset, k, rng)
        desc, bv = cuda_gather.gather_patches(img, xy, kv, p)
        want_d, want_b = cuda_gather.gather_patches_plain(img, xy, kv, p)
        assert torch.equal(bv, want_b) and torch.equal(desc, want_d)
        assert k < 1000 or bool(bv.any())


MATCH_BQ = 128  # query rows per block of csrc/match.cu


def _match_descs(rng, k, used=75):
    """u8-valued (k, 128) descriptors, zero past `used`, a third of the
    rows duplicated (exact SSD ties), 15 % invalid."""
    d = rng.integers(0, 256, (k, 128)).astype(np.float32)
    d[:, used:] = 0
    n = k // 3
    d[rng.integers(0, k, n)] = d[rng.integers(0, k, n)]
    return d, rng.random(k) > 0.15


def _match_equal(dq, vq, dt, vt):
    from pano_tpu_torch.ops import cuda_match

    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (dq, vq, dt, vt)]
    got = cuda_match.match_cores(*args)
    want = cuda_match.match_cores_plain(*args)
    for name, a, b in zip(("best", "idx", "second", "col_best"), got, want):
        assert torch.equal(a, b), name
    return want


@pytest.mark.parametrize("kq,kt", [(300, 437), (64, 64), (1, 700),
                                   (8192, 8192), (1000, 3001), (129, 8191)])
def test_match_kernel_vs_plain(kq, kt):
    """Bit-identical cores, with duplicated rows (ties) and invalid rows
    and columns, at the main path's size and at ragged sizes that cut a
    block, a tile and a split of the train axis; duplicates sit on both
    sides of every split boundary and of every 128-row query block."""
    from pano_tpu_torch.ops import cuda_match

    rng = np.random.default_rng(54)
    dq, vq = _match_descs(rng, kq)
    dt, vt = _match_descs(rng, kt)
    dt[: min(kq, kt) // 2] = dq[: min(kq, kt) // 2]
    _, span = cuda_match.scratch_plan(kq, kt, 128)
    for b in range(span, kt, span):
        dt[b] = dt[b - 1]                 # a tie across the boundary
        dt[b - 2] = dt[min(b + 3, kt - 1)]
        vt[b - 1] = vt[b] = True
    for b in range(MATCH_BQ, kq, MATCH_BQ):
        dq[b] = dq[b - 1]                 # column ties across query blocks
        vq[b - 1] = vq[b] = True
    _match_equal(dq, vq, dt, vt)


def test_match_kernel_all_invalid_train():
    """No valid train column: best and second +inf, index 0; every column
    best row 0, as argmin over +inf."""
    rng = np.random.default_rng(55)
    dq, vq = _match_descs(rng, 300)
    dt, _ = _match_descs(rng, 200)
    best, idx, second, col_best = _match_equal(
        dq, vq, dt, np.zeros(200, bool))
    assert bool(torch.isinf(best).all()) and bool(torch.isinf(second).all())
    assert not bool(idx.any()) and not bool(col_best.any())


def test_match_kernel_max_value():
    """All 128 columns at 255 on some rows (and 0 on others): dot
    products reach 128 * 255^2 = 8.3 M and norm sums 16.6 M, still below
    2^24."""
    rng = np.random.default_rng(56)
    dq, vq = _match_descs(rng, 700, used=128)
    dt, vt = _match_descs(rng, 900, used=128)
    dq[rng.integers(0, 700, 40)] = 255.0
    dt[rng.integers(0, 900, 40)] = 255.0
    dq[rng.integers(0, 700, 20)] = 0.0
    dt[rng.integers(0, 900, 20)] = 0.0
    assert (dq == 255).all(1).any() and ((dt == 255).all(1) & vt).any()
    _match_equal(dq, vq, dt, vt)


def test_match_kernel_refuses_short_scratch():
    """The C entry checks the caller's scratch against its own plan and
    refuses a buffer one byte short before launching anything."""
    from pano_tpu_torch import _build
    from pano_tpu_torch.ops import cuda_match

    kq, kt, d = 300, 437, 128
    nbytes, _ = cuda_match.scratch_plan(kq, kt, d)
    q = torch.zeros(kq, d, device="cuda")
    t = torch.zeros(kt, d, device="cuda")
    vq = torch.ones(kq, dtype=torch.bool, device="cuda")
    vt = torch.ones(kt, dtype=torch.bool, device="cuda")
    outs = [torch.empty(k, dtype=torch.int32, device="cuda")
            for k in (kq, kq, kq, kt)]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    with pytest.raises(RuntimeError, match="pano_match_streaming"):
        _build.launch("pano_match_streaming", q.device, q.data_ptr(),
                      t.data_ptr(), vq.data_ptr(), vt.data_ptr(),
                      *(o.data_ptr() for o in outs), scratch.data_ptr(),
                      nbytes - 1, kq, kt, d)


PROJ = np.array([[0.97, 0.02, 12.0], [-0.015, 1.02, 4.0], [2e-5, -1e-5, 1.0]])


def _shift(x, y):
    return np.array([[1.0, 0.0, x], [0.0, 1.0, y], [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("proj", [False, True])
def test_warp_kernel_vs_plain(proj):
    """Bit-identical (it was max |d| <= 1 with d != 0 on < 0.1% of the
    window's pixels before K4a shared K4b's exact sample)."""
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
    assert torch.equal(got, want)


# K4a and K5 cases: (left shape, right shape, (ty, tx), canvas window,
# canvas shape, canvas-from-source map of the right image).
CANVAS_CASES = {
    # tx and wx0 at every residue mod 16, odd canvas widths
    **{f"tx,wx0%16={r}": ((90, 131 + r), (80, 120), (r % 5, r),
                          (7, 48 + r, 88, 169 + r), (97, 171 + 2 * r),
                          _shift(48.0 + r - 0.3, 7.6)) for r in range(16)},
    "projective_full": ((180, 220), (200, 300), (30, 190),
                        (0, 0, 260, 421), (260, 421), PROJ),
    "touch_top_left": ((60, 90), (50, 70), (10, 20), (0, 0, 40, 60),
                       (70, 111), _shift(-10.5, -10.25)),
    "touch_bottom_right": ((60, 90), (50, 70), (0, 0), (30, 41, 81, 113),
                           (81, 113), _shift(41.3, 30.7)),
    "width1": ((60, 90), (50, 70), (3, 2), (5, 37, 55, 38), (63, 95),
               _shift(37.2, 5.5)),
    "height1": ((60, 90), (50, 70), (3, 2), (21, 4, 22, 77), (63, 95),
                _shift(4.2, 21.5)),
    "empty_width": ((60, 90), (50, 70), (3, 2), (5, 37, 55, 37), (63, 95),
                    _shift(37.2, 5.5)),
    "empty_height": ((60, 90), (50, 70), (3, 2), (5, 37, 5, 90), (63, 95),
                     _shift(37.2, 5.5)),
    # fold: the growing panorama on the left, larger than the right image
    "fold": ((310, 1003), (120, 200), (4, 0), (150, 900, 272, 1102),
             (314, 1103), _shift(900.4, 151.3)),
    # the main path's planted pair
    "planted": ((3117, 4156), (3117, 4156), (0, 0),
                (35, 1398, 3154, 5556), (3154, 5556), _shift(1400.0, 37.0)),
}


def _canvas_case(case):
    lshape, rshape, (ty, tx), window, (oh, ow), m = CANVAS_CASES[case]
    left = torch.from_numpy(_img(lshape, 66)).cuda()
    right = torch.from_numpy(_img(rshape, 67)).cuda()
    return left, right, ty, tx, window, oh, ow, np.linalg.inv(m)


@pytest.mark.parametrize("case", list(CANVAS_CASES))
def test_warp_overlay_kernel_vs_plain(case):
    """K4a bit-identical to its plain version: tx and wx0 at every 16-byte
    phase, odd canvas widths, windows on every canvas edge, one pixel
    wide or high, empty, a fold-shaped left larger than the right, the
    main path's planted pair."""
    from pano_tpu_torch.ops import cuda_warp

    left, right, ty, tx, window, oh, ow, m_inv = _canvas_case(case)
    args = (right, m_inv, left, ty, tx, window, oh, ow)
    got = cuda_warp.warp_compose_overlay(*args)
    want = cuda_warp.warp_compose_overlay_plain(*args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("blend", ["overlay", "feather"])
@pytest.mark.parametrize("case", list(CANVAS_CASES))
def test_compose_canvas_kernel_vs_plain(case, blend):
    """K5 bit-identical to its plain version over K4b's window of the same
    cases as K4a, with black holes and zero weights in it."""
    from pano_tpu_torch.ops import cuda_compose, cuda_warp

    left, right, ty, tx, window, oh, ow, m_inv = _canvas_case(case)
    rgb, w = cuda_warp.warp_packed_plain(right, m_inv, window, True)
    hole = torch.from_numpy(
        np.random.default_rng(68).random(tuple(w.shape)) < 0.2).cuda()
    rgb[hole] = 0
    w = torch.where(hole, torch.zeros_like(w), w)
    args = (left, rgb, w, ty, tx, window, oh, ow, blend)
    got = cuda_compose.compose_canvas(*args)
    want = cuda_compose.compose_canvas_plain(*args)
    assert torch.equal(got, want)


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


# K4b cases: (source shape, canvas-from-source map, canvas window).
WARP_PACKED_CASES = {
    "projective": ((200, 300), PROJ, (3, 5, 240, 401)),
    **{f"wx0%16={r}": ((200, 300), PROJ, (3, 32 + r, 240, 301 + r))
       for r in (1, 2, 3, 5, 15)},
    **{f"width{n}": ((200, 300), PROJ, (7, 21, 230, 21 + n))
       for n in (1, 3, 17)},
    "width4158": ((3117, 4156), _shift(1400.0, 37.0), (35, 1398, 3154, 5556)),
    "one_row": ((200, 300), _shift(3.25, 2.5), (100, 1, 101, 311)),
    "5x9": ((5, 9), _shift(1.5, 0.75), (0, 0, 9, 14)),
    "7x1": ((7, 1), _shift(0.25, 0.5), (0, 0, 9, 4)),  # one source column
    # The mip path's maps shrink the source (ops/mip.py: up to 2.5x here).
    "minifying": ((600, 800), np.diag([0.4, 0.4, 1.0]) @ PROJ,
                  (0, 0, 250, 335)),
    # The map's denominator crosses 0 inside the window: inf and NaN
    # source coordinates sample nothing.
    "den_sign": ((60, 90), np.linalg.inv(np.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.02, 0.0, -0.5]])),
        (0, 0, 40, 60)),
}


@pytest.mark.parametrize("case", list(WARP_PACKED_CASES))
@pytest.mark.parametrize("has_alpha", [False, True])
def test_warp_packed_kernel_vs_plain(has_alpha, case):
    """K4b bit-identical to its plain version, RGB and weight: windows at
    every 16-byte phase of the origin, widths that cut a 32-pixel run, the
    main path's 4158-wide window, one row, a 5x9 and a one-column source,
    a minifying map, a denominator that changes sign; emit_weight=False returns None and
    the same RGB."""
    from pano_tpu_torch.ops import cuda_warp

    shape, m, window = WARP_PACKED_CASES[case]
    right = torch.from_numpy(_img(shape, 58)).cuda()
    m_inv = np.linalg.inv(m)
    rgb, w = cuda_warp.warp_packed(right, m_inv, window, has_alpha)
    rgb_p, w_p = cuda_warp.warp_packed_plain(right, m_inv, window, has_alpha)
    assert torch.equal(rgb, rgb_p)
    assert torch.equal(w, w_p)
    assert bool((w_p > 0).any()) and bool(rgb_p.any())
    rgb2, none = cuda_warp.warp_packed(right, m_inv, window, has_alpha,
                                       emit_weight=False)
    assert none is None and torch.equal(rgb2, rgb)


@pytest.mark.parametrize("blend", ["overlay", "feather"])
def test_compose_kernel_vs_plain(blend):
    """K5 at unaligned placements, black holes in the window:
    bit-identical (feather was held to max |d| <= 1 before)."""
    from pano_tpu_torch.ops import cuda_compose

    rng = np.random.default_rng(59)
    left = torch.from_numpy(_img((101, 157), 60)).cuda()
    win = _img((77, 93), 61)
    hole = rng.random((77, 93)) < 0.3
    win[hole] = 0
    w = np.where(hole, 0.0, rng.random((77, 93))).astype(np.float32)
    args = (left, torch.from_numpy(win).cuda(), torch.from_numpy(w).cuda(),
            13, 29, (5, 41, 82, 134), 170, 230, blend)
    got = cuda_compose.compose_canvas(*args)
    want = cuda_compose.compose_canvas_plain(*args)
    assert torch.equal(got, want)


def test_feather_pair_on_gpu_matches_cpu():
    """The feather pair on the card (K4b + K5, no K4a) against the plain
    versions on the CPU, with one injected sample table."""
    from pano_tpu_torch import PanoConfig, PairStitcher
    from pano_tpu_torch.config import (
        HarrisOptions, RansacOptions, StitchOptions,
    )
    from pano_tpu_torch.ops import cuda_compose, cuda_warp

    r = np.random.default_rng(62)
    base = r.integers(0, 60, (128, 208, 3)).astype(np.uint8)
    for _ in range(180):
        y, x = r.integers(2, 118), r.integers(2, 198)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    left, right = base[:, 48:].copy(), base[:, :160].copy()
    table = torch.from_numpy(r.integers(0, 2**31, (500, 4)))
    cfg = PanoConfig(harris=HarrisOptions(max_keypoints=512),
                     ransac=RansacOptions(num_iterations=500),
                     stitch=StitchOptions(blend="feather"))

    def sampler(n_valid):
        return table.to(n_valid.device) % torch.clamp(n_valid.long(), min=1)

    want = PairStitcher(cfg, device="cpu", sampler=sampler).stitch_pair_fast(
        left, right)
    cuda_warp.launches = cuda_warp.packed_launches = cuda_compose.launches = 0
    got = PairStitcher(cfg, device="cuda", sampler=sampler).stitch_pair_fast(
        left, right)
    assert (cuda_warp.launches, cuda_warp.packed_launches,
            cuda_compose.launches) == (0, 1, 1)
    assert got.is_cuda and got.dtype == torch.uint8
    assert all(abs(a - b) <= 1 for a, b in zip(got.shape, want.shape))
    h, w = min(got.shape[0], want.shape[0]), min(got.shape[1], want.shape[1])
    d = (got.cpu()[:h, :w].int() - want[:h, :w].int()).abs().amax(-1)
    assert float((d > 3).float().mean()) < 0.01


# K6 cases: (canvas shape, window).
CHAIN_CASES = {
    "aligned": ((384, 512), (128, 256, 384, 512)),
    "unaligned": ((384, 512), (13, 29, 90, 122)),
    **{f"wx0%16={r}": ((96, 512), (5, 64 + r, 90, 64 + r + 333))
       for r in (1, 2, 3, 5, 15)},
    **{f"width{n}": ((96, 512), (3, 77, 93, 77 + n)) for n in (1, 3, 17)},
    "one_row": ((96, 512), (40, 7, 41, 500)),
    "last_column": ((96, 512), (2, 511, 95, 512)),
    # The strip's canvas: its row pitch of 8356 * 3 bytes is not a
    # multiple of 16; the window of the chain step, ending on the last
    # column, and a 4158-wide one at an odd origin.
    "pitch8356": ((64, 8356), (3, 4196, 64, 8356)),
    "width4158": ((64, 8356), (1, 1403, 63, 5561)),
}


@pytest.mark.parametrize("blend", ["overlay", "feather"])
@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_compose_chain_kernel_vs_plain(blend, case):
    """K6 in place on the card bit-identical to its plain version, canvas
    and weight canvas, with holes in the window, at every 16-byte phase
    of the origin, narrow, one-row and last-column windows and the
    strip's canvas; nothing outside the window touched."""
    from pano_tpu_torch.ops import cuda_compose

    rng = np.random.default_rng(63)
    shape, window = CHAIN_CASES[case]
    canvas = _img(shape, 64)
    wcan = np.where(rng.random(shape) < 0.5, 0.0,
                    rng.random(shape)).astype(np.float32)
    wy0, wx0, wy1, wx1 = window
    win = _img((wy1 - wy0, wx1 - wx0), 65)
    hole = rng.random(win.shape[:2]) < 0.3
    win[hole] = 0
    w = np.where(hole, 0.0, rng.random(win.shape[:2])).astype(np.float32)
    args = [torch.from_numpy(a) for a in (canvas, wcan, win, w)]
    got_c, got_w = cuda_compose.compose_chain_canvas(
        *[a.clone().cuda() for a in args], window, blend)
    want_c, want_w = cuda_compose.compose_chain_canvas_plain(
        *[a.clone().cuda() for a in args], window, blend)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_w, want_w)
    outside = torch.ones(shape, dtype=torch.bool)
    outside[wy0:wy1, wx0:wx1] = False
    assert torch.equal(got_c.cpu()[outside], args[0][outside])
    assert torch.equal(got_w.cpu()[outside], args[1][outside])


@pytest.mark.parametrize("blend", ["overlay", "feather"])
def test_chain_mode_on_gpu_matches_cpu(blend):
    """stitch_all_images(mode='chain') on the card against the plain
    versions on the CPU, with one injected sample table: K1 x4, K2 x4,
    K3 x2, K4b x2, K6 x2 on the card, the canvas within one row and
    column, and (d > 3) on < 1 % of the shared pixels."""
    from pano_tpu_torch import PanoConfig, stitch_all_images
    from pano_tpu_torch.config import (
        HarrisOptions, RansacOptions, StitchOptions,
    )
    from pano_tpu_torch.ops import (
        cuda_compose, cuda_gather, cuda_harris, cuda_match, cuda_warp,
    )

    r = np.random.default_rng(66)
    base = r.integers(0, 60, (128, 280, 3)).astype(np.uint8)
    for _ in range(240):
        y, x = r.integers(2, 118), r.integers(2, 270)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    imgs = [base[:, 0:140].copy(), base[:, 70:210].copy(),
            base[:, 140:280].copy()]
    table = torch.from_numpy(r.integers(0, 2**31, (500, 4)))
    cfg = PanoConfig(harris=HarrisOptions(max_keypoints=512),
                     ransac=RansacOptions(num_iterations=500),
                     stitch=StitchOptions(blend=blend))

    def sampler(n_valid):
        return table.to(n_valid.device) % torch.clamp(n_valid.long(), min=1)

    want = stitch_all_images(imgs, cfg, print_timing=False, device="cpu",
                             mode="chain", sampler=sampler)
    counters = [(cuda_harris, "launches"), (cuda_gather, "launches"),
                (cuda_match, "launches"), (cuda_warp, "launches"),
                (cuda_warp, "packed_launches"), (cuda_compose, "launches"),
                (cuda_compose, "chain_launches")]
    for mod, attr in counters:
        setattr(mod, attr, 0)
    got = stitch_all_images(imgs, cfg, print_timing=False, device="cuda",
                            mode="chain", sampler=sampler)
    assert [getattr(m, a) for m, a in counters] == [4, 4, 2, 0, 2, 0, 2]
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert all(abs(a - b) <= 1 for a, b in zip(got.shape, want.shape))
    h, w = min(got.shape[0], want.shape[0]), min(got.shape[1], want.shape[1])
    d = np.abs(got[:h, :w].astype(int) - want[:h, :w].astype(int)).max(-1)
    assert (d > 3).mean() < 0.01


@pytest.mark.parametrize("shape", [(1, 1), (97, 121), (3117, 4156)])
def test_push_image_copies_to_the_card(shape):
    """timer.push_image from a worker thread (as serve's decoder calls
    it): a contiguous CUDA uint8 tensor equal to the host image, the copy
    finished when it returns; a strided host view is copied too."""
    from concurrent.futures import ThreadPoolExecutor

    from pano_tpu_torch.timer import push_image

    img = _img(shape, 70)
    with ThreadPoolExecutor(1) as pool:
        got = pool.submit(push_image, img, torch.device("cuda")).result()
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert got.is_contiguous() and tuple(got.shape) == shape + (3,)
    assert torch.equal(got.cpu(), torch.from_numpy(img))
    view = img[:, ::-1]
    assert torch.equal(push_image(view, "cuda").cpu(),
                       torch.from_numpy(view.copy()))


def test_staging_decoder_stages_on_the_card(tmp_path):
    """serve's decoder on gpu: CUDA tensors equal to the files, a cache
    hit returns the same tensor, nothing printed about a failure."""
    import contextlib
    import io

    from pano_tpu_torch import cli, io as tio

    paths = []
    for i in range(3):
        p = str(tmp_path / f"s{i}.ppm")
        tio.write_ppm(p, _img((33 + i, 47), 71 + i))
        paths.append(p)
    dec = cli.make_staging_decoder(torch.device("cuda"), 8)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        first = dec(paths)
        again = dec(paths)
    assert err.getvalue() == ""
    for p in paths:
        t = first[p]
        assert isinstance(t, torch.Tensor) and t.device.type == "cuda"
        assert t.dtype == torch.uint8
        assert torch.equal(t.cpu(), torch.from_numpy(tio.imread_bgr(p)))
        assert again[p] is t


def test_cli_gpu_runs_on_the_card(tmp_path):
    """cli.run('gpu') on a small chain: its own lines (backend, device
    count, the GPU tag), every kernel of the chain launched, and the
    panorama of stitch_all_images on the card."""
    import contextlib
    import io
    import json

    from pano_tpu_torch import DEFAULT_CONFIG, cli, io as tio
    from pano_tpu_torch import stitch_all_images
    from pano_tpu_torch.ops import cuda_compose, cuda_harris, cuda_warp

    r = np.random.default_rng(66)
    base = r.integers(0, 60, (128, 280, 3)).astype(np.uint8)
    for _ in range(240):
        y, x = r.integers(2, 118), r.integers(2, 270)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    paths = []
    for i, x0 in enumerate((0, 70, 140)):
        paths.append(str(tmp_path / f"s{i}.ppm"))
        tio.write_ppm(paths[-1], base[:, x0:x0 + 140])
    out, stats = str(tmp_path / "p.ppm"), str(tmp_path / "s.json")
    for mod, attr in ((cuda_harris, "launches"),
                      (cuda_warp, "packed_launches"),
                      (cuda_compose, "chain_launches")):
        setattr(mod, attr, 0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.run("gpu", [*paths, "--mode", "chain", "--out", out,
                             "--json", stats])
    lines = buf.getvalue().splitlines()
    assert rc == 0, lines
    assert lines[:2] == ["PyTorch backend: cuda",
                         f"Number of Available Devices: "
                         f"{torch.cuda.device_count()}"]
    assert lines[-1].startswith("Total Execution Time (GPU): ")
    assert (cuda_harris.launches, cuda_warp.packed_launches,
            cuda_compose.chain_launches) == (4, 2, 2)
    with contextlib.redirect_stdout(io.StringIO()):
        want = stitch_all_images([tio.imread_bgr(p) for p in paths],
                                 DEFAULT_CONFIG, mode="chain",
                                 device="cuda")
    np.testing.assert_array_equal(tio.imread_bgr(out), want)
    s = json.load(open(stats))
    assert (s["backend"], s["ok"], s["panorama_shape"]) == (
        "cuda", True, list(want.shape))


# --- the batched entries (K1, K4b) and the sharded paths ------------------


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("nms", [3, 5, 11])
@pytest.mark.parametrize("shape", [(151, 333), (64, 241)])
def test_harris_batched_kernel_vs_plain(shape, nms, b):
    """One launch over a stack of different images at odd sizes (so that
    each element after the first starts 1-3 bytes past a word): every
    map torch.equal to the plain version and to a single launch of its
    image; the stencil (n = 3, 5) and the R plane with the fold (n = 11)."""
    from pano_tpu_torch.ops import cuda_harris

    imgs = torch.from_numpy(np.stack([_img(shape, 70 + i)
                                      for i in range(b)])).cuda()
    cuda_harris.launches = cuda_harris.batched_launches = 0
    got = cuda_harris.harris_scores_batched(imgs, 0.04, 1e6, nms)
    assert (cuda_harris.launches, cuda_harris.batched_launches) == (0, 1)
    assert got.shape == (b, (shape[0] + 1) // 2, (shape[1] + 1) // 2)
    assert torch.equal(got, cuda_harris.harris_scores_batched_plain(
        imgs, 0.04, 1e6, nms))
    for i in range(b):
        assert torch.equal(got[i], cuda_harris.harris_scores(
            imgs[i], 0.04, 1e6, nms))
    assert bool(torch.isfinite(got).any())


def test_harris_detect_batched_equals_single():
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import harris

    imgs = torch.from_numpy(np.stack([_img((300, 451), 80 + i)
                                      for i in range(3)])).cuda()
    for got, img in zip(harris.harris_detect_batched(imgs,
                                                     DEFAULT_CONFIG.harris),
                        imgs):
        want = harris.harris_detect(img, DEFAULT_CONFIG.harris)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# Mixed windows over one (200, 300) source shape, an empty one among them.
BATCHED_WARPS = [
    (PROJ, (3, 5, 240, 401)),
    (PROJ, (3, 35, 240, 304)),
    (_shift(3.25, 2.5), (100, 1, 101, 311)),
    (PROJ, (7, 21, 230, 21)),
    (PROJ, (7, 21, 230, 38)),
    (np.diag([0.4, 0.4, 1.0]) @ PROJ, (0, 0, 100, 140)),
    (_shift(40.5, 17.25), (15, 38, 219, 342)),
]


@pytest.mark.parametrize("emit_weight", [False, True])
@pytest.mark.parametrize("has_alpha", [False, True])
def test_warp_packed_batched_kernel_vs_plain(has_alpha, emit_weight):
    """One launch over seven windows of mixed sizes (an empty one among
    them) from seven sources: every RGB and weight torch.equal to the
    plain version and to a single launch of its element."""
    from pano_tpu_torch.ops import cuda_warp

    srcs = [torch.from_numpy(_img((200, 300), 90 + i)).cuda()
            for i in range(len(BATCHED_WARPS))]
    m_invs = [np.linalg.inv(m) for m, _ in BATCHED_WARPS]
    windows = [w for _, w in BATCHED_WARPS]
    cuda_warp.packed_launches = cuda_warp.batched_packed_launches = 0
    got = cuda_warp.warp_packed_batched(srcs, m_invs, windows, has_alpha,
                                        emit_weight)
    assert (cuda_warp.packed_launches,
            cuda_warp.batched_packed_launches) == (0, 1)
    want = cuda_warp.warp_packed_batched_plain(srcs, m_invs, windows,
                                               has_alpha, emit_weight)
    for (rgb, w), (rgb_p, w_p), s, m, win in zip(got, want, srcs, m_invs,
                                                windows):
        one_rgb, one_w = cuda_warp.warp_packed(s, m, win, has_alpha,
                                               emit_weight)
        assert torch.equal(rgb, rgb_p) and torch.equal(rgb, one_rgb)
        if emit_weight:
            assert torch.equal(w, w_p) and torch.equal(w, one_w)
        else:
            assert w is None and w_p is None
    assert bool(got[0][0].any())


@pytest.mark.parametrize("n", [16, 17, 37])
def test_warp_packed_batched_counts_every_launch(n):
    """More windows than one launch holds (16): a launch for each 16,
    each counted, every output torch.equal to the plain version."""
    from pano_tpu_torch.ops import cuda_warp

    src = torch.from_numpy(_img((200, 300), 42)).cuda()
    picks = [BATCHED_WARPS[k % len(BATCHED_WARPS)] for k in range(n)]
    m_invs = [np.linalg.inv(m) for m, _ in picks]
    windows = [w for _, w in picks]
    cuda_warp.packed_launches = cuda_warp.batched_packed_launches = 0
    got = cuda_warp.warp_packed_batched([src] * n, m_invs, windows)
    assert (cuda_warp.packed_launches,
            cuda_warp.batched_packed_launches) == (0, -(-n // 16))
    want = cuda_warp.warp_packed_batched_plain([src] * n, m_invs, windows)
    for (rgb, w), (rgb_p, w_p) in zip(got, want):
        assert torch.equal(rgb, rgb_p) and torch.equal(w, w_p)


def test_warp_packed_batched_main_path_windows():
    """Three 4156x3117 crops into their chain windows (the strip's
    offsets) in one launch, equal to three single launches."""
    from pano_tpu_torch.ops import cuda_warp

    srcs = [torch.from_numpy(_img((3117, 4156), 95 + i)).cuda()
            for i in range(3)]
    maps = [_shift(x, y) for x, y in ((1400, 37), (2800, 15), (4200, 52))]
    windows = [(y - 2 if y >= 2 else 0, x - 2, min(y + 3117 + 2, 3169),
                min(x + 4156 + 2, 8356)) for x, y in ((1400, 37),
                                                     (2800, 15), (4200, 52))]
    m_invs = [np.linalg.inv(m) for m in maps]
    got = cuda_warp.warp_packed_batched(srcs, m_invs, windows)
    for (rgb, w), s, m, win in zip(got, srcs, m_invs, windows):
        one_rgb, one_w = cuda_warp.warp_packed(s, m, win)
        assert torch.equal(rgb, one_rgb) and torch.equal(w, one_w)


@pytest.mark.parametrize("case", ["projective_full", "fold", "planted",
                                  "touch_bottom_right"])
def test_batched_overlay_route_equals_k4a(case):
    """composite_pairs_batched sends overlay without gain through batched
    K4b + K5 overlay: the canvas torch.equal to K4a's
    (PairStitcher.composite on the card)."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.ops import cuda_compose, cuda_warp
    from pano_tpu_torch.parallel import shard

    lshape, rshape, _, _, _, m = CANVAS_CASES[case]
    if lshape != rshape:  # a batch shares the left and right shapes
        rshape = lshape
    left = torch.from_numpy(_img(lshape, 66)).cuda()
    right = torch.from_numpy(_img(rshape, 67)).cuda()
    cuda_warp.launches = cuda_warp.batched_packed_launches = 0
    cuda_compose.launches = 0
    got = shard.composite_pairs_batched(left[None], right[None], m[None],
                                        np.ones(1, bool), DEFAULT_CONFIG)
    assert (cuda_warp.launches, cuda_warp.batched_packed_launches,
            cuda_compose.launches) == (0, 1, 1)
    want = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                        device="cuda").composite(left, right, m)
    assert cuda_warp.launches == 1
    assert torch.equal(torch.from_numpy(got[0]), want.cpu())


def test_batched_estimate_without_a_mesh_runs_on_the_card():
    """CPU tensors and no mesh: the inputs go to the first card, K1 runs
    there, and the rows equal a mesh of the card's."""
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import cuda_harris
    from pano_tpu_torch.parallel import shard

    imgs = _strip_images(31)
    lefts = torch.from_numpy(np.stack(imgs[:2]))
    rights = torch.from_numpy(np.stack(imgs[1:3]))
    cuda_harris.batched_launches = 0
    packed, _ = shard.fused_estimate_batched(lefts, rights, DEFAULT_CONFIG)
    assert packed.device.type == "cuda" and cuda_harris.batched_launches == 1
    want, _ = shard.fused_estimate_batched(lefts.cuda(), rights.cuda(),
                                           DEFAULT_CONFIG,
                                           shard.make_mesh(1, 1))
    assert torch.equal(packed, want)


def _strip_images(seed, n=4, h=128, step=70, w=140):
    r = np.random.default_rng(seed)
    base = r.integers(0, 60, (h, step * (n - 1) + w, 3)).astype(np.uint8)
    for _ in range(300):
        y, x = r.integers(2, h - 10), r.integers(2, base.shape[1] - 10)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    return [base[:, i * step:i * step + w].copy() for i in range(n)]


@pytest.mark.parametrize("n_data", [1, 3])
@pytest.mark.parametrize("mode", ["chain", "auto"])
def test_sharded_modes_on_the_card_equal_one_device(mode, n_data):
    """stitch_all_images_sharded on a mesh of the card (repeated n_data
    times) gives the one-device mode's panorama byte for byte, through
    batched K1 (one launch per data shard, or per image stack in auto)
    and batched K4b."""
    import contextlib
    import io

    from pano_tpu_torch import DEFAULT_CONFIG, stitch_all_images
    from pano_tpu_torch.ops import cuda_harris, cuda_warp
    from pano_tpu_torch.parallel import shard

    imgs = _strip_images(71)
    mesh = shard.make_mesh(n_data, 1,
                           devices=[torch.device("cuda")] * n_data)
    with contextlib.redirect_stdout(io.StringIO()):
        want = stitch_all_images(imgs, DEFAULT_CONFIG, mode=mode,
                                 device="cuda")
        cuda_harris.launches = cuda_harris.batched_launches = 0
        cuda_warp.packed_launches = cuda_warp.batched_packed_launches = 0
        got = shard.stitch_all_images_sharded(imgs, DEFAULT_CONFIG,
                                              mesh=mesh, mode=mode)
    assert cuda_harris.launches == 0 and cuda_warp.packed_launches == 0
    assert cuda_harris.batched_launches == (n_data if mode == "chain" else 1)
    assert cuda_warp.batched_packed_launches == n_data
    np.testing.assert_array_equal(got, want)


def test_sharded_paths_across_cards():
    """On a host with several cards: every sharded path on a mesh of the
    real cards gives what it gives on the first card repeated (chain,
    auto, the hyp-sharded fold, four batched pairs, the 2-wide hyp step,
    the row-sharded matcher)."""
    import contextlib
    import io

    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import match
    from pano_tpu_torch.parallel import shard

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    cards = [torch.device("cuda", i) for i in range(n)]
    first = [cards[0]] * n
    imgs = _strip_images(72, n=max(4, n))

    def both(fn):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(cards), fn(first)

    for mode in ("chain", "auto"):
        a, b = both(lambda d: shard.stitch_all_images_sharded(
            imgs, DEFAULT_CONFIG, mesh=shard.make_mesh(n, 1, devices=d),
            mode=mode))
        np.testing.assert_array_equal(a, b)
    a, b = both(lambda d: shard.stitch_all_images_sharded(
        imgs[:3], DEFAULT_CONFIG, mesh=shard.make_mesh(1, n, devices=d)))
    np.testing.assert_array_equal(a, b)
    lefts = torch.from_numpy(np.stack(imgs[:3] + imgs[:1])).cuda()
    rights = torch.from_numpy(np.stack(imgs[1:4] + imgs[1:2])).cuda()
    a, b = both(lambda d: shard.stitch_pairs_batched(
        lefts, rights, DEFAULT_CONFIG, shard.make_mesh(n, 1, devices=d)))
    assert all(x is not None for x in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if n % 2 == 0:
        (ha, ca), (hb, cb) = both(lambda d: shard.batched_stitch_step(
            shard.make_mesh(n // 2, 2, devices=d), lefts[:n // 2],
            rights[:n // 2], DEFAULT_CONFIG))
        assert torch.equal(ha, hb) and torch.equal(ca, cb)
    r = np.random.default_rng(5)
    args = (torch.from_numpy(r.integers(0, 255, (64 * n, 128))).float(),
            torch.from_numpy(r.random(64 * n) > 0.2),
            torch.from_numpy(r.integers(0, 255, (300, 128))).float(),
            torch.from_numpy(r.random(300) > 0.2))
    args = tuple(t.cuda() for t in args)
    local = match.match_descriptors(*args, 1e18, ratio_thresh=0.8)
    got = shard.match_descriptors_sharded(*args, 1e18,
                                          shard.make_mesh(n, 1),
                                          ratio_thresh=0.8)
    assert all(torch.equal(x, y) for x, y in zip(local, got))


# --- the measuring and driver layer ----------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scripts():
    """The port's scripts at the repository root and under tools/, as
    modules."""
    import sys

    for p in (_REPO, os.path.join(_REPO, "tools")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import bench_torch
    import benchmark_throughput_torch
    import graft_entry_torch
    import torch_trace_summary
    return (bench_torch, benchmark_throughput_torch, graft_entry_torch,
            torch_trace_summary)


def _shifted_pairs(seed, device="cuda"):
    """Three pairs of different shifts (so of different canvases) on
    `device`."""
    return [tuple(torch.from_numpy(im).to(device)
                  for im in _strip_images(seed + k, n=2, step=step))
            for k, step in enumerate((50, 70, 90))]


def _parent_path(st, left, right):
    """stitch_pair_fast as it was before dispatch / retire: the row
    fetched with .cpu(), then the exact canvas; with the row."""
    from pano_tpu_torch import pipeline

    row_dev, _ = st._fused_estimate_impl(left, right)
    row = row_dev.cpu().numpy()
    assert row[11] > 0.5
    geo = pipeline.fused_canvas_geometry(row, left.shape[:2], right.shape[:2])
    canvas = st._compose(left, right, geo.m_inv, geo.ty, geo.tx, geo.window,
                         geo.canvas_h, geo.canvas_w)
    return pipeline.fast_path_crop(geo.row, canvas)[1], row


def test_dispatch_and_retire_on_the_card():
    """dispatch copies the row into pinned memory behind an event; three
    different pairs in flight each retire as their own stitch_pair_fast,
    with their own row, which is the single-sync path's of before the
    split (the row fetched with .cpu())."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    pairs = _shifted_pairs(80)
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    want = [_parent_path(st, left, right) for left, right in pairs]
    assert len({tuple(p.shape) for p, _ in want}) == 3
    for (left, right), (pano, row) in zip(pairs, want):
        assert torch.equal(st.stitch_pair_fast(left, right), pano)
        np.testing.assert_array_equal(st.last_estimate, row)
    pending = [st.dispatch(left, right) for left, right in pairs]
    assert all(p.row.is_pinned() and p.event is not None for p in pending)
    for p, (pano, row) in zip(pending, want):
        assert torch.equal(st.retire(p), pano)
        np.testing.assert_array_equal(st.last_estimate, row)


def test_dispatch_on_a_card_that_is_not_current():
    """A stitcher on the second card while the first is current: the
    row's event is recorded on the copy's stream, so each of three pairs
    in flight retires as the single-sync path gives it there."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    pairs = _shifted_pairs(86, "cuda:1")
    with torch.cuda.device(0):
        st = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                          device="cuda:1")
        want = [_parent_path(st, left, right) for left, right in pairs]
        for _ in range(3):
            pending = [st.dispatch(left, right) for left, right in pairs]
            for p, (pano, row) in zip(pending, want):
                got = st.retire(p)
                assert got.device == torch.device("cuda:1")
                assert torch.equal(got, pano)
                np.testing.assert_array_equal(st.last_estimate, row)


@pytest.mark.parametrize("depth", [1, 3])
def test_throughput_loop_on_the_card(depth):
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    _, bt, _, _ = _scripts()
    pairs = _shifted_pairs(81)
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    want = [_parent_path(st, left, right) for left, right in pairs]
    out = bt.throughput(st, *pairs[0], 6, depth)
    assert out["fallback_pairs"] == 0 and out["depth"] == depth
    got = list(bt.pipelined(st, pairs * 2, depth))
    assert len(got) == 6
    for (pano, row), (want_pano, want_row) in zip(got, want * 2):
        assert torch.equal(pano, want_pano)
        np.testing.assert_array_equal(row, want_row)
    # RANSAC's eigh waits for the card at least once a pair.
    syncs = bt.host_syncs_per_pair(st, *pairs[0], 2)
    assert syncs >= 1 and syncs == int(syncs)


def test_bench_measure_on_the_card():
    """bench.py's keys, device_compute_ms between 0 and the wall value,
    and the block's last panorama stitch_pair_fast's."""
    import ast

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    bench, _, _, _ = _scripts()
    tree = ast.parse(open(f"{_REPO}/bench.py").read())
    keys = {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            and any(isinstance(k, ast.Constant) and k.value == "metric"
                    for k in node.keys) for k in node.keys}
    keys |= {"device_compute_ms"}   # added where bench.py's trace worked
    left, right = _strip_images(82, n=2)
    out, pano = bench._measure(left, right, 2, "cuda")
    assert set(out) == keys == {"metric", "value", "unit", "vs_baseline",
                                "device_compute_ms"}
    assert 0 < out["device_compute_ms"] < out["value"]
    want = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                        device="cuda").stitch_pair_fast(left, right)
    assert torch.equal(pano, want)


def test_trace_summary_reads_a_cuda_trace(tmp_path):
    """A torch.profiler trace of K1 and a copy: device time and the
    kernel's name, with the union no more than the events' sum."""
    import contextlib
    import io

    from torch.profiler import ProfilerActivity, profile

    from pano_tpu_torch.ops import cuda_harris

    _, _, _, tts = _scripts()
    img = torch.from_numpy(_img((480, 640), 83)).cuda()
    cuda_harris.harris_scores(img, 0.04, 1e6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cuda_harris.harris_scores(img, 0.04, 1e6)
        img.cpu()
        torch.cuda.synchronize()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    trace = tts.load(path)
    dev = tts._complete(trace, tts.DEVICE_CATS)
    busy = tts.device_busy_ms(trace)
    # `ts` is an absolute time in us (~1e12): an interval's end - start
    # carries the last bits of its float64, ~1e-3 us an event.
    assert 0 < busy <= sum(e["dur"] for e in dev) / 1e3 + 1e-6 * len(dev)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        tts.summarize(trace)
    k1 = [line for line in text.getvalue().splitlines()
          if "harris_scores_kernel" in line]
    assert k1 and k1[0].rstrip().endswith("x3")


def test_graft_entry_on_the_card():
    """entry() and dryrun_multichip(1), (2) on the card (repeated where
    there is one) against the CPU's: the same inlier counts, H within
    0.5 px at the corners."""
    import contextlib
    import io

    _, _, ge, _ = _scripts()
    fn, args = ge.entry()
    assert all(a.device.type == "cuda" for a in args)
    h, count, canvas = fn(*args)
    fn_c, args_c = ge.entry("cpu")
    h_c, count_c, canvas_c = fn_c(*args_c)
    c = np.array([[0, 0, 1], [160, 0, 1], [160, 128, 1], [0, 128, 1]], float)

    def err(a, b):
        pa, pb = c @ np.asarray(a, float).T, c @ np.asarray(b, float).T
        return np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max()

    assert int(count) == int(count_c) > 0
    assert err(h.cpu().numpy(), h_c.numpy()) < 0.5
    assert (canvas.cpu().int() - canvas_c.int()).abs().max() <= 1
    for n in (1, 2):
        with contextlib.redirect_stdout(io.StringIO()):
            hs, cnt = ge.dryrun_multichip(n)
            hs_c, cnt_c = ge.dryrun_multichip(n, device="cpu")
        np.testing.assert_array_equal(cnt, cnt_c)
        assert max(err(a, b) for a, b in zip(hs, hs_c)) < 0.5


def test_benchmark_scripts_on_the_card(tmp_path):
    """bench_torch.py, the throughput script, both sweeps and serial
    against gpu as a user runs them, on small files: exit 0, their JSON
    and CSV, one fetch for a batch's estimates and one for its
    composite group."""
    import csv
    import json
    import subprocess
    import sys

    from pano_tpu_torch import io as tio

    d = tmp_path / "pair"
    d.mkdir()
    paths = []
    for i, im in enumerate(_strip_images(84, n=2)):
        paths.append(str(d / f"a{i}.ppm"))
        tio.write_ppm(paths[-1], im)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PANO_TPU_FORCE_CPU", "PANO_TPU_PROFILE")}

    def run(*args):
        r = subprocess.run([sys.executable, *args], capture_output=True,
                           text=True, timeout=600, env=env, cwd=_REPO)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    out = json.loads(run("bench_torch.py", *paths).strip().splitlines()[-1])
    assert out["device_compute_ms"] > 0 and out["vs_baseline"] is None
    out = json.loads(run("benchmark_throughput_torch.py", "--pairs", "4",
                         *paths).strip().splitlines()[-1])
    assert out["fallback_pairs"] == 0 and out["value"] > 0
    run("benchmark_panorama_torch.py", "--dataset", str(d), "--devices",
        "1,2", "--device-scale", "1.0", "--batch", "2", "--repeats", "1",
        "--csv", str(tmp_path / "dev.csv"), "--plot",
        str(tmp_path / "dev.png"))
    rows = list(csv.DictReader(open(tmp_path / "dev.csv")))
    assert [(r["devices"], r["est_fetches"], r["full_fetches"])
            for r in rows] == [("1", "1", "2"), ("2", "1", "2")]
    run("benchmark_panorama_torch.py", "--dataset", str(d), "--scales",
        "0.5,1.0", "--repeats", "1", "--csv", str(tmp_path / "res.csv"),
        "--plot", str(tmp_path / "res.png"))
    assert len(list(csv.DictReader(open(tmp_path / "res.csv")))) == 2
    run("benchmark_serial_parallel_torch.py", "--datasets", str(d),
        "--repeats", "1", "--csv", str(tmp_path / "sp.csv"), "--plot",
        str(tmp_path / "sp.png"))
    row, = csv.DictReader(open(tmp_path / "sp.csv"))
    assert float(row["gpu_s"]) > 0 and float(row["serial_s"]) > 0


def test_pano_torch_sh_perf_on_the_card(tmp_path):
    """pano_torch.sh build and perf gpu: the report names the overlay
    pair's kernels with device time."""
    import re
    import subprocess

    from pano_tpu_torch import io as tio

    paths = []
    for i, im in enumerate(_strip_images(85, n=2)):
        paths.append(str(tmp_path / f"a{i}.ppm"))
        tio.write_ppm(paths[-1], im)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PANO_TPU_FORCE_CPU", "PANO_TPU_PROFILE")}
    env["PANO_TPU_TRACE_DIR"] = str(tmp_path / "trace")
    script = os.path.join(_REPO, "pano_torch.sh")
    r = subprocess.run(["bash", script, "build"], capture_output=True,
                       text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert r.returncode == 0 and "kernels: " in r.stdout, r.stdout + r.stderr
    r = subprocess.run(["bash", script, "perf", "gpu", *paths, "--out",
                        str(tmp_path / "p.ppm")], capture_output=True,
                       text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    report = open(tmp_path / "gpu_perf_report.txt").read()
    for name in ("harris_scores_kernel", "gather_patches_kernel",
                 "match_kernel", "warp_overlay_canvas_kernel"):
        ms = [float(m.group(1)) for m in re.finditer(
            rf"^  .*{name}.*?\s(\d+\.\d{{3}}) ms  x\d+$", report, re.M)]
        assert ms and sum(ms) > 0, (name, report)
    busy = re.search(r"device busy .*: (\d+\.\d{3}) ms$", report)
    assert busy and float(busy.group(1)) > 0
