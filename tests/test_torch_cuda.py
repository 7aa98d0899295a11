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


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """chip_smoke.py (the kernel table's script): its planted images and
    the main-path checks its phase 5 shares with these tests."""
    import sys

    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def planted():
    """chip_smoke.py's planted 4156x3117 pair (the right image the left
    one's scene shifted by (DX, DY)) on the card, and its strip of four
    crops of one 8356x3169 scene at the STRIP offsets, on the host and on
    the card."""
    import types

    s = _smoke()
    _, strip = s.synthetic_strip(0)
    return types.SimpleNamespace(
        s=s, pair=[torch.from_numpy(im).cuda() for im in s.synthetic_pair(0)],
        strip=strip, strip_dev=[torch.from_numpy(im).cuda() for im in strip])


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


@pytest.mark.parametrize("resident", [True, False],
                         ids=["card_images", "host_images"])
def test_stitch_pair_fast_waits_on_the_card_once(tmp_path, resident):
    """Under torch.profiler, a stitch_pair_fast opens one pano.wait (the
    estimate row's event) and an upload per host image, none for images
    already on the card."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from pano_tpu_torch import PanoConfig, PairStitcher
    from pano_tpu_torch.config import HarrisOptions

    r = np.random.default_rng(57)
    base = r.integers(0, 60, (128, 208, 3)).astype(np.uint8)
    for _ in range(180):
        y, x = r.integers(2, 118), r.integers(2, 198)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    left, right = base[:, 48:].copy(), base[:, :160].copy()
    if resident:
        left, right = (torch.from_numpy(a).cuda() for a in (left, right))
    st = PairStitcher(PanoConfig(harris=HarrisOptions(max_keypoints=512)),
                      print_timing=False, device="cuda")
    st.stitch_pair_fast(left, right)      # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = st.stitch_pair_fast(left, right)
    assert got is not None
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = [e["name"] for e in json.load(open(tmp_path / "t.json"))[
        "traceEvents"] if e.get("cat") == "user_annotation"]
    assert names.count("pano.wait") == 1
    assert names.count("pano.upload") == (0 if resident else 2)
    assert names.count("pano.ransac") == 1


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


# Beside the first test that starts torch.profiler in the process: on the
# H100 machine the profiler's kernel timestamps drift ahead of its host
# clock by ~0.1 ms a second after that first start, and a kernel that
# lands past the end of a short profiled window is dropped from the trace
# (a window of three ~0.05 ms launches lost one of them 15 s after the
# first start, all three 45 s after).
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


_STAGE_LABELS = ("Harris Corner Detection", "Harris Corner Detection",
                 "Harris Corner Matching", "RANSAC Homography Estimation",
                 "Image Stitching")
# case -> (impl, images, flags, the stitch's lines, its launches)
_CLI_CASES = {
    "fold_feather": ("gpu", 2, ["--mode", "fold", "--blend", "feather"],
                     ["Image Stitching (GPU)"],
                     {"K1": 2, "K2": 2, "K3": 1, "K7": 1, "K10": 1, "K4b": 1,
                      "K5": 1}),
    "stages": ("gpu", 2, ["--timing", "stages"],
               [f"{s} (GPU)" for s in _STAGE_LABELS],
               {"K1": 2, "K2": 2, "K3": 1, "K7": 1, "K10": 1, "K4a": 1}),
    "sharded_chain": ("sharded", 4, ["--mode", "chain"], [],
                      {"K1b": 1, "K2": 6, "K3": 3, "K7": 3, "K10": 3,
                       "K4bb": 1, "K6": 3}),
}
# The sharded chain on the planted 4156x3117 strip's files.
_CLI_CASES["sharded_chain_planted"] = _CLI_CASES["sharded_chain"]


@pytest.mark.parametrize("case", list(_CLI_CASES))
def test_cli_modes_on_the_card(tmp_path, case, request):
    """cli.run on the card: fold with feather (K4b + K5), the staged pair
    (its stage lines) and the sharded chain, small and on the planted
    strip: the printed lines with the impl's tag, each kernel's launches,
    and the file equal to the library's panorama (the one-device chain's
    for the sharded one)."""
    import contextlib
    import io
    import re

    from pano_tpu_torch import cli, io as tio
    from pano_tpu_torch import stitch_all_images

    impl, n, flags, stage_lines, want_launches = _CLI_CASES[case]
    tag = "GPU" if impl == "gpu" else "Sharded"
    imgs = (request.getfixturevalue("planted").strip
            if case.endswith("planted") else _strip_images(86, n=n))
    paths = [str(tmp_path / f"s{i}.ppm") for i in range(n)]
    for p, im in zip(paths, imgs):
        tio.write_ppm(p, im)
    out = str(tmp_path / "p.ppm")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, launches = _smoke().launches(
            lambda: cli.run(impl, [*paths, *flags, "--out", out]))
    lines = [re.sub(r": \d+\.\d{3} ms$", ": x ms", x)
             for x in buf.getvalue().splitlines()]
    assert rc == 0 and launches == want_launches, (launches, lines)
    assert lines == [
        "PyTorch backend: cuda",
        f"Number of Available Devices: {torch.cuda.device_count()}",
        *(f"Stitching image {i} of {n}..." for i in range(2, n + 1)),
        *(f"{s}: x ms" for s in stage_lines),
        f"Total Stitching Process ({tag}): x ms",
        f"Stitched result saved to {out}", "",
        f"Total Execution Time ({tag}): x ms"]
    cfg = _smoke().blend_config("feather" if case == "fold_feather"
                                else "overlay")
    with contextlib.redirect_stdout(io.StringIO()):
        want = stitch_all_images(
            imgs, cfg, device="cuda", mode="chain" if n > 2 else "fold",
            timing="stages" if case == "stages" else "total")
    np.testing.assert_array_equal(tio.imread_bgr(out), want)


def test_serve_gpu_on_the_card(tmp_path):
    """serve gpu with four jobs (a chain, with feather, the chain again
    from the staging cache, one image): jobs 1-3 ok and 4 failed, in
    order; no staging failure reported; jobs 1 and 3 byte-equal, and the
    chain of stitch_all_images on the card."""
    import contextlib
    import io
    import re

    from pano_tpu_torch import DEFAULT_CONFIG, cli, io as tio
    from pano_tpu_torch import stitch_all_images

    imgs = _strip_images(87)
    paths = [str(tmp_path / f"s{i}.ppm") for i in range(len(imgs))]
    for p, im in zip(paths, imgs):
        tio.write_ppm(p, im)
    outs = [str(tmp_path / f"o{j}.ppm") for j in range(1, 5)]
    chain = " ".join(paths)
    jobs = io.StringIO(f"{chain} --out {outs[0]}\n"
                       f"{chain} --blend feather --out {outs[1]}\n"
                       f"{chain} --out {outs[2]}\n"
                       f"{paths[0]} --out {outs[3]}\n"
                       "quit\n")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.serve("gpu", ["--mode", "chain"], stdin=jobs)
    assert rc == 0, out.getvalue() + err.getvalue()
    status = re.findall(r"^Job (\d+) (ok|failed) \S+: \d+\.\d{3} ms$",
                        out.getvalue(), re.M)
    assert status == [("1", "ok"), ("2", "ok"), ("3", "ok"),
                      ("4", "failed")], out.getvalue()
    assert "staging" not in err.getvalue(), err.getvalue()
    first, again = (open(p, "rb").read() for p in outs[::2])
    assert first == again
    assert os.path.exists(outs[1]) and not os.path.exists(outs[3])
    with contextlib.redirect_stdout(io.StringIO()):
        want = stitch_all_images(imgs, DEFAULT_CONFIG, mode="chain",
                                 device="cuda")
    np.testing.assert_array_equal(tio.imread_bgr(outs[0]), want)


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


# case -> (mode, data shards, hyp shards); the planted cases run on the
# planted 4156x3117 strip
_SHARDED_CASES = {"chain-1": ("chain", 1, 1), "chain-3": ("chain", 3, 1),
                  "auto-1": ("auto", 1, 1), "auto-3": ("auto", 3, 1),
                  "fold-1": ("fold", 1, 1), "fold-4": ("fold", 1, 4)}
_SHARDED_CASES.update({f"planted-{k}": _SHARDED_CASES[k]
                       for k in ("chain-1", "chain-3", "auto-1", "fold-4")})


@pytest.mark.parametrize("case", list(_SHARDED_CASES))
def test_sharded_modes_on_the_card_equal_one_device(case, request,
                                                    monkeypatch):
    """stitch_all_images_sharded on a mesh of the card (repeated over the
    data or the hyp axis) gives the one-device mode's panorama byte for
    byte. Chain and auto run batched K1 (one launch per data shard, or
    per image stack in auto) and batched K4b; the fold runs the pair's
    kernels and prints the staged fold's lines under the tag (Sharded),
    and on hyp 4 each pair's H is within 0.5 px of its planted offset at
    the image's corners. The planted cases run on the 4156x3117 strip
    (auto on it shuffled)."""
    import contextlib
    import io
    import re

    from pano_tpu_torch import DEFAULT_CONFIG, pipeline, stitch_all_images
    from pano_tpu_torch.parallel import shard

    mode, n_data, n_hyp = _SHARDED_CASES[case]
    if case.startswith("planted"):
        p = request.getfixturevalue("planted")
        order = p.s.AUTO_ORDER if mode == "auto" else range(len(p.s.STRIP))
        imgs = [p.strip_dev[i] for i in order]
        offsets = [p.s.STRIP[i] for i in order]
    else:
        imgs = _strip_images(73, n=3) if mode == "fold" else _strip_images(71)
        offsets = [(70 * i, 0) for i in range(len(imgs))]
    n = len(imgs)
    mesh = shard.make_mesh(n_data, n_hyp,
                           devices=[torch.device("cuda")] * (n_data * n_hyp))
    with contextlib.redirect_stdout(io.StringIO()):
        want = stitch_all_images(imgs, DEFAULT_CONFIG, mode=mode,
                                 device="cuda")
    hs = []
    composite = pipeline.PairStitcher.composite

    def spy(self, left, right, h):
        hs.append(np.array(h, np.float64))
        return composite(self, left, right, h)

    monkeypatch.setattr(pipeline.PairStitcher, "composite", spy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got, launches = _smoke().launches(
            lambda: shard.stitch_all_images_sharded(
                imgs, DEFAULT_CONFIG, mesh=mesh, mode=mode))
    np.testing.assert_array_equal(got, want)
    if mode != "fold":
        assert "K1" not in launches and "K4b" not in launches, launches
        assert launches["K1b"] == (n_data if mode == "chain" else 1)
        assert launches["K4bb"] == n_data
        return
    assert launches == {"K1": 2 * (n - 1), "K2": 2 * (n - 1), "K3": n - 1,
                        "K7": n - 1, "K10": (n - 1) * n_hyp, "K4a": n - 1}
    assert re.sub(r": \d+\.\d{3} ms", ": x ms",
                  out.getvalue()).splitlines() == [
        *(x for i in range(2, n + 1) for x in (
            f"Stitching image {i} of {n}...",
            *(f"{s} (Sharded): x ms" for s in _STAGE_LABELS))),
        "Total Stitching Process (Sharded): x ms"]
    if n_hyp > 1:
        errs = [_smoke().corner_err(g, imgs[0].shape[:2], offsets[i])
                for i, g in enumerate(hs, 1)]
        assert len(errs) == n - 1 and max(errs) < 0.5, errs


@pytest.mark.parametrize("size", ["small", "planted"])
def test_stitch_pairs_batched_on_the_card(size, request):
    """Four pairs on the default mesh (every card, one hyp), small crops
    or the planted strip's three pairs and the planted pair (4156x3117):
    each estimate row torch.equal to the pair stitcher's, each canvas
    PairStitcher.composite's of that row's H, through one batched K1
    launch, K2 x8, K3 x4, K7 x4, K10 x4, K5 x4 and a batched K4b launch
    for each group of equal canvases (1-4)."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.parallel import shard

    assert shard.make_mesh().shape == {"data": torch.cuda.device_count(),
                                       "hyp": 1}
    if size == "planted":
        p = request.getfixturevalue("planted")
        lefts = torch.stack([*p.strip_dev[:3], p.pair[0]])
        rights = torch.stack([*p.strip_dev[1:], p.pair[1]])
    else:
        imgs = [torch.from_numpy(im).cuda() for im in _strip_images(74, n=5)]
        lefts, rights = torch.stack(imgs[:4]), torch.stack(imgs[1:])
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    rows, _ = shard.fused_estimate_batched(lefts, rights, DEFAULT_CONFIG)
    singles = [st._fused_estimate_impl(lefts[k], rights[k])[0]
               for k in range(4)]
    assert all(torch.equal(rows[k], singles[k]) for k in range(4))
    panos, launches = _smoke().launches(lambda: shard.stitch_pairs_batched(
        lefts, rights, DEFAULT_CONFIG))
    groups = launches.pop("K4bb")
    assert launches == {"K1b": 1, "K2": 8, "K3": 4, "K7": 4, "K10": 4,
                        "K5": 4}
    assert 1 <= groups <= 4
    for k, row in enumerate(singles):
        h = row[:9].cpu().numpy().astype(np.float64).reshape(3, 3)
        want = st.composite(lefts[k], rights[k], h)
        assert torch.equal(torch.from_numpy(panos[k]), want.cpu())


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


@pytest.mark.parametrize("depth,size", [
    pytest.param(1, "small", id="1"), pytest.param(3, "small", id="3"),
    pytest.param(1, "planted", id="planted-1"),
    pytest.param(3, "planted", id="planted-3")])
def test_throughput_loop_on_the_card(depth, size, request):
    """The throughput script's loop on three small pairs of different
    canvases, or on the planted 4156x3117 pair: no fallback, the overlay
    pair's launches once for each pair of the loop and its warm-up, every
    retired panorama and row the single-sync path's, and no host sync
    inside a pair."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    _, bt, _, _ = _scripts()
    pairs = (_shifted_pairs(81) if size == "small"
             else [tuple(request.getfixturevalue("planted").pair)])
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    want = [_parent_path(st, left, right) for left, right in pairs]
    out, launches = _smoke().launches(
        lambda: bt.throughput(st, *pairs[0], 6, depth))
    assert out["fallback_pairs"] == 0 and out["depth"] == depth
    assert launches == {k: 7 * n for k, n in _smoke().PAIR_LAUNCHES.items()}
    reps = 6 // len(pairs)
    got = list(bt.pipelined(st, pairs * reps, depth))
    assert len(got) == 6
    for (pano, row), (want_pano, want_row) in zip(got, want * reps):
        assert torch.equal(pano, want_pano)
        np.testing.assert_array_equal(row, want_row)
    # Nothing waits for the card inside a pair but retire's event.
    syncs = bt.host_syncs_per_pair(st, *pairs[0], 2)
    assert syncs == 0


def test_bench_measure_on_the_card(planted):
    """bench.py's keys, device_compute_ms between 0 and the wall value,
    the overlay pair's launches once for the warm-up, each timed call and
    each traced one, and the block's last panorama stitch_pair_fast's: on
    a small pair and on the planted 4156x3117 pair."""
    import ast

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    bench, _, _, _ = _scripts()
    tree = ast.parse(open(f"{_REPO}/bench.py").read())
    keys = {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            and any(isinstance(k, ast.Constant) and k.value == "metric"
                    for k in node.keys) for k in node.keys}
    keys |= {"device_compute_ms"}   # added where bench.py's trace worked
    calls = 1 + 2 + bench.TRACE_REPS
    for left, right in (_strip_images(82, n=2), planted.pair):
        (out, pano), launches = _smoke().launches(
            lambda: bench._measure(left, right, 2, "cuda"))
        assert set(out) == keys == {"metric", "value", "unit", "vs_baseline",
                                    "device_compute_ms"}
        assert 0 < out["device_compute_ms"] < out["value"]
        assert launches == {k: calls * n
                            for k, n in _smoke().PAIR_LAUNCHES.items()}
        want = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                            device="cuda").stitch_pair_fast(left, right)
        assert torch.equal(pano, want)


def test_graft_entry_on_the_card():
    """entry() and dryrun_multichip(1), (2) on the card (repeated where
    there is one) against the CPU's: the same inlier counts, H within
    0.5 px at the corners; the entry's forward step launches the pair's
    estimate kernels and no compose kernel."""
    import contextlib
    import io

    _, _, ge, _ = _scripts()
    fn, args = ge.entry()
    assert all(a.device.type == "cuda" for a in args)
    (h, count, canvas), launches = _smoke().launches(lambda: fn(*args))
    assert launches == {"K1": 2, "K2": 2, "K3": 1, "K7": 1, "K10": 1}
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


def _big(shape, dtype, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, dtype=dtype,
                             device=device)
    return torch.randn(shape, generator=g, device=device)


@pytest.mark.parametrize("shape,dtype", [((3117, 4156, 3), torch.uint8),
                                         ((3169, 8356), torch.float32)])
def test_fetch_image_pinned_route(shape, dtype):
    """A large CUDA tensor lands in page-locked memory, equal to the
    pageable copy; a small one and a 0-d one take the plain copy."""
    from pano_tpu_torch.timer import fetch_image

    x = _big(shape, dtype, 90)
    got = fetch_image(x)
    assert isinstance(got, np.ndarray) and got.shape == shape
    assert torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(got, x.cpu().numpy())
    small = x[:8]
    assert not torch.from_numpy(fetch_image(small)).is_pinned()
    np.testing.assert_array_equal(fetch_image(small), small.cpu().numpy())
    scalar = x[(0,) * x.dim()]
    assert scalar.dim() == 0 and fetch_image(scalar) == scalar.item()


def test_fetch_image_results_never_alias():
    """A held result is not overwritten by a later fetch of the same
    shape; a dropped one's block may be reused, and the next result is
    still the new data."""
    from pano_tpu_torch.timer import fetch_image

    shape = (3117, 4156, 3)
    first = fetch_image(_big(shape, torch.uint8, 91))
    kept = first.copy()
    second = fetch_image(_big(shape, torch.uint8, 92))
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    want = _big(shape, torch.uint8, 93)
    del first, second
    np.testing.assert_array_equal(fetch_image(want), want.cpu().numpy())


def test_fetch_image_fails_without_a_fallback(monkeypatch):
    """A failed pin raises; there is no quiet pageable copy."""
    from pano_tpu_torch import timer

    real_empty = torch.empty

    def no_pinning(*args, **kw):
        if kw.get("pin_memory"):
            raise RuntimeError("pinning refused")
        return real_empty(*args, **kw)

    monkeypatch.setattr(timer.torch, "empty", no_pinning)
    with pytest.raises(RuntimeError, match="pinning refused"):
        timer.fetch_image(_big((3117, 4156, 3), torch.uint8, 94))


def test_fetch_image_on_a_card_that_is_not_current():
    """A tensor on the second card, written by kernels still queued on
    that card's stream while the first card is current: the copy and its
    event are on the second card's stream, so the result is complete."""
    from pano_tpu_torch.timer import fetch_image

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    with torch.cuda.device(0):
        x = _big((3169, 8356), torch.float32, 95, device="cuda:1")
        for _ in range(20):
            x = x * 1.0001 + 0.5
        got = fetch_image(x)
    np.testing.assert_array_equal(got, x.cpu().numpy())


@pytest.mark.parametrize("fn,kernel", [
    ("conv2d_valid_zero_border", lambda c: c.sobel_x_kernel()),
    ("conv2d_valid_zero_border", lambda c: c.sobel_y_kernel()),
    ("conv2d_valid_zero_border", lambda c: c.gaussian_kernel(7, 1.5)),
    ("conv2d_separable_valid_zero_border",
     lambda c: c.gaussian_kernel_1d(5, 1.0)),
    ("conv2d_separable_valid_zero_border",
     lambda c: c.gaussian_kernel_1d(7, 1.5)),
], ids=["sobel_x", "sobel_y", "gauss7", "sep_gauss5", "sep_gauss7"])
@pytest.mark.parametrize("shape", [(33, 41), (3, 240, 320)])
def test_conv_on_the_card_equals_cpu(shape, fn, kernel):
    """The tap sums round each weight to f32 once on either device, and
    eager elementwise kernels do not contract a * b + c."""
    from pano_tpu_torch.ops import conv

    img = torch.from_numpy(np.random.default_rng(96).normal(
        scale=50.0, size=shape).astype(np.float32))
    want = getattr(conv, fn)(img, kernel(conv))
    got = getattr(conv, fn)(img.cuda(), kernel(conv))
    assert torch.equal(got.cpu(), want)


# --- K7 and the estimate paths with no host sync ----------------------------

_EIGH_CASES = ("spd0", "spd1", "spd2", "spd3", "spd4", "spd5", "spd_small",
               "spd_large", "graded0", "graded1", "diagonal", "tied",
               "indefinite", "zero")


def _eigh_matrix(name):
    """tests/test_torch_eigh.py's kinds of matrix, made without JAX: random
    SPD at three scales, graded (1e-4 and 0.1 to 1e3), diagonal, a tied
    smallest pair, an indefinite symmetric one and zero."""
    if name.startswith("spd"):
        seed, scale = {"spd_small": (11, 1e-3), "spd_large": (12, 1e3)
                       }.get(name) or (int(name[3:]), 1)
        a = np.random.default_rng(seed).standard_normal((9, 9)) * scale
        return (a @ a.T).astype(np.float32)
    if name in ("graded0", "graded1", "tied"):
        seed = {"graded0": 20, "graded1": 21, "tied": 40}[name]
        q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((9, 9)))
        lam = (np.array([0.25, 0.25, 1, 2, 3, 4, 5, 6, 7]) if name == "tied"
               else np.r_[1e-4, np.logspace(-1, 3, 8)])
        return ((q * lam) @ q.T).astype(np.float32)
    if name == "diagonal":
        return np.diag(np.random.default_rng(30).uniform(0.5, 5.0, 9)
                       ).astype(np.float32)
    if name == "indefinite":
        a = np.random.default_rng(50).standard_normal((9, 9))
        return (a + a.T).astype(np.float32)
    return np.zeros((9, 9), np.float32)


@pytest.mark.parametrize("name", _EIGH_CASES)
def test_eigh9_kernel_vs_plain(name):
    """K7 bit-identical to its plain version (f64 rotations in the same
    order under -fmad=false), one launch, and an eigenvector of the
    smallest eigenvalue."""
    from pano_tpu_torch.ops import cuda_eigh

    a = torch.from_numpy(_eigh_matrix(name)).cuda()
    before = cuda_eigh.launches
    got = cuda_eigh.smallest_eigvec9(a)
    assert cuda_eigh.launches == before + 1
    assert got.device == a.device and got.dtype == torch.float32
    assert torch.equal(got, cuda_eigh.smallest_eigvec9_plain(a))
    a64, v = a.cpu().double().numpy(), got.cpu().double().numpy()
    w = np.linalg.eigvalsh(a64)
    assert np.linalg.norm(a64 @ v - w[0] * v) <= 1e-5 * max(
        np.linalg.norm(a64, 2), 1e-30)


def _planted_normal_matrices():
    """The refine's A^T A of chip_smoke.py's planted 4156x3117 pair and of
    three small pairs, as the card's estimate hands them to K7."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.ops import cuda_eigh

    seen = []
    kernel = cuda_eigh.smallest_eigvec9

    def record(ata):
        seen.append(ata.clone())
        return kernel(ata)

    # The default table injected: the eager estimate calls the wrapper on
    # every pair (a replay of the estimate's graph calls no Python).
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda",
                      sampler=_default_table(DEFAULT_CONFIG.ransac))
    pairs = [tuple(torch.from_numpy(im).cuda()
                   for im in _smoke().synthetic_pair(0))]
    pairs += _shifted_pairs(97)
    cuda_eigh.smallest_eigvec9 = record
    try:
        for left, right in pairs:
            st._fused_estimate_impl(left, right)
    finally:
        cuda_eigh.smallest_eigvec9 = kernel
    assert len(seen) == len(pairs)
    return seen


def test_eigh9_kernel_on_the_refines_normal_matrices():
    from pano_tpu_torch.ops import cuda_eigh

    for ata in _planted_normal_matrices():
        got = cuda_eigh.smallest_eigvec9(ata)
        assert torch.equal(got, cuda_eigh.smallest_eigvec9_plain(ata))
        a64 = ata.cpu().double().numpy()
        want = np.linalg.eigh(a64)[1][:, 0]
        assert 1.0 - abs(got.cpu().double().numpy() @ want) <= 1e-5


def _flagged_syncs(fn):
    """fn() once to warm its per-device tables, then again under
    torch.cuda.set_sync_debug_mode("warn"): where each synchronizing CUDA
    operation it ran was called (file:line), and its result."""
    import warnings

    fn()
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)], out


@pytest.mark.parametrize("path", ["dispatch", "chain_pending",
                                  "auto_pair_rows", "hyp_search",
                                  "batched", "dispatch_aligned"])
def test_estimate_paths_do_not_sync_on_the_card(path):
    """Every path that estimates a pair enqueues its whole estimate with no
    host sync before its one fetch: the pair's dispatch, the chain's
    pending estimates, auto's detection and pair rows, the hyp-sharded
    search on a mesh of the card, the batched estimate, the pair's
    dispatch with the direct alignment."""
    import dataclasses

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher, pipeline
    from pano_tpu_torch.parallel import shard

    cfg = DEFAULT_CONFIG
    if path == "dispatch_aligned":
        cfg = cfg.replace(ransac=dataclasses.replace(cfg.ransac,
                                                     align_iterations=3))
    imgs = [torch.from_numpy(im).cuda() for im in _strip_images(98)]
    st = PairStitcher(cfg, print_timing=False, device="cuda")
    if path in ("dispatch", "dispatch_aligned"):
        def fn():
            return st.dispatch(imgs[0], imgs[1]).row
    elif path == "chain_pending":
        def fn():
            return torch.stack([st._fused_estimate_impl(imgs[i - 1],
                                                        imgs[i])[0]
                                for i in range(1, len(imgs))])
    elif path == "auto_pair_rows":
        def fn():
            feats = [pipeline.auto_detect(d, cfg.harris) for d in imgs]
            return torch.stack([
                pipeline.auto_pair_row(feats[j], feats[i], cfg)
                for i in range(len(imgs)) for j in range(i + 1, len(imgs))])
    elif path == "hyp_search":
        mesh = shard.make_mesh(1, 2, devices=[torch.device("cuda")] * 2)
        _, (pq, pt, v) = st._fused_estimate_impl(imgs[0], imgs[1])

        def fn():
            return shard._hyp_search(mesh, 0, pq, pt, v, cfg.ransac,
                                     cfg.ransac.num_iterations // 2).H
    else:
        mesh = shard.make_mesh(1, 1)

        def fn():
            return shard.fused_estimate_batched(
                torch.stack(imgs[:3]), torch.stack(imgs[1:]), cfg, mesh)[0]
    syncs, out = _flagged_syncs(fn)
    assert syncs == []
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


# --- the estimate as a CUDA graph --------------------------------------------


def _default_table(r_opts):
    """The default table, given explicitly: ransac_homography then runs
    the eager estimate."""
    from pano_tpu_torch.ops import ransac

    return ransac.default_sampler(r_opts.num_iterations, r_opts.num_samples,
                                  r_opts.seed, "cuda")


def _planted_and_strip_points():
    """The match points of chip_smoke.py's planted 4156x3117 pair and of
    its strip's three adjacent pairs, as the fused estimate hands them to
    RANSAC (found by the eager estimate)."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda",
                      sampler=_default_table(DEFAULT_CONFIG.ransac))
    pair = [torch.from_numpy(im).cuda() for im in _smoke().synthetic_pair(0)]
    strip = [torch.from_numpy(im).cuda()
             for im in _smoke().synthetic_strip(0)[1]]
    pairs = [tuple(pair)] + list(zip(strip[:-1], strip[1:]))
    return [st._fused_estimate_impl(a, b)[1] for a, b in pairs]


def _assert_equal_results(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_graphed_estimate_equals_the_eager_one():
    """On the planted pair and the strip's three pairs, the graphed
    ransac_homography (its capture's result, then replays) is torch.equal
    to the eager estimate with the explicit default table in every
    field."""
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import ransac

    r = DEFAULT_CONFIG.ransac
    table = _default_table(r)
    replays = ransac.graph_replays
    for pts in _planted_and_strip_points():
        want = ransac._estimate(*pts, r, table)
        for _ in range(2):
            _assert_equal_results(ransac.ransac_homography(*pts, r), want)
        assert bool(want.ok)
    assert ransac.graph_replays >= replays + 7


def test_graphed_results_survive_later_replays():
    """A result a caller holds is a copy: two estimates on different
    pairs, then the first result is still the first pair's."""
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import ransac

    r = DEFAULT_CONFIG.ransac
    a, b = _planted_and_strip_points()[:2]
    ransac.ransac_homography(*a, r)     # the key's capture, if not yet
    replays = ransac.graph_replays
    first = ransac.ransac_homography(*a, r)
    second = ransac.ransac_homography(*b, r)
    torch.cuda.synchronize()
    assert ransac.graph_replays == replays + 2
    assert not torch.equal(first.H, second.H)
    _assert_equal_results(first, ransac._estimate(*a, r, _default_table(r)))
    _assert_equal_results(second, ransac._estimate(*b, r, _default_table(r)))


def test_graph_is_captured_once_per_key():
    """One capture, then only replays, for repeated calls of one key;
    other options (refine off) and another K each get their own graph;
    each result equal to the eager estimate."""
    from pano_tpu_torch.config import RansacOptions
    from pano_tpu_torch.ops import ransac

    pts = _planted_and_strip_points()[1]
    # K + 128: the same valid rows, 128 more invalid ones
    padded = tuple(torch.cat([t, torch.zeros_like(t[:128])]) for t in pts)
    for opts, p in ((RansacOptions(seed=4242), pts),
                    (RansacOptions(seed=4242, refine=False), pts),
                    (RansacOptions(seed=4242), padded)):
        captures, replays = ransac.graph_captures, ransac.graph_replays
        want = ransac._estimate(*p, opts, _default_table(opts))
        for _ in range(4):
            _assert_equal_results(ransac.ransac_homography(*p, opts), want)
        assert (ransac.graph_captures - captures,
                ransac.graph_replays - replays) == (1, 3)
    assert len(ransac._graphs) <= ransac.GRAPH_CACHE_SIZE


def test_dispatch_in_flight_equals_the_eager_estimate():
    """dispatch with three pairs in flight, each on the graphed estimate,
    retires the panoramas and rows of the eager estimate's
    stitch_pair_fast (the parent's path)."""
    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher
    from pano_tpu_torch.ops import ransac

    pairs = _shifted_pairs(99)
    eager = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda",
                         sampler=_default_table(DEFAULT_CONFIG.ransac))
    want = []
    for left, right in pairs:
        want.append((eager.stitch_pair_fast(left, right),
                     eager.last_estimate.copy()))
    st = PairStitcher(DEFAULT_CONFIG, print_timing=False, device="cuda")
    st.stitch_pair_fast(*pairs[0])      # the key's capture, if not yet
    replays = ransac.graph_replays
    pending = [st.dispatch(left, right) for left, right in pairs]
    assert ransac.graph_replays == replays + 3
    for p, (want_pano, want_row) in zip(pending, want):
        pano = st.retire(p)
        assert torch.equal(pano, want_pano)
        np.testing.assert_array_equal(st.last_estimate, want_row)


# --- K10: RANSAC's hypothesis search (ops/cuda_ransac.py, csrc/ransac.cu) --

_SEARCH_CASES = ("planted", "strip01", "strip12", "strip23", "n_valid0",
                 "n_valid3", "n_valid4", "n_valid5", "shard250", "n37",
                 "ties", "pivot_ties")


@pytest.fixture(scope="module")
def search_inputs():
    """case -> (pts_src, pts_dst, valid, idx) on the card: the planted
    pair's and the strip's three pairs' match points with the default
    table; the planted points with n_valid cut to 0, 3, 4 and 5
    (degenerate and NaN hypotheses, all-zero counts); a shard's table of
    250 (key_sampler of fold_in(seed, 1)) and 37 hypotheses (not a
    multiple of the tile); exact integer translations, where most
    hypotheses tie at the top count, behind five degenerate rows; and the
    corners of a rectangle, whose normalized coordinates tie in the
    pivot's magnitude."""
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import ransac

    r = DEFAULT_CONFIG.ransac
    table = _default_table(r)
    pts = _planted_and_strip_points()
    cases = {name: (*p, table(p[2].sum(dtype=torch.int32)))
             for name, p in zip(_SEARCH_CASES[:4], pts)}
    pq, pt, v = pts[0]
    for nv in (0, 3, 4, 5):
        cut = torch.arange(v.shape[0], device="cuda") < nv
        cases[f"n_valid{nv}"] = (pq, pt, cut,
                                 table(cut.sum(dtype=torch.int32)))
    n_valid = v.sum(dtype=torch.int32)
    key = ransac.fold_in(ransac.prng_key(r.seed), 1)
    cases["shard250"] = (pq, pt, v, ransac.key_sampler(
        key, 250, 4, "cuda")(n_valid))
    cases["n37"] = (pq, pt, v, ransac.key_sampler(key, 37, 4, "cuda")(
        n_valid))
    g = np.random.default_rng(5)
    src = torch.from_numpy(g.integers(0, 3000, (8192, 2)).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, 8192, (1000, 4)))
    idx[:5] = 17
    cases["ties"] = (src.cuda(), (src + torch.tensor([1400.0, 37.0])).cuda(),
                     torch.ones(8192, dtype=torch.bool, device="cuda"),
                     idx.cuda())
    rect = torch.tensor([[10.0, 10.0], [50.0, 10.0], [50.0, 30.0],
                         [10.0, 30.0]], device="cuda")
    cases["pivot_ties"] = (rect, rect * 1.5 + 3.0,
                           torch.ones(4, dtype=torch.bool, device="cuda"),
                           torch.tensor([[0, 1, 2, 3], [3, 2, 1, 0],
                                         [0, 2, 1, 3]], device="cuda"))
    return cases


@pytest.mark.parametrize("case", _SEARCH_CASES)
def test_ransac_search_kernel_vs_plain(search_inputs, case):
    """K10 equal to its plain version in every output (hs row by row,
    NaN rows NaN in both; counts; the winner and its count), one launch,
    and the winner the first hypothesis at the top count."""
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import cuda_ransac

    pq, pt, v, idx = search_inputs[case]
    thresh = DEFAULT_CONFIG.ransac.distance_threshold
    before = cuda_ransac.launches
    got = cuda_ransac.search(pq, pt, v, idx, thresh)
    assert cuda_ransac.launches == before + 1
    want = cuda_ransac.search_plain(pq, pt, v, idx, thresh)
    for name, a, b in zip(("hs", "counts", "best_h", "best_count"), got, want):
        assert a.device == b.device and _smoke().equal_nan(a, b), name
    hs, counts, best_h, best_count = got
    first = int((counts == counts.max()).nonzero()[0])
    assert int(best_count) == int(counts.max())
    assert _smoke().equal_nan(best_h, hs[first])
    if case in ("n_valid0", "n_valid3"):
        assert bool(torch.isnan(hs).all()) and int(counts.max()) == 0
    if case == "ties":
        assert first >= 5 and int((counts == counts.max()).sum()) > 900
        assert bool(torch.isnan(hs[:5]).all()) and int(counts[:5].max()) == 0


def test_ransac_search_refuses_misaligned_points():
    """The kernel reads a point as one 8-byte word: points at an odd
    float offset raise before any launch."""
    from pano_tpu_torch.ops import cuda_ransac

    flat = torch.zeros(2 * 64 + 1, device="cuda")
    pts = flat[1:].view(64, 2)
    valid = torch.ones(64, dtype=torch.bool, device="cuda")
    idx = torch.zeros((8, 4), dtype=torch.int64, device="cuda")
    before = cuda_ransac.launches
    with pytest.raises(ValueError, match="aligned"):
        cuda_ransac.search(pts, pts, valid, idx, 3.0)
    assert cuda_ransac.launches == before


def test_ransac_search_graph_replays_do_not_carry_the_winner(search_inputs):
    """K10 captured alone in a CUDA graph and replayed on three inputs in
    turn (the planted points; the same with half the matches valid, so
    every count is lower; the planted points again): each replay equal to
    the eager search. A first-maximum slot left over from a replay would
    hand the second its predecessor's winner."""
    from pano_tpu_torch import DEFAULT_CONFIG
    from pano_tpu_torch.ops import cuda_ransac

    thresh = DEFAULT_CONFIG.ransac.distance_threshold
    pq, pt, v, idx = search_inputs["planted"]
    half = v & (torch.arange(v.shape[0], device="cuda") < int(v.sum()) // 2)
    static = [t.clone() for t in (pq, pt, v, idx)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_ransac.search(*static, thresh)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_ransac.search(*static, thresh)
    counts = []
    for inputs in ((pq, pt, v, idx), (pq, pt, half, idx), (pq, pt, v, idx)):
        for buf, t in zip(static, inputs):
            buf.copy_(t)
        graph.replay()
        want = cuda_ransac.search(*inputs, thresh)
        torch.cuda.synchronize()
        for name, a, b in zip(("hs", "counts", "best_h", "best_count"),
                              out, want):
            assert _smoke().equal_nan(a, b), name
        counts.append(int(out[3]))
    assert counts[1] < counts[0] == counts[2]


def test_ransac_search_launches_per_estimate():
    """One K10 launch for each estimate: the eager one with an injected
    table, the graphed one's capture and each replay; ransac.launches is
    the profiler's and stays one graph launch."""
    from pano_tpu_torch.config import RansacOptions
    from pano_tpu_torch.ops import cuda_ransac, ransac

    pts = _planted_and_strip_points()[0]
    opts = RansacOptions(seed=2024)     # a key of its own: captured here
    table = _default_table(opts)
    for fn in (lambda: ransac._estimate(*pts, opts, table),
               lambda: ransac.ransac_homography(*pts, opts),
               lambda: ransac.ransac_homography(*pts, opts)):
        before = cuda_ransac.launches
        fn()
        torch.cuda.synchronize()
        assert cuda_ransac.launches == before + 1


# --- the direct alignment (ops/cuda_align.py, csrc/align.cu) ----------------


@pytest.fixture(scope="module")
def rotating_4k():
    """The rotating camera's first and last rotate_serial poses (yaw 30
    and 40 degrees) at 4156x3117 on the card (pano_bench's rotating scene
    model), the rotating_pair_4k configuration, and each pair's RANSAC H
    without the alignment."""
    import dataclasses
    import json
    import sys
    import types

    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    from pano_bench.run import pano_config
    from pano_bench.scene_models import rotating
    from pano_tpu_torch import PairStitcher

    bench = os.path.join(_REPO, "pano_bench")
    with open(os.path.join(bench, "configs", "rotating_pair_4k.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "traffic", "rotate_serial.json")) as f:
        traffic = json.load(f)
    traffic["scenes"] = [traffic["scenes"][0], traffic["scenes"][-1]]
    pool = rotating.make_pool(traffic, cfg, 4200000001, "cuda", "device")
    conf = pano_config(cfg["pano_config"])
    st = PairStitcher(conf.replace(ransac=dataclasses.replace(
        conf.ransac, align_iterations=0)), print_timing=False, device="cuda")
    hs = []
    for scene in pool:
        st.stitch_pair_fast(*scene.images)
        hs.append(torch.from_numpy(st.last_estimate[:9].copy())
                  .reshape(3, 3).cuda())
    return types.SimpleNamespace(pool=pool, conf=conf, hs=hs)


def _corners(h, hw):
    """Image corners (0, 0), (w, 0), (w, h), (0, h) mapped by `h`."""
    c = np.array([[0, 0, 1], [hw[1], 0, 1], [hw[1], hw[0], 1],
                  [0, hw[0], 1]], np.float64)
    q = c @ np.asarray(h, np.float64).T
    return q[:, :2] / q[:, 2:]


@pytest.mark.parametrize("k", [0, 1])
def test_align_kernel_vs_plain(rotating_4k, k):
    """K11 against its plain version at 4156x3117 on a rotating pair from
    RANSAC's H, in iterations + 1 launches a call: the overlap's pixel
    counts and the singular flag equal (the same float32 mask), the mean
    squared residuals within 1e-9 relative and image 1's corners of the
    aligned H within 1e-4 px (the float64 sums run in another order: the
    first card run read 2.6e-12 px)."""
    from pano_tpu_torch.ops import align, cuda_align

    left, right = rotating_4k.pool[k].images
    iters = rotating_4k.conf.ransac.align_iterations
    fr = cuda_align.frame(left.shape[:2], right.shape[:2])
    p0 = align.to_normalized(rotating_4k.hs[k], fr)
    before = cuda_align.launches
    got = cuda_align.gauss_newton(p0, left, right, iters, fr)
    assert cuda_align.launches == before + iters + 1
    want = cuda_align.gauss_newton_plain(p0, left, right, iters, fr)
    ne = [cuda_align.N_START, cuda_align.N_END, cuda_align.SINGULAR]
    assert torch.equal(got[ne], want[ne])
    assert float(got[cuda_align.SINGULAR]) == 0.0
    e = [cuda_align.E_START, cuda_align.E_END]
    assert torch.allclose(got[e], want[e], rtol=1e-9, atol=0)
    hw = left.shape[:2]
    d = _corners(align.from_normalized(got[:8], fr).cpu(), hw) \
        - _corners(align.from_normalized(want[:8], fr).cpu(), hw)
    assert np.abs(d).max() <= 1e-4


def test_align_in_the_estimate_graph(rotating_4k):
    """The alignment inside the estimate's CUDA graph: a replay runs
    K11's iterations + 1 passes and waits nowhere, its row equals the
    eager estimate's (the default table injected) bit for bit, and image
    1's corners land within half a pixel of the planted ones (0.03-0.43
    px on 176 pairs of the diagnostic runs), where RANSAC's land
    0.3-14 px off."""
    from pano_tpu_torch import PairStitcher
    from pano_tpu_torch.ops import cuda_align, ransac

    conf = rotating_4k.conf
    iters = conf.ransac.align_iterations
    st = PairStitcher(conf, print_timing=False, device="cuda")
    eager = PairStitcher(conf, print_timing=False, device="cuda",
                         sampler=_default_table(conf.ransac))
    for k, scene in enumerate(rotating_4k.pool):
        left, right = scene.images
        st.dispatch(left, right)                # captured on the first
        torch.cuda.synchronize()
        replays = ransac.graph_replays
        before = cuda_align.launches
        syncs, row = _flagged_syncs(lambda: st.dispatch(left, right).row)
        assert syncs == []
        assert ransac.graph_replays == replays + 2
        assert cuda_align.launches == before + 2 * (iters + 1)
        torch.cuda.synchronize()
        want, _ = eager._fused_estimate_impl(left, right)
        assert torch.equal(row, want.cpu())
        g = scene.planted[1]
        err = np.abs(_corners(row[:9].double().reshape(3, 3).numpy(),
                              left.shape[:2])
                     - _corners(g, left.shape[:2])).max()
        assert err <= 0.5, (k, err)


def test_rotating_compose_on_the_whole_pixel_frame(rotating_4k):
    """K4a on a rotating pair's quadrilateral footprint at 4156x3117: the
    aligned stitch's panorama against the reference drawn with its own H
    on its whole-pixel frame (``compose_reference.py``), the same canvas
    and every channel within 2 outside the border band (1 on each of the
    CPU tests' scenes at 320x256)."""
    from compose_reference import compose_max_d
    from pano_tpu_torch import PairStitcher

    st = PairStitcher(rotating_4k.conf, print_timing=False, device="cuda")
    for k, scene in enumerate(rotating_4k.pool):
        pano = st.stitch_pair_fast(*scene.images)
        h = st.last_estimate[:9].astype(np.float64).reshape(3, 3)
        canvas_px, pixel = compose_max_d(pano, *scene.images, h)
        assert canvas_px == 0 and pixel <= 2, (k, canvas_px, pixel)


# --- multiband's pyramid kernels (ops/cuda_blend.py, csrc/pyramid.cu) -------

CHAIN_WINDOW = (1504, 2016)  # a chain window of the oilseed images, padded


def _blend_inputs(shape, seed, mask="seam"):
    """(a, b, mask) on the card as _multiband_compose hands them over:
    two (H, W, 3) f32 images of whole numbers, a 0/1 seam mask."""
    r = np.random.default_rng(seed)
    h, w = shape
    a = r.integers(0, 256, (h, w, 3)).astype(np.float32)
    b = r.integers(0, 256, (h, w, 3)).astype(np.float32)
    m = {"seam": (np.arange(w)[None, :] + r.integers(-3, 4, (h, 1))
                  > w // 2).astype(np.float32),
         "zeros": np.zeros((h, w), np.float32),
         "ones": np.ones((h, w), np.float32)}[mask]
    return [torch.from_numpy(x).cuda() for x in (a, b, m)]


def _pyramid_levels(shape, seed, levels=5):
    """The 7 planes of each Gaussian level of a window (level 0 the
    channels of the (H, W, 3) images), by the plain REDUCE."""
    from pano_tpu_torch.ops import cuda_blend

    a, b, m = _blend_inputs(shape, seed)
    gs = [[*a.unbind(-1), *b.unbind(-1), m]]
    for _ in range(levels - 1):
        gs.append(list(cuda_blend.reduce_plain(gs[-1])))
    return gs


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_pyramid_reduce_kernel_vs_plain(level):
    """REDUCE of a chain window's level (level 0 the strided channels of
    the images) bit-identical to its plain version, ops/blend.py's _down,
    on the card, in one launch of all 7 planes."""
    from pano_tpu_torch.ops import cuda_blend

    planes = _pyramid_levels(CHAIN_WINDOW, 80)[level]
    cuda_blend.reduce_launches = 0
    got = cuda_blend.reduce(planes)
    assert cuda_blend.reduce_launches == 1
    assert torch.equal(got, cuda_blend.reduce_plain(planes))


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_pyramid_collapse_kernel_vs_plain(level):
    """The collapse step at each level of a chain window (4 the top:
    the band alone; 0 reading the strided channels of the images)
    bit-identical to its plain version, ops/blend.py's _up, band and
    collapse, with a coarse result that takes negative values."""
    from pano_tpu_torch.ops import cuda_blend

    gs = _pyramid_levels(CHAIN_WINDOW, 81)
    coarse = None
    if level < 4:
        r = torch.Generator(device="cuda").manual_seed(82)
        out = torch.rand((3,) + tuple(gs[level + 1][0].shape),
                         generator=r, device="cuda") * 400 - 100
        coarse = gs[level + 1][:6] + list(out)
    cuda_blend.collapse_launches = 0
    got = cuda_blend.collapse_step(gs[level], coarse)
    assert cuda_blend.collapse_launches == 1
    assert torch.equal(got, cuda_blend.collapse_step_plain(gs[level], coarse))


@pytest.mark.parametrize("shape", [CHAIN_WINDOW, (16, 16), (1024, 32),
                                   (32, 1024)])
@pytest.mark.parametrize("mask", ["seam", "zeros", "ones"])
def test_laplacian_blend_kernels_vs_plain_route(shape, mask):
    """The whole 5-level blend on the card, 4 REDUCE and 5 collapse
    launches, bit-identical to ops/blend.py's tap-per-launch route there:
    a chain window, the smallest window (its top level 1x1), tall and
    wide windows, masks all 0 and all 1."""
    from pano_tpu_torch.ops import blend, cuda_blend

    a, b, m = _blend_inputs(shape, 83, mask)
    cuda_blend.reduce_launches = cuda_blend.collapse_launches = 0
    got = cuda_blend.laplacian_blend(a, b, m, 5)
    assert (cuda_blend.reduce_launches, cuda_blend.collapse_launches) \
        == (4, 5)
    assert got.is_cuda and got.shape == a.shape
    assert torch.equal(got, blend.laplacian_blend(a, b, m, 5))


@pytest.mark.parametrize("case", ["chain", "small", "left_only",
                                  "right_only", "tall", "wide"])
def test_multiband_compose_kernels_vs_plain_route(case, monkeypatch):
    """_multiband_compose of an exact window (padded to 16 inside) with
    the kernels against the plain route on the card: torch.equal u8, one
    REDUCE of the 7 planes a level below the top and a collapse step a
    level, per window; windows that only one image covers, the smallest
    window, tall and wide ones."""
    from pano_tpu_torch.ops import blend, cuda_blend
    from pano_tpu_torch.ops import warp as warp_ops

    shape = {"chain": (1502, 2007), "small": (16, 16), "left_only": (333, 250),
             "right_only": (250, 333), "tall": (1100, 40),
             "wide": (24, 1500)}[case]
    r = np.random.default_rng(84)
    h, w = shape
    left = r.integers(0, 256, (h, w, 3)).astype(np.float32)
    right = r.integers(0, 256, (h, w, 3)).astype(np.float32)
    xs = np.arange(w)[None, :].repeat(h, 0)
    w_l = np.where(xs < 0.7 * w, r.random((h, w)), 0.0).astype(np.float32)
    w_r = np.where(xs > 0.3 * w, r.random((h, w)), 0.0).astype(np.float32)
    if case == "left_only":
        w_r[:] = 0.0
    if case == "right_only":
        w_l[:] = 0.0
    args = [torch.from_numpy(x).cuda() for x in (left, right, w_l, w_r)]
    cuda_blend.reduce_launches = cuda_blend.collapse_launches = 0
    got = warp_ops._multiband_compose(*args)
    assert (cuda_blend.reduce_launches, cuda_blend.collapse_launches) \
        == (4, 5)
    monkeypatch.setattr(cuda_blend, "laplacian_blend", blend.laplacian_blend)
    want = warp_ops._multiband_compose(*args)
    assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["chain", "auto", "pair"])
def test_multiband_modes_on_the_card_equal_the_plain_route(mode,
                                                           monkeypatch):
    """Chain and auto multiband (blend_window_outputs in the global
    composite) and the fused multiband pair (PairStitcher._window_context)
    on the card: byte-equal to the same run with the pyramid on
    ops/blend.py's plain route, 9 pyramid launches a window."""
    import contextlib
    import dataclasses
    import io

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher, stitch_all_images
    from pano_tpu_torch.ops import blend, cuda_blend

    cfg = DEFAULT_CONFIG.replace(stitch=dataclasses.replace(
        DEFAULT_CONFIG.stitch, blend="multiband"))
    imgs = _strip_images(85)

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            if mode == "pair":
                out = PairStitcher(cfg, print_timing=False, device="cuda") \
                    .stitch_pair_fast(imgs[0], imgs[1])
                return out.cpu().numpy()
            return stitch_all_images(imgs, cfg, mode=mode, device="cuda")

    cuda_blend.reduce_launches = cuda_blend.collapse_launches = 0
    got = run()
    windows = 1 if mode == "pair" else len(imgs) - 1
    assert (cuda_blend.reduce_launches, cuda_blend.collapse_launches) \
        == (4 * windows, 5 * windows)
    monkeypatch.setattr(cuda_blend, "laplacian_blend", blend.laplacian_blend)
    want = run()
    assert isinstance(got, np.ndarray) and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)


# --- chip_smoke.py's phase 5 on the planted scene at full size -------------


@pytest.mark.parametrize("blend,gain", [("overlay", False),
                                        ("feather", False),
                                        ("multiband", False),
                                        ("feather", True)],
                         ids=["overlay", "feather", "multiband",
                              "feather_gain"])
def test_planted_pair_on_the_card(planted, blend, gain):
    """chip_smoke.pair_on_card with each blend: stitch_pair_fast on the
    planted pair, the graphed estimate; each kernel's launches (overlay
    K4a, the others K4b + K5, multiband's pyramid 4 + 5), H within 0.5 px
    at the corners, the planted canvas, the overlap the left image within
    1 (multiband 2, also on the planted H itself), overlay's repeat."""
    planted.s.pair_on_card(planted.pair, blend, gain)


def test_planted_staged_pair_on_the_card(planted, capsys):
    """stitch_pair with print_timing on the planted pair: the stage lines
    in the reference's format (a detection line an image), and the
    panorama within a row, a column and 1 of the fused one."""
    import re

    from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher

    left, right = planted.pair
    fused = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                         device="cuda").stitch_pair_fast(left, right)
    capsys.readouterr()
    staged = PairStitcher(DEFAULT_CONFIG, print_timing=True,
                          device="cuda").stitch_pair(left, right)
    torch.cuda.synchronize()
    lines = capsys.readouterr().out.splitlines()
    assert [re.fullmatch(r"(.+): \d+\.\d{3} ms", x).group(1)
            for x in lines] == list(_STAGE_LABELS), lines
    assert staged.is_cuda
    assert all(abs(a - b) <= 1 for a, b in zip(staged.shape, fused.shape))
    h, w = (min(a, b) for a, b in zip(staged.shape[:2], fused.shape[:2]))
    assert int((staged[:h, :w].int() - fused[:h, :w].int()).abs().max()) <= 1


@pytest.mark.parametrize("case", ["chain_overlay", "chain_feather",
                                  "chain_multiband", "chain_feather_gain",
                                  "auto", "fold_total"])
def test_planted_strip_on_the_card(planted, case):
    """chip_smoke.strip_on_card: stitch_all_images on the planted strip,
    chain with each blend, auto on the strip shuffled, fold with
    timing="total": its printed lines, each kernel's launches, the planted
    canvas, each global within 0.5 px of the planted one, the panorama
    against the scene within 2 (multiband 3); the overlay chain's repeat."""
    planted.s.strip_on_card(planted.strip, planted.strip_dev, case)


@pytest.mark.parametrize("blend,bar", [("overlay", 0), ("feather", 1),
                                       ("multiband", 2)])
def test_planted_globals_composite_on_the_card(planted, blend, bar):
    """composite_global on the strip's planted globals themselves (no
    estimate error): the scene's canvas, and the scene over the covered
    pixels, overlay exactly, feather within 1, multiband within 2."""
    from pano_tpu_torch import pipeline

    s = planted.s
    gs = [s.translation(x, y) for x, y in s.STRIP]
    pano = pipeline.composite_global(planted.strip, planted.strip_dev, gs,
                                     s.blend_config(blend))
    assert pano.shape[:2] == s.strip_shape()
    assert s.scene_err(pano, planted.strip, s.STRIP, 0, (0, 0),
                       s.strip_shape()).max() <= bar
