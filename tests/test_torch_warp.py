"""pano_tpu_torch warps and blends vs the JAX package on the CPU: the
fused warp + overlay (K4a's plain version) and the windowed warp (K4b's
plain version) against the exact XLA warp and the Pallas kernels in
interpret mode, warp_and_blend with every blend and gain and
blend_window_outputs with every blend against their XLA counterparts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pano_tpu.ops import pallas_warp as PW  # noqa: E402
from pano_tpu.ops import warp as JW  # noqa: E402
from pano_tpu_torch.ops import cuda_warp  # noqa: E402
from pano_tpu_torch.ops import warp as TW  # noqa: E402

TRANSLATION = np.array([[1.0, 0.0, 17.5], [0.0, 1.0, 6.25], [0.0, 0.0, 1.0]])
PROJECTIVE = np.array(  # tests/test_pallas_warp.py:55-57
    [[0.97, 0.02, 12.0], [-0.015, 1.02, 4.0], [2e-5, -1e-5, 1.0]]
)


@pytest.fixture(scope="module")
def images():
    r = np.random.default_rng(41)
    right = r.integers(0, 256, (200, 300, 3)).astype(np.uint8)
    left = r.integers(0, 256, (180, 220, 3)).astype(np.uint8)
    return left, right


def _port(left, right, m_inv, ty, tx, window, out_h, out_w):
    return cuda_warp.warp_compose_overlay(
        torch.from_numpy(right), m_inv, torch.from_numpy(left), ty, tx,
        window, out_h, out_w,
    ).numpy()


@pytest.mark.parametrize("m", [TRANSLATION, PROJECTIVE],
                         ids=["translation", "projective"])
def test_matches_xla_warp_and_blend(images, m):
    """Exact bilinear on both sides: max |d| <= 1, d != 0 on < 0.1% of
    the window's pixels (round at .5 under another contraction)."""
    left, right = images
    out_h, out_w = 260, 420
    ty, tx = 30, 190
    m_inv = np.linalg.inv(m)
    wy0, wx0, wy1, wx1 = 3, 5, 240, 400
    want = np.asarray(
        JW.warp_and_blend(
            jnp.asarray(left), jnp.asarray(right),
            jnp.asarray(m_inv, jnp.float32),
            jnp.asarray(tx, jnp.int32), jnp.asarray(ty, jnp.int32),
            out_h, out_w, "overlay",
            win_x=jnp.asarray(wx0, jnp.int32),
            win_y=jnp.asarray(wy0, jnp.int32),
            win_h=wy1 - wy0, win_w=wx1 - wx0,
        )
    )
    got = _port(left, right, m_inv, ty, tx, (wy0, wx0, wy1, wx1),
                out_h, out_w)
    assert got.shape == want.shape == (out_h, out_w, 3)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1, d.max()
    assert (d != 0).sum() < 1e-3 * (wy1 - wy0) * (wx1 - wx0), (d != 0).sum()
    # Outside the window the canvas is the placed left image, exactly.
    np.testing.assert_array_equal(got[:, :wx0], want[:, :wx0])
    np.testing.assert_array_equal(
        got[ty:ty + left.shape[0], wx1:tx + left.shape[1]],
        left[:, wx1 - tx:],
    )


@pytest.mark.parametrize(
    "m,bound", [(TRANSLATION, "translation"), (PROJECTIVE, "projective")],
    ids=["translation", "projective"],
)
def test_matches_pallas_kernel_in_interpret_mode(images, m, bound):
    """The Pallas kernel's own bounds (tests/test_pallas_warp.py:38-68):
    <= 2 on translations; > 3 on < 1% of pixels for projective maps."""
    left, right = images
    pad_h, pad_w = 256, 512
    ty, tx = 0, 256           # the kernel's (128, 256) tile grid
    m_inv = np.linalg.inv(m)
    assert PW.supports_homography(m_inv, pad_h, pad_w)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            PW.warp_compose_overlay(
                PW.pack_bgra(jnp.asarray(right)),
                PW.make_params(m_inv, 0, 0, right.shape[0], right.shape[1]),
                jnp.asarray(left), jnp.asarray(ty, jnp.int32),
                jnp.asarray(tx, jnp.int32), jnp.asarray(0, jnp.int32),
                jnp.asarray(0, jnp.int32), pad_h, pad_w, pad_h, pad_w,
            )
        )
    got = _port(left, right, m_inv, ty, tx, (0, 0, pad_h, pad_w),
                pad_h, pad_w)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    if bound == "translation":
        assert d.max() <= 2, d.max()
    else:
        assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


def test_plain_wrapper_and_warp_and_blend_agree(images):
    left, right = images
    m_inv = np.linalg.inv(PROJECTIVE)
    args = (torch.from_numpy(right), m_inv, torch.from_numpy(left), 10, 20,
            (0, 0, 150, 200), 160, 240)
    np.testing.assert_array_equal(
        cuda_warp.warp_compose_overlay(*args).numpy(),
        cuda_warp.warp_compose_overlay_plain(*args).numpy(),
    )


def test_canvas_geometry_matches_jax():
    h = np.array([[0.98, 0.01, 310.5], [-0.02, 1.01, -22.25],
                  [1e-5, 2e-5, 1.0]])
    want = JW.compute_canvas_geometry(h, (300, 400), (310, 420))
    got = TW.compute_canvas_geometry(h, (300, 400), (310, 420))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_wrapper_checks():
    img = torch.zeros((8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        cuda_warp.warp_compose_overlay(img, np.eye(3), img, 0, 0,
                                       (0, 0, 9, 8), 8, 8)
    meta = torch.empty((8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_warp.warp_compose_overlay(meta, np.eye(3), meta, 0, 0,
                                       (0, 0, 8, 8), 8, 8)
    with pytest.raises(ValueError, match="unknown blend"):
        TW.warp_and_blend(img, img, np.eye(3), 0, 0, 8, 8, "nope")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_warp.warp_packed(meta, np.eye(3), (0, 0, 8, 8))


# --- K4b: the windowed warp (warp_packed) ----------------------------------


def _port_packed(img, m_inv, window, **kw):
    rgb, w = cuda_warp.warp_packed(torch.from_numpy(img), m_inv, window, **kw)
    return rgb.numpy(), None if w is None else w.numpy()


@pytest.mark.parametrize("shift", [(17.0, 6.0), (17.5, 6.25), (-3.5, 0.0)])
def test_warp_packed_rgb_matches_warp_perspective_u8(images, shift):
    """Translations: the window's RGB equals JAX warp_perspective_u8
    exactly (and so does the port's own warp_perspective_u8)."""
    _, right = images
    m = np.eye(3)
    m[0, 2], m[1, 2] = shift
    m_inv = np.linalg.inv(m)
    want = np.asarray(JW.warp_perspective_u8(
        jnp.asarray(right), jnp.asarray(m_inv, jnp.float32), 230, 330))
    got, _ = _port_packed(right, m_inv, (0, 0, 230, 330))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TW.warp_perspective_u8(torch.from_numpy(right), m_inv, 230,
                               330).numpy(), want)


def test_warp_packed_window_offset_and_projective(images):
    """A window at an unaligned canvas origin samples the canvas pixels it
    covers: the same values as the full warp there; projective maps
    round within 1 of the XLA warp."""
    _, right = images
    m_inv = np.linalg.inv(PROJECTIVE)
    full = np.asarray(JW.warp_perspective_u8(
        jnp.asarray(right), jnp.asarray(m_inv, jnp.float32), 240, 340))
    got, _ = _port_packed(right, m_inv, (13, 29, 201, 317))
    d = np.abs(got.astype(int) - full[13:201, 29:317].astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3, (d.max(), (d != 0).mean())


def test_warp_packed_alpha_weight_matches_pallas(images):
    """has_alpha: the 7-bit ramp alpha, sampled; within 0.02 of the JAX
    kernel's weight (tests/test_pallas_warp.py:81-89)."""
    _, right = images
    hr, wr = right.shape[:2]
    packed = PW.pack_bgra(jnp.asarray(right), JW._edge_ramp(hr, wr))
    params = PW.make_params(np.eye(3), 0.0, 0.0, hr, wr)
    with pltpu.force_tpu_interpret_mode():
        _, want = PW.warp_packed(packed, params, 128, 256)
    _, got = _port_packed(right, np.eye(3), (0, 0, 128, 256))
    assert np.abs(got - np.asarray(want)).max() < 0.02
    ramp = np.asarray(JW._edge_ramp(hr, wr))[:128, :256]
    np.testing.assert_allclose(
        got, np.clip(np.round(ramp * 127), 1, 127) / 127, atol=1e-6)


@pytest.mark.parametrize("m", [TRANSLATION, PROJECTIVE],
                         ids=["translation", "projective"])
def test_warp_packed_weight_without_alpha(images, m):
    """No alpha: the summed in-bounds bilinear weight, within 1e-5 of the
    XLA sample's (tests/test_pallas_warp.py:132); emit_weight=False
    returns None and the same RGB."""
    _, right = images
    m_inv = np.linalg.inv(m)
    sx, sy = JW._inverse_map(jnp.asarray(m_inv, jnp.float32), 256, 512,
                             jnp.asarray(0.0), jnp.asarray(0.0))
    _, want = jax.jit(JW._bilinear_sample_u8)(jnp.asarray(right), sx, sy)
    rgb, got = _port_packed(right, m_inv, (0, 0, 256, 512), has_alpha=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    rgb2, none = _port_packed(right, m_inv, (0, 0, 256, 512),
                              emit_weight=False)
    assert none is None
    np.testing.assert_array_equal(rgb, rgb2)


def _alpha_plane(h, w):
    """warp_packed_plain's 7-bit ramp alpha plane."""
    return torch.clamp(torch.round(TW._edge_ramp(h, w) * 127.0), 1.0, 127.0)


def _edge_dist(k, n):
    """min(k + 1, n - k): the distance of row or column k to the edge."""
    return torch.minimum(k + 1, n - k)


# The shapes of these tests and of tests/test_torch_cuda.py, odd sides,
# the main path's 3117x4156 and its mip levels 1 and 2.
ALPHA_SHAPES = [(200, 300), (5, 9), (61, 91), (7, 7), (3117, 4156),
                (1558, 2078), (779, 1039)]


@pytest.mark.parametrize("shape", ALPHA_SHAPES,
                         ids=[f"{h}x{w}" for h, w in ALPHA_SHAPES])
def test_ramp_alpha_table_gives_the_alpha_plane(shape):
    """K4b's table: g over the edge distances does not decrease, so
    min(g(dx), g(dy)) is the alpha plane bit for bit, the g of the
    smaller distance."""
    h, w = shape
    table = cuda_warp.ramp_alpha_table(h, w)
    assert table.dtype == torch.float32
    assert table.shape == ((max(h, w) + 1) // 2 + 1,)
    assert bool((table[2:] >= table[1:-1]).all())
    dy = _edge_dist(torch.arange(h), h)
    dx = _edge_dist(torch.arange(w), w)
    got = torch.minimum(table[dy][:, None], table[dx][None, :])
    assert torch.equal(got, _alpha_plane(h, w))


def _table_alpha_weight(img, m_inv, window):
    """K4b's has_alpha weight as the kernel takes it: each in-bounds tap's
    alpha min(g(dx), g(dy)) from the table, times its bilinear weight,
    summed in tap order, rounded to 7 bits, divided by 127."""
    h, w = img.shape[:2]
    wy0, wx0, wy1, wx1 = window
    table = cuda_warp.ramp_alpha_table(h, w)
    sx, sy = TW._inverse_map(m_inv, wy1 - wy0, wx1 - wx0, wx0, wy0, "cpu")
    inb = (sx > -1.0) & (sx < float(w)) & (sy > -1.0) & (sy < float(h))
    sx = torch.where(inb, sx, 0.0)
    sy = torch.where(inb, sy, 0.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    asum = torch.zeros_like(sx)
    for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                        (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0.long() + dx, y0.long() + dy
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & inb
        gx = table[_edge_dist(xi, w).clamp(0, len(table) - 1)]
        gy = table[_edge_dist(yi, h).clamp(0, len(table) - 1)]
        asum = asum + torch.where(ok, torch.minimum(gx, gy) * wgt, 0.0)
    return TW.true_div(torch.round(asum), 127.0)


@pytest.mark.parametrize("shape,m,window", [
    ((200, 300), PROJECTIVE, (3, 5, 240, 401)),
    ((5, 9), TRANSLATION, (0, 0, 12, 30)),
    ((61, 91), np.diag([0.4, 0.45, 1.0]), (0, 0, 30, 45)),
], ids=["projective", "5x9", "minifying"])
def test_warp_packed_alpha_weight_from_table(shape, m, window):
    """The weight K4b computes from the table equals warp_packed_plain's
    sample of the alpha plane bit for bit, over interior taps and taps
    cut by the source's edges."""
    img = np.random.default_rng(47).integers(0, 256, shape + (3,), np.uint8)
    m_inv = np.linalg.inv(m)
    _, want = cuda_warp.warp_packed_plain(torch.from_numpy(img), m_inv,
                                          window)
    assert torch.equal(_table_alpha_weight(img, m_inv, window), want)
    assert bool((want > 0).any()) and bool((want < 1).any())


# --- warp_and_blend and blend_window_outputs, every blend -------------------

BLENDS = [("overlay", True), ("feather", False), ("feather", True),
          ("multiband", False), ("multiband", True)]


def _check_blend(got, want, blend, win_px):
    """f32 rounding moves a pixel by 1 at .5; in multiband it also flips
    the seam mask at exact ties of the two weights (XLA divides by a
    constant as a multiply by its reciprocal; the port divides), which
    takes the other image's pixel."""
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    if blend == "multiband":
        assert (d > 1).sum() < 5e-3 * win_px, (d > 1).sum()
        assert (d > 10).mean() < 0.02
    else:
        assert d.max() <= 1, d.max()
        assert (d != 0).sum() < 1e-3 * win_px, (d != 0).sum()


@pytest.mark.parametrize("blend,gain", BLENDS)
@pytest.mark.parametrize("m", [TRANSLATION, PROJECTIVE],
                         ids=["translation", "projective"])
def test_warp_and_blend_matches_xla(images, m, blend, gain):
    """The exact CPU counterpart of JAX warp_and_blend. The right image is
    brightened by 1.2 so that gain engages."""
    left, right = images
    right = np.clip(right.astype(np.int32) * 1.2, 0, 255).astype(np.uint8)
    out_h, out_w, ty, tx = 260, 420, 30, 190
    wy0, wx0, win_h, win_w = 3, 5, 224, 384   # 16-multiples for multiband
    m_inv = np.linalg.inv(m)
    s = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    want = np.asarray(JW.warp_and_blend(
        jnp.asarray(left), jnp.asarray(right),
        jnp.asarray(m_inv, jnp.float32), s(tx), s(ty), out_h, out_w, blend,
        win_x=s(wx0), win_y=s(wy0), win_h=win_h, win_w=win_w, gain=gain,
    ))
    got = TW.warp_and_blend(
        torch.from_numpy(left), torch.from_numpy(right), m_inv, tx, ty,
        out_h, out_w, blend, wx0, wy0, win_h, win_w, gain=gain,
    ).numpy()
    _check_blend(got, want, blend, win_h * win_w)


@pytest.mark.parametrize("blend", ["overlay", "feather", "multiband"])
def test_blend_window_outputs_matches_xla(images, blend):
    """The pair epilogue over a warped window (K5's plain version),
    unaligned placements, against JAX blend_window_outputs."""
    left, right = images
    m_inv = np.linalg.inv(PROJECTIVE)
    out_h, out_w, ty, tx = 270, 430, 21, 173
    window = (7, 9, 7 + 224, 9 + 400)
    rgb, w = cuda_warp.warp_packed(torch.from_numpy(right), m_inv, window)
    rgb_np, w_np = rgb.numpy().astype(np.int32), w.numpy()
    packed = rgb_np[..., 0] | (rgb_np[..., 1] << 8) | (rgb_np[..., 2] << 16)
    s = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    want, _ = JW.blend_window_outputs(
        jnp.asarray(left), jnp.asarray(packed), jnp.asarray(w_np), s(tx),
        s(ty), s(window[1]), s(window[0]), out_h, out_w, 224, 400, blend,
    )
    got, _ = TW.blend_window_outputs(
        torch.from_numpy(left), rgb, w, tx, ty, window[1], window[0], out_h,
        out_w, blend,
    )
    _check_blend(got.numpy(), np.asarray(want), blend, 224 * 400)


@pytest.mark.parametrize("args", [
    ((310, 420), (300, 1700)),
    ((310, 420), (384, 1900)),
    ((3117, 4156), (3200, 5632)),
    ((200, 300), (256, 1800)),
])
def test_warp_window_geometry_matches_jax(args):
    """The port's exact window (warp_window of the warped corners) is JAX
    warp_window_geometry without bucketing or alignment, whether the
    window is clipped by the canvas or not."""
    (img_h, img_w), (pad_h, pad_w) = args
    for m in (np.array([[0.98, 0.01, 310.5], [-0.02, 1.01, 22.25],
                        [1e-5, 2e-5, 1.0]]),
              np.array([[1.0, 0.0, 1400.0], [0.0, 1.0, 37.0],
                        [0.0, 0.0, 1.0]])):
        wx0, wy0, win_w, win_h = JW.warp_window_geometry(
            m, img_h, img_w, pad_h, pad_w, 1, 1)
        got = TW.warp_window(TW.warp_corners(m, img_h, img_w), pad_h, pad_w)
        assert got == (wy0, wx0, wy0 + win_h, wx0 + win_w)
