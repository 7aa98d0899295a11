"""pano_tpu_torch.parallel.shard vs pano_tpu.parallel.shard on the CPU:
the keyed RANSAC tables, the batched estimates, the hypothesis-sharded
step, the row-sharded matcher, the batched K1 and K4b entries' plain
versions and the batched composites. The port runs on meshes of virtual
CPU devices (one torch.device repeated), JAX on its own 8 CPU devices
(tests/conftest.py), at tests/test_sharding.py's sizes: K = 512, 512
hypotheses, 96x128 images. Each JAX result is computed once per module.
"Corners" means a homography applied to the image's four corners."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano_tpu.config import (  # noqa: E402
    HarrisOptions, PanoConfig, RansacOptions,
)
from pano_tpu.ops import warp as JW  # noqa: E402
from pano_tpu.parallel import shard as JS  # noqa: E402
from pano_tpu_torch import config as TC  # noqa: E402
from pano_tpu_torch import pipeline as TP  # noqa: E402
from pano_tpu_torch.ops import cuda_harris, cuda_warp  # noqa: E402
from pano_tpu_torch.ops import match as TM  # noqa: E402
from pano_tpu_torch.ops import ransac as TR  # noqa: E402
from pano_tpu_torch.parallel import shard as TS  # noqa: E402

SMALL = PanoConfig(
    harris=HarrisOptions(max_keypoints=512),
    ransac=RansacOptions(num_iterations=512),
)
PORT = TC.config_from_reference(SMALL)
CPU = torch.device("cpu")

BLENDS = [("overlay", False), ("feather", False), ("multiband", False),
          ("overlay", True), ("feather", True), ("multiband", True)]
BLEND_IDS = ["overlay", "feather", "multiband", "overlay+gain",
             "feather+gain", "multiband+gain"]


def cpu_mesh(n_data, n_hyp=1):
    return TS.make_mesh(n_data, n_hyp, devices=[CPU] * (n_data * n_hyp))


def port_config(blend="overlay", gain=False):
    return PORT.replace(stitch=dataclasses.replace(
        PORT.stitch, blend=blend, gain_compensation=gain))


def checkerboard_texture(h, w, seed=0):
    """tests/test_sharding.py's texture."""
    r = np.random.default_rng(seed)
    img = np.full((h, w, 3), 30, np.uint8)
    for _ in range(60):
        y, x = r.integers(5, h - 12), r.integers(5, w - 12)
        img[y:y + 8, x:x + 8] = r.integers(60, 255, 3)
    return img


def make_pair_batch(b, h=96, w=128, shift=32):
    """tests/test_sharding.py's batch of x-translated pairs, as numpy."""
    lefts, rights = [], []
    for i in range(b):
        base = checkerboard_texture(h, w + shift, seed=i)
        lefts.append(base[:, shift:])
        rights.append(base[:, :w])
    return np.stack(lefts), np.stack(rights)


def corners(hs, h=96, w=128):
    return np.stack([JW.warp_corners(np.asarray(m, np.float64), h, w)
                     for m in hs])


# --- the keyed RANSAC tables -----------------------------------------------


@pytest.mark.parametrize("seed", [42, 0, -7])
@pytest.mark.parametrize("data", [0, 1, 3, 7])
def test_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), data)))
    assert TR.fold_in(TR.prng_key(seed), data) == tuple(int(v) for v in want)


@pytest.mark.parametrize("hyp,n_hyp", [(0, 2), (1, 2), (3, 4), (7, 8)])
@pytest.mark.parametrize("n_valid", [0, 1, 97, 512])
def test_key_sampler_matches_jax_randint(hyp, n_hyp, n_valid):
    """A hyp shard's table: randint(fold_in(PRNGKey(seed), hyp),
    (512 / n_hyp, 4), 0, max(n_valid, 1)), bit for bit."""
    iters = 512 // n_hyp
    key = jax.random.fold_in(jax.random.PRNGKey(0), hyp)
    want = np.asarray(jax.random.randint(key, (iters, 4), 0,
                                         max(n_valid, 1)))
    sample = TR.key_sampler(TR.fold_in(TR.prng_key(0), hyp), iters, 4, CPU)
    got = sample(torch.tensor(n_valid, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the mesh ---------------------------------------------------------------


def test_make_mesh():
    m = cpu_mesh(4, 2)
    assert m.shape == {"data": 4, "hyp": 2} and m.size == 8
    assert m.axis_names == ("data", "hyp") and m.device(3, 1) == CPU
    devs = [torch.device("cpu", i) for i in range(8)]
    m = TS.make_mesh(n_hyp=2, devices=devs)
    assert m.shape == {"data": 4, "hyp": 2}
    assert m.device(1, 0) == devs[2] and m.device(1, 1) == devs[3]
    assert TS.make_mesh(2, 1, devices=devs).devices == ((devs[0],),
                                                         (devs[1],))
    with pytest.raises(ValueError, match="needs 8 devices"):
        TS.make_mesh(4, 2, devices=devs[:5])


def test_make_mesh_without_a_card_raises():
    """No CUDA device and no devices= given: an error, never a CPU
    mesh."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.stitch_all_images_sharded([np.zeros((8, 8, 3), np.uint8)] * 2,
                                     PORT, mode="fold")


def test_entry_points_without_a_mesh_want_a_card():
    """With no mesh, CPU tensors too go to a mesh of the first card:
    without one each entry point raises; the CPU runs only on a mesh of
    CPU devices."""
    assert not torch.cuda.is_available()
    img = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    calls = [
        lambda: TS.fused_estimate_batched(img, img, PORT),
        lambda: TS.estimate_homographies_batched(img, img, PORT),
        lambda: TS.stitch_pairs_batched(img, img, PORT),
        lambda: TS.composite_pairs_batched(img, img, np.eye(3)[None],
                                           np.ones(1, bool), PORT),
        lambda: TS.warp_windows_batched([img[0]], [np.eye(3)],
                                        [(0, 0, 4, 4)]),
        lambda: TS.composite_global_sharded([img[0].numpy()] * 2,
                                            [img[0]] * 2,
                                            [np.eye(3)] * 2, PORT),
    ]
    for mode in ("chain", "auto", "fold"):
        calls.append(lambda mode=mode: TS.stitch_all_images_sharded(
            [img[0].numpy()] * 3, PORT, mode=mode))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("n,n_data,want", [
    (3, 1, [[0, 1, 2]]), (3, 2, [[0, 1], [2, 2]]), (3, 3, [[0], [1], [2]]),
    (5, 4, [[0, 1], [2, 3], [4, 4], [4, 4]]), (0, 2, [[], []])])
def test_data_shards_pad_with_the_last_row(n, n_data, want):
    assert [rows for _, rows in TS._data_shards(cpu_mesh(n_data), n)] == want


# --- batched estimates ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_estimates():
    """JAX's fused_estimate_batched, estimate_homographies_batched (8
    pairs, data 8) and batched_stitch_step (4 pairs, data 4 x hyp 2)."""
    lefts, rights = make_pair_batch(8)
    mesh = JS.make_mesh(n_data=8, n_hyp=1)
    packed, _ = JS.fused_estimate_batched(jnp.asarray(lefts),
                                          jnp.asarray(rights), SMALL, mesh)
    hs, counts, ok = JS.estimate_homographies_batched(
        jnp.asarray(lefts), jnp.asarray(rights), SMALL, mesh)
    step_h, step_c = JS.batched_stitch_step(
        JS.make_mesh(n_data=4, n_hyp=2), jnp.asarray(lefts[:4]),
        jnp.asarray(rights[:4]), SMALL)
    return dict(lefts=lefts, rights=rights, packed=np.asarray(packed),
                hs=np.asarray(hs), counts=np.asarray(counts),
                ok=np.asarray(ok), step_h=np.asarray(step_h),
                step_c=np.asarray(step_c))


@pytest.mark.parametrize("n_data", [8, 3])
def test_fused_estimate_batched_matches_jax(jax_estimates, n_data):
    """The same ok flags, inlier, num_matches and match counts, the
    corners within 0.1 px (test_default_sampler_estimate_matches_jax's
    tolerance); 3 shards pad 8 pairs to 9."""
    want = jax_estimates["packed"]
    packed, (pq, pt, v) = TS.fused_estimate_batched(
        torch.from_numpy(jax_estimates["lefts"]),
        torch.from_numpy(jax_estimates["rights"]), PORT, cpu_mesh(n_data))
    got = packed.numpy()
    assert got.shape == (8, 14) and pq.shape == (8, 512, 2)
    assert v.shape == (8, 512)
    np.testing.assert_array_equal(got[:, 9:], want[:, 9:])
    assert (got[:, 11] > 0.5).all()
    err = np.abs(corners(got[:, :9].reshape(-1, 3, 3))
                 - corners(want[:, :9].reshape(-1, 3, 3))).max()
    assert err < 0.1, err
    np.testing.assert_array_equal(v.sum(1).numpy(), got[:, 12])


def test_fused_estimate_rows_equal_the_pair_stitchers(jax_estimates):
    """Each batched row is PairStitcher._fused_estimate_impl's, bit for
    bit (the one detection per pair becomes one K1 launch per shard)."""
    lefts = torch.from_numpy(jax_estimates["lefts"][:3])
    rights = torch.from_numpy(jax_estimates["rights"][:3])
    packed, _ = TS.fused_estimate_batched(lefts, rights, PORT, cpu_mesh(1))
    st = TP.PairStitcher(PORT, print_timing=False, device="cpu")
    for k in range(3):
        assert torch.equal(packed[k],
                           st._fused_estimate_impl(lefts[k], rights[k])[0])


def test_estimate_homographies_batched_matches_jax(jax_estimates):
    """The first four pairs (host numpy in) on a 2x1 mesh against JAX's
    rows of its 8-pair batch."""
    hs, counts, ok = TS.estimate_homographies_batched(
        jax_estimates["lefts"][:4], jax_estimates["rights"][:4], PORT,
        cpu_mesh(2))
    assert hs.shape == (4, 3, 3) and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(),
                                  jax_estimates["counts"][:4])
    np.testing.assert_array_equal(ok.numpy(), jax_estimates["ok"][:4])
    err = np.abs(corners(hs.numpy())
                 - corners(jax_estimates["hs"][:4])).max()
    assert err < 0.1, err
    np.testing.assert_allclose(hs[:, 0, 2].numpy(), -32.0, atol=1.0)


def test_batched_stitch_step_matches_jax(jax_estimates):
    """4 pairs on a 4x2 mesh: each pair's hypotheses drawn by two hyp
    shards from JAX's fold_in keys; the same inlier counts, the corners
    within 0.1 px."""
    hs, counts = TS.batched_stitch_step(
        cpu_mesh(4, 2), jax_estimates["lefts"][:4],
        jax_estimates["rights"][:4], PORT)
    assert hs.shape == (4, 3, 3) and counts.shape == (4,)
    np.testing.assert_array_equal(counts.numpy(), jax_estimates["step_c"])
    assert (counts.numpy() > 10).all()
    err = np.abs(corners(hs.numpy()) - corners(jax_estimates["step_h"])).max()
    assert err < 0.1, err


def test_batched_stitch_step_raises_like_jax():
    lefts, rights = make_pair_batch(3)
    with pytest.raises(ValueError, match="batch 3 not divisible by data "
                                         "axis 2"):
        TS.batched_stitch_step(cpu_mesh(2), lefts, rights, PORT)
    odd = PORT.replace(ransac=dataclasses.replace(PORT.ransac,
                                                  num_iterations=511))
    with pytest.raises(ValueError, match="num_iterations not divisible"):
        TS.batched_stitch_step(cpu_mesh(1, 2), lefts[:1], rights[:1], odd)


def test_sharded_search_finds_the_local_model():
    """tests/test_sharding.py's hypothesis-sharding check on 8 hyp
    shards: the same H as JAX's sharded search (corners within 0.1 px)
    and as many inliers."""
    r = np.random.default_rng(0)
    src = r.uniform(0, 500, (256, 2))
    dst = src + np.array([20.0, -7.0])
    dst[:64] += r.uniform(30, 100, (64, 2))
    pq = np.zeros((512, 2), np.float32)
    pt = np.zeros((512, 2), np.float32)
    pq[:256], pt[:256] = src, dst
    valid = np.zeros(512, bool)
    valid[:256] = True
    jst = JS._ShardedPairStitcher(JS.make_mesh(n_data=1, n_hyp=8),
                                  PanoConfig(ransac=SMALL.ransac))
    want = jst._sharded_search(jnp.asarray(pq), jnp.asarray(pt),
                               jnp.asarray(valid))
    tst = TS._ShardedPairStitcher(cpu_mesh(1, 8),
                                  TC.PanoConfig(ransac=PORT.ransac))
    got = tst._sharded_search(torch.from_numpy(pq), torch.from_numpy(pt),
                              torch.from_numpy(valid))
    assert bool(got.ok) and int(got.inlier_count) == int(want.inlier_count)
    err = np.abs(JW.warp_corners(got.H.numpy().astype(np.float64), 500, 500)
                 - JW.warp_corners(np.asarray(want.H, np.float64), 500,
                                   500)).max()
    assert err < 0.1, err


def test_sharded_stitcher_rounds_iterations_up():
    st = TS._ShardedPairStitcher(cpu_mesh(1, 3), PORT)
    assert st._r_opts.num_iterations == 513


# --- sharded matching -------------------------------------------------------


@pytest.mark.parametrize("ratio", [0.0, 0.8])
def test_match_descriptors_sharded_equals_local(ratio):
    r = np.random.default_rng(1234)
    kq, kt, d = 64, 48, 128
    args = (torch.from_numpy(r.integers(0, 255, (kq, d)).astype(np.float32)),
            torch.from_numpy(r.random(kq) > 0.2),
            torch.from_numpy(r.integers(0, 255, (kt, d)).astype(np.float32)),
            torch.from_numpy(r.random(kt) > 0.2))
    local = TM.match_descriptors(*args, 1e18, ratio_thresh=ratio)
    sharded = TS.match_descriptors_sharded(*args, 1e18, cpu_mesh(8),
                                           ratio_thresh=ratio)
    for a, b in zip(local, sharded):
        assert torch.equal(a, b)
    hyp = TS.match_descriptors_sharded(*args, 1e18, cpu_mesh(1, 4),
                                       axis="hyp", ratio_thresh=ratio)
    assert all(torch.equal(a, b) for a, b in zip(local, hyp))


def test_match_descriptors_sharded_errors_match_jax():
    z = np.zeros((6, 128), np.float32)
    v = np.ones(6, bool)
    for kw, n in (({"cross_check": True}, 2), ({}, 4)):
        with pytest.raises(ValueError) as je:
            JS.match_descriptors_sharded(jnp.asarray(z), jnp.asarray(v),
                                         jnp.asarray(z), jnp.asarray(v), 1.0,
                                         JS.make_mesh(n_data=n, n_hyp=1),
                                         **kw)
        with pytest.raises(ValueError) as te:
            TS.match_descriptors_sharded(torch.from_numpy(z),
                                         torch.from_numpy(v),
                                         torch.from_numpy(z),
                                         torch.from_numpy(v), 1.0,
                                         cpu_mesh(n), **kw)
        assert str(te.value) == str(je.value)


# --- the batched kernels' plain versions -------------------------------------


@pytest.mark.parametrize("nms", [3, 5, 11])
def test_harris_scores_batched_plain_is_the_loop(nms):
    imgs = torch.from_numpy(np.stack([
        np.random.default_rng(s).integers(0, 256, (37, 53, 3), np.uint8)
        for s in range(3)]))
    got = cuda_harris.harris_scores_batched(imgs, 0.04, 1e5, nms)
    assert got.shape == (3, 19, 27)
    for i in range(3):
        assert torch.equal(got[i], cuda_harris.harris_scores_plain(
            imgs[i], 0.04, 1e5, nms))
    assert cuda_harris.harris_scores_batched(imgs[:0], 0.04, 1e5).shape == \
        (0, 19, 27)
    with pytest.raises(ValueError, match=r"want \(B, H, W, 3\)"):
        cuda_harris.harris_scores_batched(imgs[0], 0.04, 1e5)


def test_harris_detect_batched_is_the_loop():
    from pano_tpu_torch.ops import harris as TH

    lefts, rights = make_pair_batch(3)
    imgs = torch.from_numpy(np.concatenate([lefts, rights]))
    for got, img in zip(TH.harris_detect_batched(imgs, PORT.harris), imgs):
        want = TH.harris_detect(img, PORT.harris)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _shift(x, y):
    return np.array([[1.0, 0.0, x], [0.0, 1.0, y], [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("has_alpha,emit_weight",
                         [(True, True), (False, True), (True, False)])
def test_warp_packed_batched_plain_is_the_loop(has_alpha, emit_weight):
    """Mixed windows (an empty one among them) of three sources of one
    shape: each element is warp_packed of its own; the wrapper checks
    its arguments."""
    srcs = [torch.from_numpy(np.random.default_rng(s).integers(
        0, 256, (40, 60, 3), np.uint8)) for s in range(3)]
    maps = [np.linalg.inv(_shift(3.5, 2.25)), np.linalg.inv(_shift(10, 0)),
            np.linalg.inv(np.diag([0.5, 0.5, 1.0]))]
    windows = [(0, 0, 45, 66), (3, 9, 3, 40), (1, 2, 21, 31)]
    got = cuda_warp.warp_packed_batched(srcs, maps, windows, has_alpha,
                                        emit_weight)
    for (rgb, w), s, m, win in zip(got, srcs, maps, windows):
        rgb1, w1 = cuda_warp.warp_packed(s, m, win, has_alpha, emit_weight)
        assert torch.equal(rgb, rgb1)
        assert (w is None and w1 is None) or torch.equal(w, w1)
    with pytest.raises(ValueError, match="different shapes"):
        cuda_warp.warp_packed_batched([srcs[0], srcs[1][:30]], maps[:2],
                                      windows[:2])
    with pytest.raises(ValueError, match="as many sources"):
        cuda_warp.warp_packed_batched(srcs, maps[:2], windows)
    with pytest.raises(ValueError, match="bad window"):
        cuda_warp.warp_packed_batched(srcs[:1], maps[:1], [(5, 0, 4, 9)])


def test_warp_elem_table_layout():
    """The element table row is csrc/warp.cu's 80-byte WarpElem."""
    row = cuda_warp._ELEM.pack(1, 2, 3, *range(4, 13), 13, 14, 15, 16, 17)
    assert len(row) == 80
    # src, rgb_off, w_off at 0, 8, 16; m at 24..60; wy0, wx0, win_h,
    # win_w, block_start at 60, 64, 68, 72, 76.
    assert np.frombuffer(row, "<i8", 3).tolist() == [1, 2, 3]
    assert np.frombuffer(row, "<f4", 9, 24).tolist() == list(range(4, 13))
    assert np.frombuffer(row, "<i4", 5, 60).tolist() == [13, 14, 15, 16, 17]


def test_warp_windows_batched_over_the_mesh():
    srcs = [torch.from_numpy(checkerboard_texture(96, 128, s))
            for s in range(5)]
    maps = [np.linalg.inv(_shift(4.5 * k, 1.5 * k)) for k in range(5)]
    windows = [(k, 4 * k, 97 + k, 133 + 4 * k) for k in range(5)]
    got = TS.warp_windows_batched(srcs, maps, windows, cpu_mesh(2))
    for (rgb, w), s, m, win in zip(got, srcs, maps, windows):
        rgb1, w1 = cuda_warp.warp_packed(s, m, win)
        assert torch.equal(rgb, rgb1) and torch.equal(w, w1)


# --- batched composites -----------------------------------------------------


@pytest.mark.parametrize("blend,gain", BLENDS, ids=BLEND_IDS)
def test_composite_pairs_batched_equals_pair_composite(blend, gain):
    """tests/test_sharding.py:164-182 in the port: every canvas equal to
    PairStitcher.composite of its pair, for every blend and gain; one
    pair skewed so that the batch splits into two size groups; a pair
    whose ok is off gives None."""
    cfg = port_config(blend, gain)
    lefts, rights = make_pair_batch(4)
    hs = np.stack([_shift(-32.0 + 0.25 * k, 0.5 * k) for k in range(4)])
    hs[0] = hs[0] @ np.diag([1.1, 1.1, 1.0])
    ok = np.array([True, True, False, True])
    got = TS.composite_pairs_batched(lefts, rights, hs, ok, cfg,
                                     cpu_mesh(2))
    st = TP.PairStitcher(cfg, print_timing=False, device="cpu")
    assert got[2] is None
    assert got[0].shape != got[1].shape
    for b in (0, 1, 3):
        want = st.composite(lefts[b], rights[b], hs[b]).numpy()
        np.testing.assert_array_equal(got[b], want)


def test_stitch_pairs_batched_throughput_mode():
    """4 pairs on a 4-shard mesh: every panorama the pair composite of
    its own estimate (tests/test_sharding.py:133-140)."""
    lefts, rights = make_pair_batch(4)
    panos = TS.stitch_pairs_batched(lefts, rights, PORT, cpu_mesh(4))
    st = TP.PairStitcher(PORT, print_timing=False, device="cpu")
    for b, p in enumerate(panos):
        assert p is not None and p.shape[1] >= 150
        row = st._fused_estimate_impl(torch.from_numpy(lefts[b]),
                                      torch.from_numpy(rights[b]))[0]
        h = row[:9].numpy().astype(np.float64).reshape(3, 3)
        np.testing.assert_array_equal(
            p, st.composite(lefts[b], rights[b], h).numpy())


def _chain_globals(n_imgs, step):
    gs = [np.eye(3)]
    for i in range(1, n_imgs):
        h = np.eye(3)
        h[0, 2] = i * step
        gs.append(h)
    return gs


@pytest.mark.parametrize("blend,gain", BLENDS, ids=BLEND_IDS)
def test_composite_global_sharded_equals_composite_global(blend, gain):
    """tests/test_sharding.py:279-304 in the port: five images (one of
    them projective), a 4-shard mesh; the panorama and the weight canvas
    equal to composite_global's."""
    base = checkerboard_texture(96, 384, seed=21)
    imgs = [base[:, i * 64:i * 64 + 128].copy() for i in range(5)]
    gs = _chain_globals(5, 64)
    gs[3] = gs[3] @ np.array([[1.01, 0.005, 0.3], [-0.004, 0.99, 1.7],
                              [1e-5, -2e-5, 1.0]])
    devs = [torch.from_numpy(im) for im in imgs]
    cfg = port_config(blend, gain)
    w_sh, w_lo = [], []
    got = TS.composite_global_sharded(imgs, devs, gs, cfg, mesh=cpu_mesh(4),
                                      _weights_out=w_sh)
    want = TP.composite_global(imgs, devs, gs, cfg, _weights_out=w_lo)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(w_sh[0], w_lo[0])


def test_composite_global_sharded_overlay_matches_jax():
    """Overlay reads no weight: JAX's composite_global_sharded on its
    4-device mesh is the oracle, exact on integer translations (the
    tolerance tests/test_torch_multi.py holds composite_global to)."""
    base = checkerboard_texture(96, 384, seed=21)
    imgs = [base[:, i * 64:i * 64 + 128].copy() for i in range(5)]
    gs = _chain_globals(5, 64)
    want = JS.composite_global_sharded(
        imgs, [jnp.asarray(im) for im in imgs], gs, SMALL,
        mesh=JS.make_mesh(n_data=4, n_hyp=1))
    got = TS.composite_global_sharded(imgs, [torch.from_numpy(im)
                                             for im in imgs], gs, PORT,
                                      mesh=cpu_mesh(4))
    np.testing.assert_array_equal(got, want)


def test_composite_global_sharded_mixed_shapes_fall_back(monkeypatch):
    imgs = [checkerboard_texture(96, 128, 1), checkerboard_texture(96, 128, 2),
            checkerboard_texture(90, 120, 3)]
    gs = _chain_globals(3, 64)
    calls = []
    real = TP.composite_global
    monkeypatch.setattr(TP, "composite_global",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    devs = [torch.from_numpy(im) for im in imgs]
    got = TS.composite_global_sharded(imgs, devs, gs, PORT, cpu_mesh(2))
    assert calls == [1]
    np.testing.assert_array_equal(got, real(imgs, devs, gs, PORT))
