"""The sharded multi-image modes of pano_tpu_torch.parallel.shard (chain,
auto, the hypothesis-sharded fold) vs pano_tpu.parallel.shard's on the
CPU, mirroring tests/test_sharding.py:133-276: the same placements (each
recovered global's corners within 0.1 px of JAX's), the panorama within
tests/test_torch_multi.py's bar, the skip of a failed image, the mode
dispatch and the one host fetch; and each port mode against its
one-device counterpart in pipeline, byte for byte. The port runs on
meshes of virtual CPU devices, JAX on its 8 CPU devices; each JAX run
happens once per module."""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pano_tpu.config import (  # noqa: E402
    HarrisOptions, PanoConfig, RansacOptions,
)
from pano_tpu.ops import warp as JW  # noqa: E402
from pano_tpu.parallel import shard as JS  # noqa: E402
from pano_tpu_torch import config as TC  # noqa: E402
from pano_tpu_torch import pipeline as TP  # noqa: E402
from pano_tpu_torch.parallel import shard as TS  # noqa: E402

SMALL = PanoConfig(
    harris=HarrisOptions(max_keypoints=512),
    ransac=RansacOptions(num_iterations=512),
)
PORT = TC.config_from_reference(SMALL)
CPU = torch.device("cpu")


def cpu_mesh(n_data, n_hyp=1):
    return TS.make_mesh(n_data, n_hyp, devices=[CPU] * (n_data * n_hyp))


def checkerboard_texture(h, w, seed=0):
    """tests/test_sharding.py's texture."""
    r = np.random.default_rng(seed)
    img = np.full((h, w, 3), 30, np.uint8)
    for _ in range(60):
        y, x = r.integers(5, h - 12), r.integers(5, w - 12)
        img[y:y + 8, x:x + 8] = r.integers(60, 255, 3)
    return img


def scene(case):
    """tests/test_sharding.py's scenes."""
    if case == "chain4":
        base = checkerboard_texture(96, 320, seed=7)
        return [base[:, x:x + 128].copy() for x in (0, 64, 128, 192)]
    if case == "auto_shuffled":
        base = checkerboard_texture(96, 320, seed=11)
        return [base[:, x:x + 128].copy() for x in (128, 0, 192, 64)]
    if case == "auto3":
        base = checkerboard_texture(96, 256, seed=13)
        return [base[:, x:x + 128].copy() for x in (128, 0, 64)]
    if case == "skip":
        base = checkerboard_texture(96, 224, seed=15)
        return [base[:, 0:128].copy(), np.zeros((96, 128, 3), np.uint8),
                base[:, 96:224].copy()]
    base = checkerboard_texture(96, 224, seed=5 if case == "fold2" else 9)
    return [base[:, :128].copy(), base[:, 96:224].copy()]


# case -> (scene, mode, JAX mesh (n_data, n_hyp), port mesh)
CASES = {
    "chain": ("chain4", "chain", (8, 1), (8, 1)),
    "chain_data3": ("chain4", "chain", (8, 1), (3, 1)),
    "auto_shuffled": ("auto_shuffled", "auto", (2, 1), (2, 1)),
    "auto3": ("auto3", "auto", (1, 1), (1, 1)),
    "chain_skip": ("skip", "chain", (2, 1), (2, 1)),
    "dispatch_chain": ("dispatch", "chain", None, (1, 1)),
    "fold2": ("fold2", "fold", None, (1, 8)),
}


@contextlib.contextmanager
def recorded(mod):
    """The (globals, anchor) each composite_global_sharded call of `mod`
    receives."""
    seen = []
    real = mod.composite_global_sharded

    def spy(images, devs, globals_h, config, mesh=None, anchor=0, **kw):
        seen.append(([None if g is None else np.array(g, np.float64)
                      for g in globals_h], anchor))
        return real(images, devs, globals_h, config, mesh=mesh,
                    anchor=anchor, **kw)

    mod.composite_global_sharded = spy
    try:
        yield seen
    finally:
        mod.composite_global_sharded = real


def _run(mod, imgs, mode, mesh, cfg):
    out, err = io.StringIO(), io.StringIO()
    with recorded(mod) as seen, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        pano = mod.stitch_all_images_sharded(imgs, cfg, timing_tag="Sharded",
                                             mesh=mesh, mode=mode)
    return pano, seen, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def runs():
    """case -> (JAX (panorama, globals, stdout, stderr), port (...))."""
    memo = {}

    def get(case):
        if case not in memo:
            sc, mode, jm, tm = CASES[case]
            imgs = scene(sc)
            jmesh = None if jm is None else JS.make_mesh(*jm)
            memo[case] = (_run(JS, imgs, mode, jmesh, SMALL),
                          _run(TS, imgs, mode, cpu_mesh(*tm), PORT))
        return memo[case]

    return get


def _pano_bar(got, want):
    """tests/test_torch_multi.py's bar: the canvas within a row and
    column, and (d > 3) on < 1 % of the shared pixels."""
    assert got is not None and want is not None
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert all(abs(a - b) <= 1 for a, b in zip(got.shape, want.shape)), \
        (got.shape, want.shape)
    h, w = min(got.shape[0], want.shape[0]), min(got.shape[1], want.shape[1])
    d = np.abs(got[:h, :w].astype(int) - want[:h, :w].astype(int)).max(-1)
    assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


TIME = re.compile(r"\d+\.\d{3} ms$", re.M)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_mode_matches_jax(runs, case):
    """The same printed lines (times blanked) and stderr, the same
    placements and the panorama within the bar."""
    (pj, gj, oj, ej), (pt, gt, ot, et) = runs(case)
    _pano_bar(pt, pj)
    assert TIME.sub("X ms", ot) == TIME.sub("X ms", oj)
    assert et == ej
    assert len(gt) == len(gj)
    for (gs_t, a_t), (gs_j, a_j) in zip(gt, gj):
        assert a_t == a_j
        for g_t, g_j in zip(gs_t, gs_j):
            assert (g_t is None) == (g_j is None)
            if g_t is not None:
                err = np.abs(JW.warp_corners(g_t, 96, 128)
                             - JW.warp_corners(g_j, 96, 128)).max()
                assert err < 0.1, err


def test_sharded_modes_shape_and_content(runs):
    """tests/test_sharding.py's own checks on the port's panoramas."""
    assert runs("chain")[1][0].shape[1] >= 310
    assert runs("chain")[1][0].shape[0] >= 90
    pano = runs("auto_shuffled")[1][0]
    assert pano.shape[1] >= 310
    base = checkerboard_texture(96, 320, seed=11)
    d = np.abs(pano[:90, :310].astype(int)
               - base[:90, :310].astype(int)).max(-1)
    assert (d > 30).mean() < 0.08, (d > 30).mean()
    assert runs("chain_skip")[1][0].shape[1] >= 210
    assert runs("chain_skip")[1][3] == (
        "Not enough matched corners for stitching!\n"
        "Failed to stitch image 1!\n")
    assert runs("dispatch_chain")[1][0].shape[1] >= 220
    assert runs("fold2")[1][0].shape[1] >= 220


@pytest.mark.parametrize("case,kw", [
    ("chain", dict(mode="chain")), ("chain_data3", dict(mode="chain")),
    ("chain_skip", dict(mode="chain")),
    ("auto_shuffled", dict(mode="auto")), ("auto3", dict(mode="auto")),
])
def test_sharded_mode_equals_one_device_mode(runs, case, kw):
    """Chain and auto give pipeline.stitch_all_images' panorama byte for
    byte on any mesh."""
    imgs = scene(CASES[case][0])
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        want = TP.stitch_all_images(imgs, PORT, device="cpu", **kw)
    np.testing.assert_array_equal(runs(case)[1][0], want)


def test_fold_on_one_device_is_the_tagged_staged_fold(runs, capsys):
    """On a mesh of one device the sharded fold is pipeline's staged fold
    under the tag: the same lines, the same panorama."""
    imgs = scene("fold2")
    got = TS.stitch_all_images_sharded(imgs, PORT, mesh=cpu_mesh(1))
    out_s = TIME.sub("X ms", capsys.readouterr().out)
    want = TP.stitch_all_images(imgs, PORT, timing_tag="Sharded",
                                device="cpu")
    assert TIME.sub("X ms", capsys.readouterr().out) == out_s
    np.testing.assert_array_equal(got, want)
    assert out_s.splitlines() == [
        "Stitching image 2 of 2...",
        "Harris Corner Detection (Sharded): X ms",
        "Harris Corner Detection (Sharded): X ms",
        "Harris Corner Matching (Sharded): X ms",
        "RANSAC Homography Estimation (Sharded): X ms",
        "Image Stitching (Sharded): X ms",
        "Total Stitching Process (Sharded): X ms"]
    # Eight hyp shards print the same lines (JAX's fold on its 8 devices).
    assert TIME.sub("X ms", runs("fold2")[1][2]) == out_s


@pytest.mark.parametrize("mode,rows", [("chain", (3, 14)), ("auto", (6, 11)),
                                       ("fold", None)])
def test_one_host_fetch_for_all_estimates(monkeypatch, mode, rows):
    """tests/test_sharding.py:330-351: one _host_fetch of every estimate
    row (none in the hyp-sharded fold); the panorama is the one
    fetch_image."""
    seen = {"_host_fetch": [], "fetch_image": []}
    for name, shapes in seen.items():
        real = getattr(TP, name)
        monkeypatch.setattr(TP, name, lambda t, real=real, shapes=shapes: (
            shapes.append(tuple(t.shape)), real(t))[1])
    if mode == "fold":
        pano = TS.stitch_all_images_sharded(scene("fold2"), PORT,
                                            mesh=cpu_mesh(1, 2))
    else:
        fn = (TS.stitch_all_images_chain_sharded if mode == "chain"
              else TS.stitch_all_images_auto_sharded)
        pano = fn(scene("chain4"), PORT, mesh=cpu_mesh(2), print_timing=False)
    assert seen["_host_fetch"] == ([rows] if rows else [])
    assert seen["fetch_image"] == [pano.shape]


def test_fallbacks_and_unknown_mode(capsys):
    """Different shapes (and fewer than three images in auto) take the
    one-device modes; an unknown mode raises."""
    imgs = scene("chain4")
    mixed = imgs[:2] + [imgs[2][:90, :120].copy()]
    got = TS.stitch_all_images_chain_sharded(mixed, PORT, mesh=cpu_mesh(2),
                                             print_timing=False)
    want = TP.stitch_all_images(mixed, PORT, print_timing=False,
                                device="cpu", mode="chain")
    np.testing.assert_array_equal(got, want)
    got = TS.stitch_all_images_auto_sharded(imgs[:2], PORT,
                                            mesh=cpu_mesh(2))
    want = TP.stitch_all_images(imgs[:2], PORT, device="cpu", mode="auto")
    np.testing.assert_array_equal(got, want)
    assert TS.stitch_all_images_chain_sharded([], PORT) is None
    with pytest.raises(ValueError, match="unknown mode"):
        TS.stitch_all_images_sharded(imgs, PORT, mesh=cpu_mesh(1), mode="x")
    cfg = PORT.replace(stitch=dataclasses.replace(PORT.stitch,
                                                  blend="feather"))
    flat = [np.zeros((96, 128, 3), np.uint8)] * 3
    assert TS.stitch_all_images_auto_sharded(flat, cfg,
                                             mesh=cpu_mesh(2)) is None
    assert "No connected image pairs!" in capsys.readouterr().err
