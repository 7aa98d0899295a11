"""graft_entry_torch.py on the CPU: the forward step and the mesh dry run
against a direct library call and against __graft_entry__.py (the JAX
package's, on its 8 virtual CPU devices)."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as jge  # noqa: E402
import graft_entry_torch as tge  # noqa: E402

from pano_tpu_torch.parallel import shard as TS  # noqa: E402


def _corner_err(h_a, h_b, h=64, w=96) -> float:
    """Max distance (px) between two homographies' images of the
    (h, w) right image's corners."""
    c = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64)
    pa, pb = c @ np.asarray(h_a, np.float64).T, c @ np.asarray(h_b).T
    return float(np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max())


@pytest.fixture(scope="module")
def port_dryrun():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hs, counts = tge.dryrun_multichip(8, device="cpu")
    return hs, counts, buf.getvalue()


def test_dryrun_is_the_direct_library_call(port_dryrun):
    """tests/test_sharding.py's drift check for the port: the dry run is
    batched_stitch_step then composite_pairs_batched, byte for byte."""
    hs, counts, out = port_dryrun
    mesh, cfg, lefts, rights = tge._dryrun_setup(8, "cpu")
    assert mesh.shape == {"data": 4, "hyp": 2}
    assert cfg.ransac.num_iterations == 128
    hs_d, counts_d = TS.batched_stitch_step(mesh, lefts, rights, cfg)
    np.testing.assert_array_equal(hs, hs_d.numpy().astype(np.float64))
    np.testing.assert_array_equal(counts, counts_d.numpy())
    panos = TS.composite_pairs_batched(lefts, rights, hs, np.ones(4, bool),
                                       cfg, mesh)
    shapes = [p.shape[:2] for p in panos]
    assert out.strip() == (
        f"dryrun_multichip OK: mesh=(4x2) devices=8, "
        f"inliers={counts.tolist()}, "
        f"gate>=min_inliers={(counts >= cfg.ransac.min_inliers).tolist()}, "
        f"composited={shapes}")


def test_dryrun_matches_jax(port_dryrun):
    """JAX's dry run on its 8 virtual devices: the same inlier counts and
    each H within 0.5 px at the right image's corners."""
    hs, counts, _ = port_dryrun
    with contextlib.redirect_stdout(io.StringIO()):
        hs_j, counts_j = jge.dryrun_multichip(8)
    np.testing.assert_array_equal(counts, np.asarray(counts_j))
    for a, b in zip(hs, hs_j):
        assert _corner_err(a, b) < 0.5


@pytest.mark.parametrize("n", [1, 2, 3])
def test_dryrun_mesh_split(n):
    mesh, cfg, lefts, _ = tge._dryrun_setup(n, "cpu")
    n_hyp = 2 if n == 2 else 1
    assert mesh.shape == {"data": n // n_hyp, "hyp": n_hyp}
    assert lefts.shape == (n // n_hyp, 64, 96, 3)
    assert cfg.ransac.num_iterations == 64 * n_hyp


def test_entry_forward_matches_jax():
    """The forward step on the example pair: JAX's inlier count, H within
    0.5 px at the corners, and the 128x256 overlay canvas."""
    import jax

    fn, args = tge.entry("cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.uint8
               for a in args)
    h, count, canvas = fn(*args)
    fn_j, args_j = jge.entry()
    h_j, count_j, canvas_j = jax.jit(fn_j)(*args_j)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(args_j[0]))
    assert int(count) == int(count_j) > 0
    assert _corner_err(h.numpy(), np.asarray(h_j), 128, 160) < 0.5
    assert canvas.shape == canvas_j.shape == (128, 256, 3)
    d = np.abs(canvas.numpy().astype(int) - np.asarray(canvas_j, int))
    assert (d.max(-1) > 1).mean() < 0.01


def test_no_card_without_a_cpu_request(monkeypatch, capsys):
    assert not torch.cuda.is_available()
    monkeypatch.delenv("PANO_TPU_FORCE_CPU", raising=False)

    def no_stitch(*a, **k):
        raise AssertionError("stitched without a CUDA device")

    monkeypatch.setattr(TS, "batched_stitch_step", no_stitch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tge.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tge.dryrun_multichip(2)
    assert tge.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("PANO_TPU_FORCE_CPU", "1")
    assert tge.main(["2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "entry OK: [(3, 3), (), (128, 256, 3)]"
    assert out[1].startswith("dryrun_multichip OK: mesh=(1x2) devices=2")
