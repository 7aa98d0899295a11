"""The port's benchmark scripts on the CPU: benchmark_throughput_torch.py
(and the dispatch / retire split of PairStitcher.stitch_pair_fast it
drives), benchmark_panorama_torch.py (the resolution sweep through the
CLI and the device-count sweep over parallel.shard) and
benchmark_serial_parallel_torch.py.

Each runs here on small images with --cpu; the device sweep's fetch
counts are held to the JAX script's worker on the same dataset, and the
JSON and CSV keys to the JAX scripts' sources.
"""

import ast
import contextlib
import csv
import io
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import benchmark_panorama_torch as bp  # noqa: E402
import benchmark_serial_parallel_torch as bsp  # noqa: E402
import benchmark_throughput_torch as bt  # noqa: E402

from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher  # noqa: E402
from pano_tpu_torch import cli as tcli  # noqa: E402
from pano_tpu_torch import pipeline as TP  # noqa: E402
from pano_tpu_torch.config import (  # noqa: E402
    HarrisOptions, PanoConfig, RansacOptions,
)

SMALL = PanoConfig(harris=HarrisOptions(max_keypoints=512),
                   ransac=RansacOptions(num_iterations=256))


def _pair(h=96, w=128, dx=40, dy=3, seed=0):
    r = np.random.default_rng(seed)
    base = r.integers(0, 60, (h + dy, w + dx, 3)).astype(np.uint8)
    for _ in range(200):
        y, x = r.integers(2, h + dy - 10), r.integers(2, w + dx - 10)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    return (np.ascontiguousarray(base[:h, :w]),
            np.ascontiguousarray(base[dy:, dx:]))


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    """The pair as two PNG files (the JAX device sweep reads .jpg and
    .png only)."""
    d = tmp_path_factory.mktemp("bench_pair")
    left, right = _pair()
    cv2.imwrite(str(d / "a1.png"), left)
    cv2.imwrite(str(d / "a2.png"), right)
    return str(d)


def _printed_dict_keys(script):
    """The keys of the dict literal with a "metric" key in `script`."""
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError(f"no metric dict in {script}")


# --- PairStitcher.dispatch / retire -----------------------------------------


@pytest.mark.parametrize("gate", ["ok", "below_gate"])
def test_stitch_pair_fast_is_the_parent_single_sync_path(gate):
    """stitch_pair_fast is retire(dispatch(...)), and its panorama is the
    one the single-sync path gave before the split: the row fetched with
    .cpu(), then the exact canvas, or below the inlier gate the fallback
    ladder and the staged composite."""
    cfg = SMALL if gate == "ok" else SMALL.replace(
        ransac=RansacOptions(num_iterations=256, min_inliers=10 ** 6))
    left, right = _pair()
    st = PairStitcher(cfg, print_timing=False, device="cpu")
    got = st.stitch_pair_fast(left, right)
    row_got = st.last_estimate.copy()

    ld, rd = st._to_device(left), st._to_device(right)
    row_dev, pts = st._fused_estimate_impl(ld, rd)
    row = row_dev.cpu().numpy()
    np.testing.assert_array_equal(row_got, row)
    if row[11] > 0.5:
        geo = TP.fused_canvas_geometry(row, ld.shape[:2], rd.shape[:2])
        canvas = st._compose(ld, rd, geo.m_inv, geo.ty, geo.tx, geo.window,
                             geo.canvas_h, geo.canvas_w)
        _, want = TP.fast_path_crop(geo.row, canvas)
    else:
        h = st.interpret_fused_row(
            row, lambda: tuple(a.cpu().numpy() for a in pts))
        want = st.composite(ld, rd, h)
    assert (gate == "ok") == (row[11] > 0.5)
    assert torch.equal(got, want)
    pending = st.dispatch(left, right)
    assert pending.event is None and pending.row.device.type == "cpu"
    assert torch.equal(st.retire(pending), want)


# --- benchmark_throughput_torch.py ------------------------------------------


# Three pairs of different shifts, so of different canvases.
SHIFTS = ((40, 3, 0), (28, 9, 1), (52, 0, 2))


def test_pairs_in_flight_are_retired_as_their_own():
    """Three different pairs dispatched before any is retired: each
    retire gives its own pair's stitch_pair_fast panorama and estimate
    row, in order."""
    pairs = [_pair(dx=dx, dy=dy, seed=seed) for dx, dy, seed in SHIFTS]
    st = PairStitcher(SMALL, print_timing=False, device="cpu")
    want = []
    for left, right in pairs:
        want.append((st.stitch_pair_fast(left, right),
                     st.last_estimate.copy()))
    assert len({tuple(p.shape) for p, _ in want}) == 3
    pending = [st.dispatch(left, right) for left, right in pairs]
    for p, (pano, row) in zip(pending, want):
        assert torch.equal(st.retire(p), pano)
        np.testing.assert_array_equal(st.last_estimate, row)
        assert row[11] > 0.5


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_throughput_retires_the_library_panorama(depth):
    """The throughput JSON at each depth, and its loop (`pipelined`) on
    the three pairs and the first once more: each retired panorama and
    row is its own pair's stitch_pair_fast's."""
    pairs = [_pair(dx=dx, dy=dy, seed=seed) for dx, dy, seed in SHIFTS]
    st = PairStitcher(SMALL, print_timing=False, device="cpu")
    want = []
    for left, right in pairs:
        want.append((st.stitch_pair_fast(left, right),
                     st.last_estimate.copy()))
    left, right = (st._to_device(im) for im in pairs[0])
    out = bt.throughput(st, left, right, pairs=4, depth=depth)
    assert set(out) == _printed_dict_keys("benchmark_throughput.py")
    assert out["metric"] == "mountain_4k_throughput_pairs_per_s"
    assert out["depth"] == depth and out["fallback_pairs"] == 0
    assert out["value"] > 0 and out["ms_per_pair"] > 0
    got = list(bt.pipelined(st, pairs + pairs[:1], depth))
    assert len(got) == 4
    for (pano, row), (want_pano, want_row) in zip(got, want + want[:1]):
        assert torch.equal(pano, want_pano)
        np.testing.assert_array_equal(row, want_row)


def test_throughput_refuses_a_pair_below_the_gate():
    cfg = SMALL.replace(ransac=RansacOptions(num_iterations=256,
                                             min_inliers=10 ** 6))
    left, right = _pair()
    st = PairStitcher(cfg, print_timing=False, device="cpu")
    with pytest.raises(RuntimeError, match="fallback ladder"):
        bt.throughput(st, st._to_device(left), st._to_device(right), 2, 2)


def test_throughput_main(pair_dir, monkeypatch, capsys):
    """No card and no CPU request: an error line and exit 1 before any
    stitch; --cpu runs the loop on the files."""
    assert not torch.cuda.is_available()
    monkeypatch.delenv("PANO_TPU_FORCE_CPU", raising=False)

    def no_loop(*a, **k):
        raise AssertionError("stitched without a CUDA device")

    real = bt.throughput
    monkeypatch.setattr(bt, "throughput", no_loop)
    paths = [os.path.join(pair_dir, f) for f in ("a1.png", "a2.png")]
    assert bt.main(paths) == 1
    assert "no CUDA device" in json.loads(capsys.readouterr().out)["error"]
    monkeypatch.setattr(bt, "throughput", real)
    assert bt.main(["--cpu", "--pairs", "2", "--depth", "2", *paths]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == _printed_dict_keys("benchmark_throughput.py")
    assert out["depth"] == 2 and out["fallback_pairs"] == 0


# --- benchmark_panorama_torch.py --------------------------------------------


def test_stitch_regex_reads_the_port_cli_stdout(pair_dir, monkeypatch):
    """STITCH_RE takes the last Total Stitching Process line of the
    port's real output: unsuffixed (serial; gpu on the CPU), "(Sharded)"
    and "(GPU)" (the tag the CLI gives the pipeline on the card)."""
    outs = []
    for impl, force in (("serial", False), ("gpu", True), ("sharded", True)):
        if force:
            monkeypatch.setenv("PANO_TPU_FORCE_CPU", "1")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tcli.run(impl, ["--dir", pair_dir, "--out",
                                   os.path.join(pair_dir, "o.ppm"),
                                   "--warmup", "--kpts", "512",
                                   "--iters", "256"]) == 0
        outs.append(buf.getvalue())
    buf = io.StringIO()
    imgs = [cv2.imread(os.path.join(pair_dir, f)) for f in ("a1.png",
                                                             "a2.png")]
    with contextlib.redirect_stdout(buf):
        TP.stitch_all_images(imgs, SMALL, timing_tag="GPU", device="cpu",
                             timing="total")
    outs.append(buf.getvalue())
    for text, label in zip(outs, ("", "", " (Sharded)", " (GPU)")):
        lines = re.findall(rf"^Total Stitching Process{re.escape(label)}: "
                           r"(\d+\.\d{3}) ms$", text, re.M)
        assert lines, text
        assert bp.STITCH_RE.findall(text)[-1] == lines[-1]
        assert bsp.STITCH_RE.findall(text)[-1] == lines[-1]
    # The JAX CLI's accelerator label is not the port's.
    assert not bp.STITCH_RE.findall("Total Stitching Process (TPU): 1.0 ms")


def _sweep_args(pair_dir, n, **kw):
    return types.SimpleNamespace(
        _worker=n, dataset=pair_dir, batch=2, kpts=256, device_scale=1.0,
        repeats=1, weak=False, real_mesh=False, cpu=True, **kw)


def test_device_sweep_cpu_workers(pair_dir, tmp_path, monkeypatch, capsys):
    """The sweep at n = 1 and 2 on CPU slots: one DEVICE_SWEEP line per
    worker, the CSV's columns and one fetch for the estimates' batch and
    one for the composite group of its identical pairs."""
    monkeypatch.setattr(TP, "_host_fetch", TP._host_fetch)  # restored
    bp._device_worker(_sweep_args(pair_dir, 2))
    m = bp.SWEEP_RE.search(capsys.readouterr().out)
    assert m and m.group(1) == "2" and m.group(2) == "2"
    assert (m.group(5), m.group(6)) == ("1", "2")

    csv_path, png = str(tmp_path / "d.csv"), str(tmp_path / "d.png")
    assert bp.main(["--dataset", pair_dir, "--devices", "1,2", "--cpu",
                    "--batch", "3", "--kpts", "256", "--device-scale", "1.0",
                    "--repeats", "1", "--csv", csv_path,
                    "--plot", png]) == 0
    rows = list(csv.DictReader(open(csv_path)))
    assert list(rows[0]) == ["devices", "batch", "est_ms", "full_ms",
                             "pairs_per_s", "est_fetches", "full_fetches"]
    assert [(r["devices"], r["batch"], r["est_fetches"], r["full_fetches"])
            for r in rows] == [("1", "3", "1", "2"), ("2", "4", "1", "2")]
    assert all(float(r["full_ms"]) > 0 for r in rows)
    assert "devices=2 batch=4" in capsys.readouterr().out


def test_fetch_counts_equal_the_jax_worker(pair_dir, monkeypatch, capsys):
    """The JAX script's worker on the same dataset and batch (its 8
    virtual CPU devices) pays the same host fetches."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PANO_TPU_FORCE_CPU", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark_panorama.py"),
         "--_worker", "2", "--dataset", pair_dir, "--batch", "2",
         "--kpts", "256", "--device-scale", "1.0", "--repeats", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    want = bp.SWEEP_RE.search(r.stdout)
    assert want, r.stdout + r.stderr[-2000:]
    monkeypatch.setattr(TP, "_host_fetch", TP._host_fetch)  # restored
    bp._device_worker(_sweep_args(pair_dir, 2))
    got = bp.SWEEP_RE.search(capsys.readouterr().out)
    assert [got.group(i) for i in (1, 2, 5, 6)] == \
        [want.group(i) for i in (1, 2, 5, 6)] == ["2", "2", "1", "2"]


def test_resolution_sweep_cpu(pair_dir, tmp_path, capsys):
    csv_path, png = str(tmp_path / "r.csv"), str(tmp_path / "r.png")
    assert bp.main(["--dataset", pair_dir, "--scales", "0.5,1.0",
                    "--repeats", "1", "--cpu", "--csv", csv_path,
                    "--plot", png]) == 0
    rows = list(csv.DictReader(open(csv_path)))
    assert [(r["scale"], r["area"]) for r in rows] == [("0.5", "0.25"),
                                                       ("1.0", "1.0")]
    assert all(float(r["ms"]) > 0 for r in rows)
    assert "scale=1.000 area=1.000 best=" in capsys.readouterr().out


def test_sweeps_refuse_without_a_card(pair_dir, tmp_path, monkeypatch,
                                      capsys):
    """No card and no CPU request: exit 1 and an error before any child
    runs; `--impl serial` is the CPU by name and goes on."""
    assert not torch.cuda.is_available()
    monkeypatch.delenv("PANO_TPU_FORCE_CPU", raising=False)

    def no_child(*a, **k):
        raise AssertionError("a child ran without a CUDA device")

    monkeypatch.setattr(bp, "run_once", no_child)
    monkeypatch.setattr(bp.subprocess, "run", no_child)
    monkeypatch.setattr(bsp, "run_impl", no_child)
    out = str(tmp_path / "x.csv")
    assert bp.main(["--dataset", pair_dir, "--csv", out]) == 1
    assert bp.main(["--dataset", pair_dir, "--devices", "1", "--csv",
                    out]) == 1
    assert bp.main(["--dataset", pair_dir, "--devices", "1", "--impl",
                    "serial", "--csv", out]) == 1
    assert bsp.main(["--datasets", pair_dir, "--csv", out]) == 1
    assert capsys.readouterr().err.count("no CUDA device") == 4
    assert not os.path.exists(out)
    monkeypatch.setattr(bp, "run_once", lambda *a, **k: 5.0)
    assert bp.main(["--dataset", pair_dir, "--impl", "serial", "--scales",
                    "1.0", "--repeats", "1", "--csv", out, "--plot",
                    str(tmp_path / "x.png")]) == 0
    assert list(csv.DictReader(open(out))) == [
        {"scale": "1.0", "area": "1.0", "ms": "5.0"}]


# --- benchmark_serial_parallel_torch.py -------------------------------------


def test_serial_parallel_cpu(pair_dir, tmp_path, monkeypatch, capsys):
    """Serial against gpu (on the CPU, asked for): the JAX script's CSV
    with tpu_s as gpu_s, appended, the header once."""
    csv_path, png = str(tmp_path / "s.csv"), str(tmp_path / "s.png")
    args = ["--datasets", pair_dir, "--repeats", "1", "--cpu",
            "--csv", csv_path, "--plot", png]
    assert bsp.main(args) == 0
    name = os.path.basename(pair_dir)
    assert re.search(rf"^{name}: serial=[\d.]+s gpu=[\d.]+s speedup=",
                     capsys.readouterr().out, re.M)
    monkeypatch.setattr(bsp, "run_impl",
                        lambda impl, a, cpu=False: 2.0 if impl == "serial"
                        else 0.5)
    assert bsp.main(args) == 0
    rows = list(csv.DictReader(open(csv_path)))
    assert list(rows[0]) == ["dataset", "serial_s", "gpu_s", "speedup"]
    assert len(rows) == 2 and rows[0]["dataset"] == name
    assert float(rows[0]["serial_s"]) > 0 and float(rows[0]["gpu_s"]) > 0
    assert rows[1] == {"dataset": name, "serial_s": "2.0", "gpu_s": "0.5",
                       "speedup": "4.0"}
    jax_src = open(os.path.join(REPO, "benchmark_serial_parallel.py")).read()
    assert '["dataset", "serial_s", "tpu_s", "speedup"]' in jax_src
