"""bench_torch.py on the CPU: bench.py's JSON keys, the baseline rule,
and the refusal to run without a card unless the CPU is asked for.

bench.py's keys are read from its source (the dict it prints and the key
it adds), so the two scripts cannot drift apart unseen.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402

from pano_tpu_torch import DEFAULT_CONFIG, PairStitcher  # noqa: E402
from pano_tpu_torch import io as tio  # noqa: E402


def _bench_py_keys():
    """The keys bench.py prints: its `out` dict literal's and every
    `out[...] = ` it adds."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            keys |= {k.value for k in node.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name) and node.value.id == "out"):
            keys.add(node.slice.value)
    return keys


def _pair(h=96, w=128, dx=40, dy=3, seed=0):
    r = np.random.default_rng(seed)
    base = r.integers(0, 60, (h + dy, w + dx, 3)).astype(np.uint8)
    for _ in range(200):
        y, x = r.integers(2, h + dy - 10), r.integers(2, w + dx - 10)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    return (np.ascontiguousarray(base[:h, :w]),
            np.ascontiguousarray(base[dy:, dx:]))


@pytest.fixture(scope="module")
def cpu_run():
    """One measure() on the CPU without PANO_BENCH_BASELINE_MS: (result,
    the block's last panorama)."""
    left, right = _pair()
    saved = os.environ.pop("PANO_BENCH_BASELINE_MS", None)
    try:
        return bench_torch._measure(left, right, 2, "cpu")
    finally:
        if saved is not None:
            os.environ["PANO_BENCH_BASELINE_MS"] = saved


def test_keys_are_bench_py_keys(cpu_run):
    """A CPU run has every key of bench.py's but device_compute_ms (no
    device time on the CPU); the card's run has them all
    (tests/test_torch_cuda.py)."""
    out, _ = cpu_run
    keys = _bench_py_keys()
    assert keys == {"metric", "value", "unit", "vs_baseline",
                    "device_compute_ms"}
    assert set(out) == keys - {"device_compute_ms"}
    assert out["metric"] == "mountain_4k_stitch_ms" and out["unit"] == "ms"
    assert out["value"] > 0
    json.dumps(out)


def test_vs_baseline_is_null_without_the_variable(cpu_run, monkeypatch):
    out, _ = cpu_run
    assert out["vs_baseline"] is None
    left, right = _pair()
    monkeypatch.setenv("PANO_BENCH_BASELINE_MS", "10000")
    got = bench_torch.measure(left, right, 1, "cpu")
    assert got["vs_baseline"] == round(10000 / got["value"], 2)


def test_the_block_stitches_the_library_panorama(cpu_run):
    left, right = _pair()
    want = PairStitcher(DEFAULT_CONFIG, print_timing=False,
                        device="cpu").stitch_pair_fast(left, right)
    assert torch.equal(cpu_run[1], want)


def test_no_card_without_a_cpu_request_exits_1_before_any_stitch(
        monkeypatch, capsys):
    assert not torch.cuda.is_available()
    monkeypatch.delenv("PANO_TPU_FORCE_CPU", raising=False)

    def no_measure(*a, **k):
        raise AssertionError("bench_torch stitched without a CUDA device")

    monkeypatch.setattr(bench_torch, "measure", no_measure)
    assert bench_torch.main([]) == 1
    err = json.loads(capsys.readouterr().out.strip())
    assert set(err) == {"error"} and "no CUDA device" in err["error"]
    env = {k: v for k, v in os.environ.items() if k != "PANO_TPU_FORCE_CPU"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 1
    assert "no CUDA device" in json.loads(r.stdout.strip())["error"]


def test_cpu_request_runs_on_files(tmp_path, monkeypatch, capsys):
    """--cpu, and PANO_TPU_FORCE_CPU, run the script on two image files;
    a missing file is an error line and exit 1."""
    left, right = _pair()
    paths = [str(tmp_path / "l.ppm"), str(tmp_path / "r.ppm")]
    tio.write_ppm(paths[0], left)
    tio.write_ppm(paths[1], right)
    monkeypatch.setenv("PANO_BENCH_REPEATS", "1")
    monkeypatch.delenv("PANO_BENCH_BASELINE_MS", raising=False)
    assert bench_torch.main(["--cpu", *paths]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert set(out) == _bench_py_keys() - {"device_compute_ms"}
    monkeypatch.setenv("PANO_TPU_FORCE_CPU", "1")
    assert bench_torch.main([paths[0], str(tmp_path / "none.ppm")]) == 1
    assert "missing bench images" in capsys.readouterr().out
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit):
        bench_torch.main([paths[0]])
