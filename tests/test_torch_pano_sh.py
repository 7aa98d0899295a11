"""pano_torch.sh on the CPU: pano.sh's subcommands pointed at the port.
The usage text and exit codes, `build --no-gpu`, `run serial`, `run gpu`
with --no-gpu and without a card, `serve`, `perf` (the Chrome trace and
its summary in the report) and `eval`."""

import os
import subprocess

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "pano_torch.sh")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("sh_pair")
    r = np.random.default_rng(0)
    base = np.full((96, 192, 3), 30, np.uint8)
    for _ in range(120):
        y, x = r.integers(4, 88), r.integers(4, 184)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    paths = [str(d / "a1.png"), str(d / "a2.png")]
    cv2.imwrite(paths[0], base[:, :128])
    cv2.imwrite(paths[1], base[:, 64:])
    return paths


def _sh(*args, cwd=None, stdin=None, **env):
    full = {k: v for k, v in os.environ.items()
            if k not in ("PANO_TPU_FORCE_CPU", "PANO_TPU_PROFILE")}
    full.update(env)
    return subprocess.run(["bash", SCRIPT, *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd or REPO, env=full,
                          input=stdin)


def test_usage_and_exit_codes():
    for args in ((), ("help",), ("nope",), ("run",), ("perf",),
                 ("serve",), ("eval", "x")):
        r = _sh(*args)
        assert r.returncode == 1, (args, r.stdout, r.stderr)
        text = r.stdout
        if args[:1] in (("nope",),):
            assert text.startswith("Unknown command: nope")
        if args[:1] in (("run",), ("perf",), ("serve",)):
            assert text.startswith("Error: Missing implementation")
        if args != ("eval", "x"):
            assert "Usage:" in text and f"{SCRIPT} build [--no-gpu]" in text
            assert "implementation: serial, openmp (sharded), gpu/tpu, " \
                   "opencv" in text
    assert "Usage: " in _sh("eval", "x").stdout


def test_build_no_gpu_checks_the_cpu_import():
    r = _sh("build", "--no-gpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines()[0] == "=== Building pano_tpu_torch ==="
    assert "CUDA available: False" in r.stdout
    assert r.stdout.splitlines()[-1] == \
        "=== Build check completed successfully ==="


def test_run_serial_and_no_gpu(pair, tmp_path):
    out = str(tmp_path / "s.ppm")
    r = _sh("run", "serial", *pair, "--out", out)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "Running serial implementation..."
    assert lines[-1] == "Stitching completed successfully!"
    assert f"Stitched result saved to {out}" in lines and os.path.exists(out)
    out_g = str(tmp_path / "g.ppm")
    r = _sh("run", "gpu", "--no-gpu", *pair, "--out", out_g)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PyTorch backend: cpu" in r.stdout and os.path.exists(out_g)


def test_run_gpu_without_a_card_fails(pair, tmp_path):
    assert not torch.cuda.is_available()
    out = str(tmp_path / "none.ppm")
    r = _sh("run", "gpu", *pair, "--out", out)
    assert r.returncode == 255
    assert r.stdout.splitlines()[-1] == "Stitching failed with error code 255"
    assert "needs a CUDA device" in r.stderr and not os.path.exists(out)


def test_serve_serial(pair, tmp_path):
    out = str(tmp_path / "j.ppm")
    r = _sh("serve", "serial", stdin=f"{pair[0]} {pair[1]} --out {out}\n")
    assert r.returncode == 0, r.stdout + r.stderr
    assert any(line.startswith(f"Job 1 ok {out}: ")
               for line in r.stdout.splitlines())


def test_perf_writes_the_trace_and_its_summary(pair, tmp_path):
    trace = str(tmp_path / "trace")
    r = _sh("perf", "serial", *pair, "--out", str(tmp_path / "p.ppm"),
            cwd=str(tmp_path), PANO_TPU_TRACE_DIR=trace)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Per-kernel device summary appended to serial_perf_report.txt" \
        in r.stdout
    report = open(tmp_path / "serial_perf_report.txt").read()
    assert f"Profiling to {trace} (torch.profiler)" in report
    assert "(no device events in trace; summarizing host cpu_op events)" \
        in report
    assert report.rstrip().endswith(
        "device busy (union over streams, summed over devices): 0.000 ms")
    assert any(f.startswith("pano_trace_") for f in os.listdir(trace))


def test_eval(pair, tmp_path):
    r = _sh("eval", pair[0], pair[0])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Overall stitching quality: Good" in r.stdout
    assert r.stdout.splitlines()[-1] == "Evaluation completed successfully!"
    r = _sh("eval", str(tmp_path / "none.png"), pair[0])
    assert r.returncode == 1
    assert r.stdout.startswith("Error: Generated panorama file not found")
